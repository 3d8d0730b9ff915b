// gf2_elim.cu -- batched GF(2) Gauss-Jordan elimination in a per-sample
// column order, one thread block per sample (K4's block kernel).
//
// Replaces the TPU kernel bp_osd_tpu/ops/pallas_gf2.py:_elim_kernel (K4) on
// the codes whose warp layout does not fit a block's shared memory (the
// osd_e route of lifted products that K3 cannot hold); every smaller code,
// the flagship's default osd0 decode among them, runs K4's warp kernel
// (osd_cs.cu, gf2_elim_warp_launch).  This block kernel keeps its first
// design: step B below walks a word's hit rows one after another.
// The plain torch version is bp_osd_tpu_torch/decoder/osd.py:eliminate_plain;
// the two agree bit for bit in all five outputs, which are those of the JAX
// package's decoder/osd.py:_eliminate:
//   h_work     [B, m, W] the fully reduced H, row-packed in original column
//              order (uint32 bits in int32 words, W = ceil(n/32));
//   s_work     [B, m]    the reduced syndrome (int32 0/1);
//   pivot_ids  [B, r]    the original column of pivot i (in the order found);
//   pivot_rows [B, r]    the row holding pivot i;
//   pivot_mask [B, n]    1 at the sorted positions t that produced a pivot.
// Skipped samples get zeros in all five.
//
// Per sample, over t = 0, 1, ... in perm order until rank pivots are found:
//   A. every thread tests the column bit of its rows; one ballot per warp
//      stores the packed set of rows carrying column perm[t], and the first
//      unused one among them goes to an atomicMin on (row << 1 | its
//      syndrome bit) -- the pivot is the first unused row carrying the column;
//   B. each warp takes a word of that set and XORs the pivot row into the
//      rows it holds (the pivot row excluded), skipping the pivot row's zero
//      words; the packed syndrome takes the same row operation, one word per
//      thread.  The key slot is triple-buffered, so a dependent column costs
//      one barrier and a pivot column two.
// The JAX package exits when every sample of a batch holds r pivots; here a
// block exits at its own sample's r-th pivot.  Both leave the same outputs.
//
// What bounds it on an H100: the ~rank sequential steps and their barriers.
// At the [[400,16,6]] flagship the row-packed matrix is 192 x 13 words
// (9,984 bytes) and lives in shared memory, and a step touches a few rows.
// A matrix above a block's shared memory (from lift ~80 of the bench
// protograph) is eliminated in place in the sample's slice of h_work in
// device memory, which has to be written anyway; steps A and B then read and
// write it through L1/L2.  The TPU kernel ran 128-256 samples in lock step on
// vector lanes, extracting and updating every word of every row per step;
// here a block owns a sample and touches only the rows that carry the column.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
gf2_elim_kernel(const int32_t* __restrict__ h_packed, const int32_t* __restrict__ perm,
                const uint8_t* __restrict__ synd, const uint8_t* __restrict__ skip,
                uint32_t* h_work, int32_t* __restrict__ s_work,
                int32_t* __restrict__ pivot_ids, int32_t* __restrict__ pivot_rows,
                uint8_t* __restrict__ pivot_mask, int m, int n, int W, int Wm, int rank) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t* out = h_work + (size_t)b * m * W;
  const int32_t* pb = perm + (size_t)b * n;

  for (int i = tid; i < rank; i += kThreads) {
    pivot_ids[(size_t)b * rank + i] = 0;
    pivot_rows[(size_t)b * rank + i] = 0;
  }
  for (int t = tid; t < n; t += kThreads) pivot_mask[(size_t)b * n + t] = 0;
  if (skip && skip[b]) {
    for (size_t i = tid; i < (size_t)m * W; i += kThreads) out[i] = 0u;
    for (int i = tid; i < m; i += kThreads) s_work[(size_t)b * m + i] = 0;
    return;
  }

  extern __shared__ uint32_t smem[];
  uint32_t* s_col = smem;            // [Wm] rows carrying the current column
  uint32_t* s_used = s_col + Wm;     // [Wm] rows that hold a pivot
  uint32_t* s_syn = s_used + Wm;     // [Wm] the syndrome, packed
  int* s_key = reinterpret_cast<int*>(s_syn + Wm);  // [3] pivot key, by t % 3
  uint32_t* M = kGlobal ? out : s_syn + Wm + 3;     // [m * W] the matrix

  for (size_t i = tid; i < (size_t)m * W; i += kThreads) M[i] = (uint32_t)h_packed[i];
  for (int w = tid; w < Wm; w += kThreads) {
    uint32_t word = 0u;
    for (int bit = 0; bit < 32; ++bit) {
      const int row = w * 32 + bit;
      if (row < m) word |= (uint32_t)(synd[(size_t)b * m + row] & 1) << bit;
    }
    s_syn[w] = word;
    s_used[w] = 0u;
  }
  if (tid < 3) s_key[tid] = INT_MAX;
  __syncthreads();

  int rr = 0;
  for (int t = 0; t < n && rr < rank; ++t) {
    const int col = pb[t];
    const int cw = col >> 5, cb = col & 31;
    int* key_t = s_key + t % 3;
    if (tid == 0) s_key[(t + 1) % 3] = INT_MAX;
    // A. rows carrying the column; the first unused one
    for (int base = 0; base < m; base += kThreads) {
      const int i = base + tid;
      const bool bit = i < m && ((M[(size_t)i * W + cw] >> cb) & 1u);
      const uint32_t word = __ballot_sync(kFull, bit);
      const int wd = (base >> 5) + warp;
      if (lane == 0 && wd < Wm) {
        s_col[wd] = word;
        const uint32_t elig = word & ~s_used[wd];
        if (elig) {
          const int pr = wd * 32 + __ffs(elig) - 1;
          atomicMin(key_t, (pr << 1) | (int)((s_syn[wd] >> (pr & 31)) & 1u));
        }
      }
    }
    __syncthreads();
    const int key = *key_t;
    if (key == INT_MAX) continue;  // a dependent column: no pivot
    const int pr = key >> 1;
    const int pw = pr >> 5;
    const uint32_t pbit = 1u << (pr & 31);

    // B. add the pivot row to the other rows carrying the column
    for (int wd = tid; wd < Wm; wd += kThreads) {
      const uint32_t hit = s_col[wd] & (wd == pw ? ~pbit : kFull);
      if (key & 1) s_syn[wd] ^= hit;
      if (wd == pw) s_used[wd] |= pbit;
    }
    const uint32_t* prow = M + (size_t)pr * W;
    for (int wd = warp; wd < Wm; wd += kWarps) {
      uint32_t hit = s_col[wd] & (wd == pw ? ~pbit : kFull);
      while (hit) {
        uint32_t* row = M + (size_t)(wd * 32 + __ffs(hit) - 1) * W;
        hit &= hit - 1;
        for (int w = lane; w < W; w += 32) {
          const uint32_t p = prow[w];
          if (p) row[w] ^= p;
        }
      }
    }
    if (tid == 0) {
      pivot_ids[(size_t)b * rank + rr] = col;
      pivot_rows[(size_t)b * rank + rr] = pr;
      pivot_mask[(size_t)b * n + t] = 1;
    }
    ++rr;
    __syncthreads();
  }

  if constexpr (!kGlobal)
    for (int i = tid; i < m * W; i += kThreads) out[i] = M[i];
  for (int i = tid; i < m; i += kThreads)
    s_work[(size_t)b * m + i] = (int32_t)((s_syn[i >> 5] >> (i & 31)) & 1u);
}

}  // namespace

// Shared memory of one block; `in_global` leaves the matrix in h_work.
extern "C" size_t gf2_elim_smem_bytes(int m, int W, int in_global) {
  const size_t Wm = ((size_t)m + 31) / 32;
  return 4 * ((in_global ? 0 : (size_t)m * W) + 3 * Wm + 3);
}

// Launches B blocks on `stream`, the outputs given at the chunk's first
// sample.  Returns cudaGetLastError() of the launch.
extern "C" int gf2_elim_launch(const void* h_packed, const void* perm, const void* synd,
                               const void* skip, void* h_work, void* s_work, void* pivot_ids,
                               void* pivot_rows, void* pivot_mask, int B, int m, int n, int W,
                               int rank, int in_global, void* stream) {
  const int Wm = (m + 31) / 32;
  const size_t smem = gf2_elim_smem_bytes(m, W, in_global);
  auto kernel = in_global ? gf2_elim_kernel<true> : gf2_elim_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)h_packed, (const int32_t*)perm, (const uint8_t*)synd,
      (const uint8_t*)skip, (uint32_t*)h_work, (int32_t*)s_work, (int32_t*)pivot_ids,
      (int32_t*)pivot_rows, (uint8_t*)pivot_mask, m, n, W, Wm, rank);
  return (int)cudaGetLastError();
}
