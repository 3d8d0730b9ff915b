// osd_large.cu -- ordered-statistics decoding (osd0 / osd_cs) for codes whose
// matrix does not fit in a block's shared memory, one thread block per sample,
// the matrix in device memory.
//
// Replaces the TPU kernel bp_osd_tpu/ops/pallas_osd_large.py:_osd_large_kernel
// (K5) and its pre-pass _permuted_packed_h.  The plain torch version is
// bp_osd_tpu_torch/decoder/osd.py:osd_decode_plain, the same function as for
// K2 (osd_cs.cu); the two agree bit for bit.
//
// Per sample, with perm the stable ascending argsort of the BP posterior:
//   1. copy the column-permuted matrix into this block's slice of a global
//      scratch buffer, column-major and bit-packed along rows: column t is
//      H[:, perm[t]] as Wm = ceil(m/32) words, one row of the column-packed
//      H; the syndrome is column n.  (K2's layout; the TPU kernel's one-hot
//      matmul pre-pass has no counterpart.)
//   2. Gauss-Jordan over columns t = 0, 1, ...: warp 0 picks the pivot row,
//      the first unused row carrying column t, and compacts S, the nonzero
//      words of column t without the pivot bit.  A dependent column costs
//      only that read.  Otherwise the block lists the columns c in (t, n]
//      that carry the pivot row's bit and XORs S into each of them: "add the
//      pivot row to the other rows of column t", column by column.  Columns
//      before t never carry an unused row's bit, so they are left alone.
//   3. osd0 reads the reduced syndrome at the pivot rows;
//   4. the sweep scores the zero pattern, weight 1 on every non-pivot column
//      (T, in reliability order) and weight 2 on the lexicographic pairs of
//      the first lam T columns by popcount of the residual syndrome, one warp
//      per candidate; the key (weight << 32 | candidate rank) makes the
//      block-wide minimum the first minimum in candidate order;
//   5. osd0 and osdw are scattered to original coordinates through perm.
// Weights count every row, as in K2 and the plain version.
//
// What bounds it on an H100: the elimination.  One sample's matrix is
// (n + 1) * Wm * 4 bytes (6.0 MB at the [[10000,420]] code), far above a
// block's 227 KB of shared memory, so it lives in device memory and is
// served from L2 (50 MB: about 8 samples' matrices) or HBM.  Each of the
// ~rank pivot steps reads one word of every later column (scattered, one
// 32-byte sector each) and rewrites the nonzero words of S in every hit
// column: at most rank * n * Wm word operations (~7e9 at lift 400), fewer
// while the columns are sparse.  The steps are sequential; within a step the
// loads are independent, so they are issued in batches to keep many in
// flight.  Shared memory holds the small state: the pivot row of each column
// and the hit list (n int32 each), the used-row mask, S, the syndromes.  A
// skip sample writes zeros and returns.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 8;  // independent loads a thread issues before using them

__device__ __forceinline__ unsigned long long warp_min(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long y = __shfl_down_sync(kFull, x, off);
    x = y < x ? y : x;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
osd_large_kernel(const int32_t* __restrict__ h_cols, const int32_t* __restrict__ perm,
                 const uint8_t* __restrict__ synd, const uint8_t* __restrict__ skip,
                 const int32_t* __restrict__ pairs, uint32_t* scratch,
                 uint8_t* __restrict__ e0, uint8_t* __restrict__ ew, int row0, int m, int n,
                 int Wm, int rank, int lam, int n_pairs, int sweep) {
  const int b = row0 + blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;

  if (skip && skip[b]) {
    for (int v = tid; v < n; v += kThreads) {
      e0[(size_t)b * n + v] = 0;
      ew[(size_t)b * n + v] = 0;
    }
    return;
  }

  uint32_t* M = scratch + (size_t)blockIdx.x * (n + 1) * Wm;  // column t at M + t * Wm
  const int32_t* pb = perm + (size_t)b * n;

  extern __shared__ unsigned long long smem64[];
  unsigned long long* s_red = smem64;                              // [kWarps]
  int32_t* s_prow = reinterpret_cast<int32_t*>(s_red + kWarps);   // [n]
  int32_t* s_hits = s_prow + n;                                    // [n]
  uint32_t* s_used = reinterpret_cast<uint32_t*>(s_hits + n);     // [Wm]
  uint32_t* s_Sval = s_used + Wm;                                  // [Wm]
  int32_t* s_Sidx = reinterpret_cast<int32_t*>(s_Sval + Wm);      // [Wm]
  uint32_t* s_syn = reinterpret_cast<uint32_t*>(s_Sidx + Wm);     // [Wm]
  uint32_t* s_best = s_syn + Wm;                                   // [Wm]
  int32_t* s_tcol = reinterpret_cast<int32_t*>(s_best + Wm);      // [max(lam, 1)]
  int32_t* s_misc = s_tcol + (lam > 0 ? lam : 1);                  // [4]

  // ---- 1. column-permuted, row-packed matrix; syndrome as column n ----
  for (int t = warp; t < n; t += kWarps) {
    const int32_t* src = h_cols + (size_t)pb[t] * Wm;
    uint32_t* dst = M + (size_t)t * Wm;
    for (int w = lane; w < Wm; w += 32) dst[w] = (uint32_t)src[w];
  }
  for (int w = tid; w < Wm; w += kThreads) {
    uint32_t word = 0u;
    for (int bit = 0; bit < 32; ++bit) {
      const int row = w * 32 + bit;
      if (row < m) word |= (uint32_t)(synd[(size_t)b * m + row] & 1) << bit;
    }
    M[(size_t)n * Wm + w] = word;
    s_used[w] = 0u;
  }
  for (int t = tid; t < n; t += kThreads) s_prow[t] = -1;
  __syncthreads();

  // ---- 2. Gauss-Jordan in reliability order ----
  int rr = 0;
  for (int t = 0; t < n && rr < rank; ++t) {
    const uint32_t* col_t = M + (size_t)t * Wm;
    if (warp == 0) {
      int fw = INT_MAX;
      uint32_t fx = 0u;
      for (int w = lane; w < Wm; w += 32) {
        const uint32_t x = col_t[w] & ~s_used[w];
        if (x != 0u && fw == INT_MAX) {
          fw = w;
          fx = x;
        }
      }
      const int wmin = __reduce_min_sync(kFull, fw);
      int pr = -1;
      if (wmin != INT_MAX) {
        const unsigned src = __ballot_sync(kFull, fw == wmin);
        const uint32_t xs = __shfl_sync(kFull, fx, __ffs(src) - 1);
        pr = wmin * 32 + (__ffs(xs) - 1);
        int cnt = 0;
        for (int base = 0; base < Wm; base += 32) {
          const int w = base + lane;
          uint32_t x = w < Wm ? col_t[w] : 0u;
          if (w == (pr >> 5)) x &= ~(1u << (pr & 31));
          const unsigned nz = __ballot_sync(kFull, x != 0u);
          if (x != 0u) {
            const int pos = cnt + __popc(nz & lt_mask);
            s_Sidx[pos] = w;
            s_Sval[pos] = x;
          }
          cnt += __popc(nz);
        }
        if (lane == 0) {
          s_used[pr >> 5] |= 1u << (pr & 31);
          s_prow[t] = pr;
          s_misc[2] = cnt;
          s_misc[3] = 0;
        }
      }
      if (lane == 0) s_misc[t & 1] = pr;  // double-buffered: no barrier on dependent steps
    }
    __syncthreads();
    const int pr = s_misc[t & 1];
    if (pr < 0) continue;
    ++rr;

    // the columns after t (syndrome included) that carry the pivot row
    const int pw = pr >> 5;
    const uint32_t pbit = 1u << (pr & 31);
    for (int c0 = t + 1 + warp * 32; c0 <= n; c0 += 4 * kThreads) {
      bool hit[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + k * kThreads + lane;
        hit[k] = c <= n && (M[(size_t)c * Wm + pw] & pbit) != 0u;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned hm = __ballot_sync(kFull, hit[k]);
        if (hm == 0u) continue;
        int base = 0;
        if (lane == 0) base = atomicAdd(&s_misc[3], __popc(hm));
        base = __shfl_sync(kFull, base, 0);
        if (hit[k]) s_hits[base + __popc(hm & lt_mask)] = c0 + k * kThreads + lane;
      }
    }
    __syncthreads();

    // XOR S into every hit column; the (column, word) items are distinct
    const int nS = s_misc[2];
    const int work = s_misc[3] * nS;
    for (int i0 = tid; i0 < work; i0 += kBatch * kThreads) {
      uint32_t* p[kBatch];
      uint32_t v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        p[u] = nullptr;
        if (i < work) {
          const int h = i / nS;
          const int k = i - h * nS;
          p[u] = M + (size_t)s_hits[h] * Wm + s_Sidx[k];
          v[u] = *p[u] ^ s_Sval[k];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (p[u]) *p[u] = v[u];
    }
    __syncthreads();
  }

  // ---- T: the first lam non-pivot columns, in reliability order ----
  for (int w = tid; w < Wm; w += kThreads) s_syn[w] = M[(size_t)n * Wm + w];
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < n && cnt < lam; base += 32) {
      const int t = base + lane;
      const bool is_t = t < n && s_prow[t] < 0;
      const unsigned mask = __ballot_sync(kFull, is_t);
      const int pos = cnt + __popc(mask & lt_mask);
      if (is_t && pos < lam) s_tcol[pos] = t;
      cnt += __popc(mask);
    }
  }
  __syncthreads();

  // ---- 4. candidate sweep, one warp per candidate ----
  int bt1 = -1, bt2 = -1;
  if (sweep) {
    unsigned long long best = ~0ull;
    if (warp == 0) {
      int w0 = 0;
      for (int w = lane; w < Wm; w += 32) w0 += __popc(s_syn[w]);
      best = (unsigned long long)__reduce_add_sync(kFull, w0) << 32;
    }
    for (int t = warp; t < n; t += kWarps) {
      if (s_prow[t] >= 0) continue;
      const uint32_t* col = M + (size_t)t * Wm;
      int wt = 0;
      for (int w = lane; w < Wm; w += 32) wt += __popc(s_syn[w] ^ col[w]);
      wt = __reduce_add_sync(kFull, wt) + 1;
      const unsigned long long key = ((unsigned long long)wt << 32) | (unsigned)(1 + t);
      best = key < best ? key : best;
    }
    for (int q = warp; q < n_pairs; q += kWarps) {
      const uint32_t* ca = M + (size_t)s_tcol[pairs[2 * q]] * Wm;
      const uint32_t* cb = M + (size_t)s_tcol[pairs[2 * q + 1]] * Wm;
      int wt = 0;
      for (int w = lane; w < Wm; w += 32) wt += __popc(s_syn[w] ^ ca[w] ^ cb[w]);
      wt = __reduce_add_sync(kFull, wt) + 2;
      const unsigned long long key = ((unsigned long long)wt << 32) | (unsigned)(1 + n + q);
      best = key < best ? key : best;
    }
    best = warp_min(best);
    if (lane == 0) s_red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = warp_min(lane < kWarps ? s_red[lane] : ~0ull);
      if (lane == 0) s_red[0] = best;
    }
    __syncthreads();
    const int rank_id = (int)(s_red[0] & 0xffffffffull);
    if (rank_id >= 1 && rank_id <= n) {
      bt1 = rank_id - 1;
    } else if (rank_id > n) {
      const int q = rank_id - 1 - n;
      bt1 = s_tcol[pairs[2 * q]];
      bt2 = s_tcol[pairs[2 * q + 1]];
    }
  }
  for (int w = tid; w < Wm; w += kThreads) {
    uint32_t x = s_syn[w];
    if (bt1 >= 0) x ^= M[(size_t)bt1 * Wm + w];
    if (bt2 >= 0) x ^= M[(size_t)bt2 * Wm + w];
    s_best[w] = x;
  }
  __syncthreads();

  // ---- 5. osd0 / osdw in original coordinates ----
  for (int t = tid; t < n; t += kThreads) {
    const int orig = pb[t];
    const int p = s_prow[t];
    uint8_t v0 = 0, vw;
    if (p >= 0) {
      v0 = (s_syn[p >> 5] >> (p & 31)) & 1u;
      vw = (s_best[p >> 5] >> (p & 31)) & 1u;
    } else {
      vw = (t == bt1 || t == bt2);
    }
    e0[(size_t)b * n + orig] = v0;
    ew[(size_t)b * n + orig] = vw;
  }
}

}  // namespace

extern "C" size_t osd_large_smem_bytes(int n, int Wm, int lam) {
  return 8 * (size_t)kWarps + 4 * (2 * (size_t)n + 5 * (size_t)Wm + (lam > 0 ? lam : 1) + 4);
}

// Launches blocks for samples row0 .. row0 + rows - 1 on `stream`; block i
// works in scratch[i * (n + 1) * Wm ...].  Returns cudaGetLastError().
extern "C" int osd_large_launch(const void* h_cols, const void* perm, const void* synd,
                                const void* skip, const void* pairs, void* scratch, void* e0,
                                void* ew, int row0, int rows, int m, int n, int Wm, int rank,
                                int lam, int n_pairs, int sweep, void* stream) {
  const size_t smem = osd_large_smem_bytes(n, Wm, lam);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        osd_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  osd_large_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)h_cols, (const int32_t*)perm, (const uint8_t*)synd, (const uint8_t*)skip,
      (const int32_t*)pairs, (uint32_t*)scratch, (uint8_t*)e0, (uint8_t*)ew, row0, m, n, Wm,
      rank, lam, n_pairs, sweep);
  return (int)cudaGetLastError();
}
