// osd_large.cu -- ordered-statistics decoding (osd0 / osd_cs) for codes whose
// matrix does not fit in a block's shared memory, one thread block per sample,
// the matrix in device memory and a window of it in shared memory.
//
// Replaces the TPU kernel bp_osd_tpu/ops/pallas_osd_large.py:_osd_large_kernel
// (K5) and its pre-pass _permuted_packed_h.  The plain torch version is
// bp_osd_tpu_torch/decoder/osd.py:osd_decode_plain, the same function as for
// K2 (osd_cs.cu); the two agree bit for bit.
//
// Per sample, with perm the stable ascending argsort of the BP posterior:
//   1. copy the column-permuted matrix into this block's slice of a global
//      scratch buffer: column t is H[:, perm[t]] as Wm = ceil(m/32) words
//      (one row of the column-packed H); the syndrome is column n.  Word w of
//      column c sits at w * (n + 1) + c (word-major);
//   2. Gauss-Jordan over columns t = 0, 1, ...: the pivot row is the first
//      unused row carrying column t; S is column t without the pivot bit;
//      every column c in (t, n] carrying the pivot row gets S XORed in ("add
//      the pivot row to the other rows of column t", column by column).
//      Columns before t never carry an unused row's bit and are left alone;
//   3. osd0 reads the reduced syndrome at the pivot rows;
//   4. the sweep scores the zero pattern, weight 1 on every non-pivot column
//      (T, in reliability order) and weight 2 on the lexicographic pairs of
//      the first lam T columns by popcount of the residual syndrome; the key
//      (weight << 32 | candidate rank) makes the block-wide minimum the first
//      minimum in candidate order;
//   5. osd0 and osdw are scattered to original coordinates through perm.
// Weights count every row, as in K2 and the plain version.
//
// What bounds it on an H100: the elimination's chain of ~n dependent column
// steps a sample (one SM each), and the bytes of each pivot step.  One
// sample's matrix is (n + 1) * Wm * 4 bytes (6.0 MB at the [[10000,420]]
// code), far above a block's 227 KB of shared memory, and a heavy batch's
// matrices (~129 x 6 MB) are far above the 50 MB L2.  The first design (a
// step = a device read of column t by warp 0, up to three block barriers, a
// hit test reading one 32-byte sector per later column of the column-major
// layout) spent ~3.5-4 us a step.  This design:
//   - keeps a window of two panels of P columns in shared memory (P = 16
//     by the wrapper's choice: a wider window cost warp 0 more than the
//     panel changes it saved), column-major with an odd stride (one word of
//     every panel column is read without bank conflicts).  Warp 0 owns the
//     window: it searches the pivot of each column there (its lanes keep the
//     column's words and the used-row mask in registers), runs the hit test
//     and the XOR on the window's columns, and walks the dependent columns
//     (no pivot) with no block barrier.  A column in the window is updated
//     there only.  When warp 0 leaves a panel, warps 1-31 write it back (its
//     columns are final) and load the panel after the window into the freed
//     buffer with cp.async while warp 0 works on; the loads complete before
//     the next pivot step's barrier.
//   - warps 1-31 own the columns after the window: at a pivot step they test
//     word pw of each (in the word-major layout a coalesced run, 4 bytes a
//     column), list the hits, and after a second barrier XOR S into them
//     while warp 0 already searches the next columns.
//   - the event scalars, S and the hit counter are double-buffered (by the
//     parity of the event or of the pivot count), so a pivot step costs two
//     block barriers, a panel change one and a dependent step none.
// Shared memory: the two panels, S twice, the syndromes, the T columns, the
// pivot row of each column and the hit list (int16, so m and n are below
// 32768).  A skip sample writes zeros and returns.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kWorkers = kThreads - 32;  // warps 1-31
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 4;  // independent XOR loads a thread issues before using them
// hit tests a worker issues at once (12 spilled registers and ran slower)
constexpr int kScan = 4;

// the events warp 0 publishes
constexpr int kPivot = 0;
constexpr int kPanelEnd = 1;
constexpr int kDone = 2;

__host__ __device__ inline int panel_stride(int Wm) { return Wm | 1; }

__device__ __forceinline__ unsigned long long warp_min(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long y = __shfl_down_sync(kFull, x, off);
    x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// word w of column c in the word-major scratch of n1 = n + 1 columns
__device__ __forceinline__ size_t at(int c, int w, int n1) { return (size_t)w * n1 + c; }

// kLW >= ceil(Wm / 32): words of a column each lane of warp 0 keeps in
// registers for the pivot search, with the used-row mask (5: m <= 5120, the
// [[10000,420]] code; 8: m <= 8192; 32: m < 32768, which spills).  Every
// thread holds them, so they and the XOR batch share the 64 registers a
// 1024-thread block allows: 8 words and a batch of 8 loads spilled and ran
// the lift-400 rows slower.
template <int kLW>
__global__ void __launch_bounds__(kThreads)
osd_large_kernel(const int32_t* __restrict__ h_cols, const int32_t* __restrict__ perm,
                 const uint8_t* __restrict__ synd, const uint8_t* __restrict__ skip,
                 const int32_t* __restrict__ pairs, uint32_t* scratch,
                 uint8_t* __restrict__ e0, uint8_t* __restrict__ ew, int row0, int m, int n,
                 int Wm, int rank, int lam, int n_pairs, int sweep, int P) {
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

  const int n1 = n + 1;
  const int Wp = panel_stride(Wm);
  uint32_t* M = scratch + (size_t)blockIdx.x * n1 * Wm;
  const int32_t* pb = perm + (size_t)b * n;

  extern __shared__ unsigned long long smem64[];
  unsigned long long* s_red = smem64;                                 // [kWarps]
  uint32_t* s_panel = reinterpret_cast<uint32_t*>(s_red + kWarps);    // [2][P][Wp]
  uint32_t* s_Sval = s_panel + 2 * (size_t)P * Wp;                    // [2][Wm]
  int32_t* s_Sidx = reinterpret_cast<int32_t*>(s_Sval + 2 * Wm);      // [2][Wm]
  uint32_t* s_syn = reinterpret_cast<uint32_t*>(s_Sidx + 2 * Wm);     // [Wm]
  uint32_t* s_best = s_syn + Wm;                                      // [Wm]
  int32_t* s_tcol = reinterpret_cast<int32_t*>(s_best + Wm);          // [max(lam, 1)]
  int32_t* s_misc = s_tcol + (lam > 0 ? lam : 1);                     // [10]
  int16_t* s_prow = reinterpret_cast<int16_t*>(s_misc + 10);          // [n]
  int16_t* s_hits = s_prow + n;                                       // [n + 1]
  // s_misc: two events {kind, t, pivot row, |S|} by event parity, then the
  // hit counts of two pivots by pivot parity
  int32_t* s_count = s_misc + 8;

  auto slot = [&](int c) {  // column c of the window in shared memory
    return s_panel + ((size_t)((c / P) & 1) * P + c % P) * Wp;
  };

  // ---- 1. column-permuted, row-packed matrix; syndrome as column n ----
  // a warp writes 32 neighbouring columns, word by word
  for (int c0 = warp * 32; c0 < n; c0 += kThreads) {
    const int c = c0 + lane;
    if (c < n) {
      const int32_t* src = h_cols + (size_t)pb[c] * Wm;
      for (int w = 0; w < Wm; ++w) M[at(c, w, n1)] = (uint32_t)__ldg(src + w);
    }
  }
  for (int w = tid; w < Wm; w += kThreads) {
    uint32_t word = 0u;
    for (int bit = 0; bit < 32; ++bit) {
      const int row = w * 32 + bit;
      if (row < m) word |= (uint32_t)(synd[(size_t)b * m + row] & 1) << bit;
    }
    M[at(n, w, n1)] = word;
  }
  for (int t = tid; t < n; t += kThreads) s_prow[t] = -1;
  __syncthreads();

  // Element e of a panel is column e % P, word e / P: neighbouring threads
  // take neighbouring columns (coalesced in the word-major layout).  A thread
  // writes back and then reloads the same elements of a buffer.
  const int panel_items = P * Wm;
  for (int i = tid; i < 2 * panel_items; i += kThreads) {  // panels 0 and 1
    const int c = (i / panel_items) * P + i % P;
    const int w = (i % panel_items) / P;
    if (c < n) slot(c)[w] = M[at(c, w, n1)];
  }
  __syncthreads();

  // ---- 2. Gauss-Jordan in reliability order ----
  int k = 0;   // the panel warp 0 is in: the window is columns [k P, (k + 2) P)
  int t = 0;   // warp 0's next column
  int rr = 0;  // pivots found (warp 0: published; warps 1-31: processed)
  uint32_t used[kLW];  // warp 0, lane l: the pivot rows in words l, l + 32, ...
#pragma unroll
  for (int i = 0; i < kLW; ++i) used[i] = 0u;
  for (int ev = 0;; ++ev) {
    int32_t* event = s_misc + 4 * (ev & 1);
    if (warp == 0) {
      const int tend = min(n, (k + 1) * P);
      const uint32_t* col = s_panel + ((size_t)(k & 1) * P + (t - k * P)) * Wp;
      uint32_t cw[kLW];  // the lane's words of column t
      int pr = -1;
      for (; t < tend && rr < rank; ++t, col += Wp) {
#pragma unroll
        for (int i = 0; i < kLW; ++i) cw[i] = lane + 32 * i < Wm ? col[lane + 32 * i] : 0u;
        int fw = INT_MAX;
        uint32_t fx = 0u;
#pragma unroll
        for (int i = kLW - 1; i >= 0; --i) {
          const uint32_t x = cw[i] & ~used[i];
          if (x != 0u) {
            fw = lane + 32 * i;
            fx = x;
          }
        }
        const int wmin = __reduce_min_sync(kFull, fw);
        if (wmin == INT_MAX) continue;  // a dependent column: on to the next
        const unsigned src = __ballot_sync(kFull, fw == wmin);
        const uint32_t xs = __shfl_sync(kFull, fx, __ffs(src) - 1);
        pr = wmin * 32 + (__ffs(xs) - 1);
        break;
      }
      int kind = kDone;
      if (pr >= 0) {
        // S: column t without the pivot bit, compacted to its nonzero words
        const int pw = pr >> 5;
        const uint32_t pbit = 1u << (pr & 31);
        uint32_t* Sval = s_Sval + (rr & 1) * Wm;
        int32_t* Sidx = s_Sidx + (rr & 1) * Wm;
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < kLW; ++i) {
          const int w = lane + 32 * i;
          const uint32_t x = w == pw ? cw[i] & ~pbit : cw[i];
          if (w == pw) used[i] |= pbit;
          const unsigned nz = __ballot_sync(kFull, x != 0u);
          if (x != 0u) {
            const int pos = cnt + __popc(nz & lt_mask);
            Sidx[pos] = w;
            Sval[pos] = x;
          }
          cnt += __popc(nz);
        }
        kind = kPivot;
        if (lane == 0) {
          s_prow[t] = (int16_t)pr;
          s_count[rr & 1] = 0;
          event[3] = cnt;
        }
      } else if (t < n && rr < rank) {
        kind = kPanelEnd;
      }
      if (lane == 0) {
        event[0] = kind;
        event[1] = t;
        event[2] = pr;
      }
      __syncwarp();
    } else {
      cp_async_wait_all();  // this thread's loads of the next panel
    }
    __syncthreads();
    const int kind = event[0];
    if (kind == kDone) break;
    if (kind == kPanelEnd) {
      if (warp != 0) {  // write back panel k; load panel k + 2 into its buffer
        for (int i = tid - 32; i < panel_items; i += kWorkers) {
          const int j = i % P, w = i / P;
          const int c = k * P + j, c2 = c + 2 * P;
          uint32_t* s = slot(c) + w;
          if (c < n) M[at(c, w, n1)] = *s;
          if (c2 < n) cp_async4(s, M + at(c2, w, n1));
        }
      }
      ++k;
      continue;
    }

    // a pivot at column tp, row pr
    const int tp = event[1], pr = event[2], nS = event[3];
    const int par = rr & 1;
    const uint32_t* Sval = s_Sval + par * Wm;
    const int32_t* Sidx = s_Sidx + par * Wm;
    const int pw = pr >> 5;
    const uint32_t pbit = 1u << (pr & 31);
    const int wend = min(n, (k + 2) * P);  // the window ends here
    if (warp == 0) {
      ++t;
      ++rr;
      // the window's columns after tp that carry the pivot row
      for (int c0 = tp + 1; c0 < wend; c0 += 32) {
        const int c = c0 + lane;
        unsigned hm = __ballot_sync(kFull, c < wend && (slot(c)[pw] & pbit) != 0u);
        while (hm) {
          uint32_t* col = slot(c0 + __ffs(hm) - 1);
          hm &= hm - 1;
          for (int q = lane; q < nS; q += 32) col[Sidx[q]] ^= Sval[q];
        }
      }
      __syncwarp();
    } else {
      // the columns after the window (syndrome included) that carry it
      for (int c0 = wend + (warp - 1) * 32; c0 <= n; c0 += kScan * kWorkers) {
        bool hit[kScan];
#pragma unroll
        for (int u = 0; u < kScan; ++u) {
          const int c = c0 + u * kWorkers + lane;
          hit[u] = c <= n && (M[at(c, pw, n1)] & pbit) != 0u;
        }
#pragma unroll
        for (int u = 0; u < kScan; ++u) {
          const unsigned hm = __ballot_sync(kFull, hit[u]);
          if (hm == 0u) continue;
          int base = 0;
          if (lane == 0) base = atomicAdd(&s_count[par], __popc(hm));
          base = __shfl_sync(kFull, base, 0);
          if (hit[u]) s_hits[base + __popc(hm & lt_mask)] = (int16_t)(c0 + u * kWorkers + lane);
        }
      }
    }
    __syncthreads();
    if (warp != 0) {
      // XOR S into every hit column; the (column, word) items are distinct.
      // Neighbouring threads take neighbouring hit columns of one word.
      const int nh = s_count[par];
      const int work = nh * nS;
      for (int i0 = tid - 32; i0 < work; i0 += kBatch * kWorkers) {
        uint32_t* p[kBatch];
        uint32_t v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kWorkers;
          p[u] = nullptr;
          if (i < work) {
            const int h = i % nh;
            const int q = i / nh;
            p[u] = M + at(s_hits[h], Sidx[q], n1);
            v[u] = *p[u] ^ Sval[q];
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (p[u]) *p[u] = v[u];
      }
      ++rr;
    }
  }
  // the window's columns are the last of the matrix not yet in device memory
  for (int i = tid; i < 2 * panel_items; i += kThreads) {
    const int c = k * P + (i / panel_items) * P + i % P;
    const int w = (i % panel_items) / P;
    if (c < n) M[at(c, w, n1)] = slot(c)[w];
  }
  __syncthreads();

  // ---- T: the first lam non-pivot columns, in reliability order ----
  for (int w = tid; w < Wm; w += kThreads) s_syn[w] = M[at(n, w, n1)];
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < n && cnt < lam; base += 32) {
      const int c = base + lane;
      const bool is_t = c < n && s_prow[c] < 0;
      const unsigned mask = __ballot_sync(kFull, is_t);
      const int pos = cnt + __popc(mask & lt_mask);
      if (is_t && pos < lam) s_tcol[pos] = c;
      cnt += __popc(mask);
    }
  }
  __syncthreads();
  // the lam T columns of the pairs, copied into the panels' space when they fit
  const bool t_shared = lam <= 2 * P;
  if (t_shared)
    for (int i = tid; i < lam * Wm; i += kThreads) {
      const int j = i / Wm, w = i - j * Wm;
      s_panel[(size_t)j * Wp + w] = M[at(s_tcol[j], w, n1)];
    }
  __syncthreads();
  auto tword = [&](int j, int w) {
    return t_shared ? s_panel[(size_t)j * Wp + w] : M[at(s_tcol[j], w, n1)];
  };

  // ---- 4. candidate sweep ----
  int bt1 = -1, bt2 = -1;
  if (sweep) {
    unsigned long long best = ~0ull;
    if (tid == 0) {
      int w0 = 0;
      for (int w = 0; w < Wm; ++w) w0 += __popc(s_syn[w]);
      best = (unsigned long long)w0 << 32;
    }
    // weight 1: a lane a column, 32 neighbouring columns a warp
    for (int c = tid; c < n; c += kThreads) {
      if (s_prow[c] >= 0) continue;
      int wt = 1;
      for (int w = 0; w < Wm; ++w) wt += __popc(s_syn[w] ^ M[at(c, w, n1)]);
      const unsigned long long key = ((unsigned long long)wt << 32) | (unsigned)(1 + c);
      best = key < best ? key : best;
    }
    // weight 2: a warp a pair, lanes over the words
    for (int q = warp; q < n_pairs; q += kWarps) {
      const int ja = pairs[2 * q], jb = pairs[2 * q + 1];
      int wt = 0;
      for (int w = lane; w < Wm; w += 32) wt += __popc(s_syn[w] ^ tword(ja, w) ^ tword(jb, w));
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
    if (bt1 >= 0) x ^= M[at(bt1, w, n1)];
    if (bt2 >= 0) x ^= M[at(bt2, w, n1)];
    s_best[w] = x;
  }
  __syncthreads();

  // ---- 5. osd0 / osdw in original coordinates ----
  for (int c = tid; c < n; c += kThreads) {
    const int orig = pb[c];
    const int p = s_prow[c];
    uint8_t v0 = 0, vw;
    if (p >= 0) {
      v0 = (s_syn[p >> 5] >> (p & 31)) & 1u;
      vw = (s_best[p >> 5] >> (p & 31)) & 1u;
    } else {
      vw = (c == bt1 || c == bt2);
    }
    e0[(size_t)b * n + orig] = v0;
    ew[(size_t)b * n + orig] = vw;
  }
}

using LargeKernel = void (*)(const int32_t*, const int32_t*, const uint8_t*, const uint8_t*,
                             const int32_t*, uint32_t*, uint8_t*, uint8_t*, int, int, int, int,
                             int, int, int, int, int);

LargeKernel large_kernel(int Wm) {
  if (Wm <= 5 * 32) return osd_large_kernel<5>;
  if (Wm <= 8 * 32) return osd_large_kernel<8>;
  return osd_large_kernel<32>;
}

}  // namespace

// Shared memory of one block: the two panels of P columns (odd stride), S
// twice, the used-row mask, the syndromes, the T columns and the event
// words; the pivot rows and the hit list as int16.
extern "C" size_t osd_large_smem_bytes(int n, int Wm, int lam, int P) {
  return 8 * (size_t)kWarps +
         4 * (2 * (size_t)P * panel_stride(Wm) + 6 * (size_t)Wm + (lam > 0 ? lam : 1) + 10) +
         2 * (2 * (size_t)n + 1);
}

// Launches blocks for samples row0 .. row0 + rows - 1 on `stream`, panels of
// P columns; block i works in scratch[i * (n + 1) * Wm ...].  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel does
// not take.
extern "C" int osd_large_launch(const void* h_cols, const void* perm, const void* synd,
                                const void* skip, const void* pairs, void* scratch, void* e0,
                                void* ew, int row0, int rows, int m, int n, int Wm, int rank,
                                int lam, int n_pairs, int sweep, int P, void* stream) {
  if (P < 1 || m > 32767 || n > 32767) return (int)cudaErrorInvalidValue;
  const size_t smem = osd_large_smem_bytes(n, Wm, lam, P);
  auto kernel = large_kernel(Wm);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)h_cols, (const int32_t*)perm, (const uint8_t*)synd, (const uint8_t*)skip,
      (const int32_t*)pairs, (uint32_t*)scratch, (uint8_t*)e0, (uint8_t*)ew, row0, m, n, Wm,
      rank, lam, n_pairs, sweep, P);
  return (int)cudaGetLastError();
}

// The kernel's registers a thread and resident blocks an SM at this shape:
// out = {registers, blocks an SM}.  Returns 0 or the CUDA error.
extern "C" int osd_large_plan(int n, int Wm, int lam, int P, int* out) {
  auto kernel = large_kernel(Wm);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = osd_large_smem_bytes(n, Wm, lam, P);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = per_sm;
  return 0;
}
