// osd_cs.cu -- ordered-statistics decoding with the combination sweep (K2)
// or the exhaustive search (K3), one thread block per sample.
//
// Replaces the TPU kernel bp_osd_tpu/ops/pallas_osd.py:_osd_kernel with
// mode="cs" (K2, entry osd_cs_launch) and mode="e" (K3, entry osd_e_launch),
// together with its matrix-unit pre-pass _permuted_packed_h.  The plain
// torch version is bp_osd_tpu_torch/decoder/osd.py:osd_decode_plain; the
// kernel agrees with it bit for bit in both modes.
//
// Per sample, with perm the stable ascending argsort of the BP posterior:
//   1. build the column-permuted matrix in shared memory, column-major and
//      bit-packed along rows: column t is H[:, perm[t]] as Wm = ceil(m/32)
//      words, read from the row-packed H; the syndrome is column n;
//   2. Gauss-Jordan over columns t = 0, 1, ...: one warp picks the pivot row,
//      the first unused row carrying column t (ballot over the words), then
//      every column holding the pivot row's bit XORs in the packed set of
//      the other rows carrying column t -- that is "add the pivot row to
//      those rows", done column by column;
//   3. osd0 reads the reduced syndrome at the pivot rows;
//   4. the sweep scores the zero pattern, weight 1 on every non-pivot column
//      (T, in reliability order) and weight 2 on the lexicographic pairs of
//      the first lam T columns by popcount of the residual syndrome; the
//      key (weight << 32 | candidate rank) makes the block-wide minimum the
//      first minimum in candidate order;
//   4e. (K3, in place of 4) the walk over all 2^lam patterns on the first
//      lam <= 16 T columns: the patterns are split into contiguous ranges of
//      the Gray-code sequence, one per thread; a thread seeds its residual
//      s ^ XOR(T_j for the bits j of gray(start)) and then XORs one T column
//      per step (gray(i) and gray(i-1) differ in bit ctz(i)).  The key
//      (popcount(residual) + popcount(g)) << 32 | g, with g = gray(i) the
//      pattern, makes the block-wide minimum the first minimum in pattern
//      counting order, as in the JAX package.  The residual stays in
//      registers (8 or 32 words, so m <= 1024);
//   5. osd0 and osdw are scattered to original coordinates through perm.
// Weights count every row; the non-pivot rows of a reduced column are zero,
// so this adds the same constant to every candidate as the JAX package's
// pivot-row weights and picks the same winner.
//
// What bounds it on an H100: the elimination's ~rank sequential steps, each
// two block barriers around (n + 1) * Wm word XORs in shared memory (401 x 6
// at the flagship); the candidate sweep is 1 + n + lam(lam-1)/2 popcounts of
// Wm words (1262 x 6 at order 42); K3's walk is 2^lam residual XORs and
// popcounts of Wm words (4096 x 6 at order 12, 16 steps a thread).  Device-memory traffic is perm, the
// syndrome and the two outputs once per sample, plus the 10 KB row-packed H
// that every block reads through L2.  The TPU kernel built the permuted
// matrix with a one-hot matrix product and kept the batch on vector lanes;
// here a block owns a sample, the matrix (~10 KB) lives in shared memory
// and many blocks share an SM.  A skip sample writes zeros and returns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long y = __shfl_down_sync(0xffffffffu, x, off);
    x = y < x ? y : x;
  }
  return x;
}

// K3's walk over the patterns [lo, hi) of the Gray-code sequence; returns
// the least key of the range.  kRes >= Wm words of residual in registers.
template <int kRes>
__device__ unsigned long long gray_walk(const uint32_t* s, const uint32_t* s_cols,
                                        const int32_t* s_tcol, int Wm, int lo, int hi) {
  uint32_t res[kRes];
#pragma unroll
  for (int w = 0; w < kRes; ++w) res[w] = w < Wm ? s[w] : 0u;
  for (unsigned g = lo ^ (lo >> 1); g; g &= g - 1) {
    const uint32_t* col = s_cols + (size_t)s_tcol[__ffs(g) - 1] * Wm;
#pragma unroll
    for (int w = 0; w < kRes; ++w)
      if (w < Wm) res[w] ^= col[w];
  }
  unsigned long long best = ~0ull;
  for (int i = lo; i < hi; ++i) {
    if (i > lo) {
      const uint32_t* col = s_cols + (size_t)s_tcol[__ffs(i) - 1] * Wm;
#pragma unroll
      for (int w = 0; w < kRes; ++w)
        if (w < Wm) res[w] ^= col[w];
    }
    const unsigned g = i ^ (i >> 1);
    int wt = __popc(g);
#pragma unroll
    for (int w = 0; w < kRes; ++w)
      if (w < Wm) wt += __popc(res[w]);
    const unsigned long long key = ((unsigned long long)wt << 32) | g;
    best = key < best ? key : best;
  }
  return best;
}

template <bool kExhaustive>
__global__ void __launch_bounds__(kThreads)
osd_cs_kernel(const int32_t* __restrict__ h_packed, const int32_t* __restrict__ perm,
              const uint8_t* __restrict__ synd, const uint8_t* __restrict__ skip,
              const int32_t* __restrict__ pairs, uint8_t* __restrict__ e0,
              uint8_t* __restrict__ ew, int m, int n, int W, int Wm, int rank, int lam,
              int n_pairs, int sweep) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (skip && skip[b]) {
    for (int v = tid; v < n; v += kThreads) {
      e0[(size_t)b * n + v] = 0;
      ew[(size_t)b * n + v] = 0;
    }
    return;
  }

  extern __shared__ unsigned long long smem64[];
  unsigned long long* s_red = smem64;                             // [kWarps]
  uint32_t* s_cols = reinterpret_cast<uint32_t*>(s_red + kWarps);  // [(n+1) * Wm]
  uint32_t* s_h = s_cols + (size_t)(n + 1) * Wm;                  // [m * W]
  int32_t* s_perm = reinterpret_cast<int32_t*>(s_h + (size_t)m * W);  // [n]
  int32_t* s_prow = s_perm + n;                                   // [n]
  int32_t* s_tcol = s_prow + n;                                   // [max(lam, 1)]
  uint32_t* s_used = reinterpret_cast<uint32_t*>(s_tcol + (lam > 0 ? lam : 1));  // [Wm]
  uint32_t* s_S = s_used + Wm;                                    // [Wm]
  uint32_t* s_best = s_S + Wm;                                    // [Wm]
  int32_t* s_misc = reinterpret_cast<int32_t*>(s_best + Wm);      // [4]

  for (int i = tid; i < m * W; i += kThreads) s_h[i] = (uint32_t)h_packed[i];
  for (int t = tid; t < n; t += kThreads) {
    s_perm[t] = perm[(size_t)b * n + t];
    s_prow[t] = -1;
  }
  for (int w = tid; w < Wm; w += kThreads) s_used[w] = 0u;
  __syncthreads();

  // ---- 1. column-permuted, row-packed matrix; syndrome as column n ----
  for (int i = tid; i < (n + 1) * Wm; i += kThreads) {
    const int t = i / Wm;
    const int wm = i - t * Wm;
    uint32_t word = 0u;
    if (t < n) {
      const int orig = s_perm[t];
      const int ow = orig >> 5, ob = orig & 31;
      for (int bit = 0; bit < 32; ++bit) {
        const int row = wm * 32 + bit;
        if (row < m) word |= ((s_h[row * W + ow] >> ob) & 1u) << bit;
      }
    } else {
      for (int bit = 0; bit < 32; ++bit) {
        const int row = wm * 32 + bit;
        if (row < m) word |= (uint32_t)(synd[(size_t)b * m + row] & 1) << bit;
      }
    }
    s_cols[i] = word;
  }
  __syncthreads();

  // ---- 2. Gauss-Jordan in reliability order ----
  int rr = 0;
  for (int t = 0; t < n && rr < rank; ++t) {
    if (warp == 0) {
      int pr = -1;
      for (int base = 0; base < Wm && pr < 0; base += 32) {
        const int w = base + lane;
        const uint32_t x = w < Wm ? (s_cols[t * Wm + w] & ~s_used[w]) : 0u;
        const unsigned hit = __ballot_sync(0xffffffffu, x != 0u);
        if (hit) {
          const int src = __ffs(hit) - 1;
          const uint32_t xs = __shfl_sync(0xffffffffu, x, src);
          pr = (base + src) * 32 + (__ffs(xs) - 1);
        }
      }
      for (int w = lane; w < Wm; w += 32) {
        uint32_t col = s_cols[t * Wm + w];
        if (pr >= 0 && w == (pr >> 5)) col &= ~(1u << (pr & 31));
        s_S[w] = col;
      }
      if (lane == 0) {
        s_misc[0] = pr;
        if (pr >= 0) {
          s_used[pr >> 5] |= 1u << (pr & 31);
          s_prow[t] = pr;
        }
      }
    }
    __syncthreads();
    const int pr = s_misc[0];
    if (pr >= 0) {
      const int pw = pr >> 5, pb = pr & 31;
      for (int c = tid; c <= n; c += kThreads) {
        uint32_t* col = s_cols + (size_t)c * Wm;
        if ((col[pw] >> pb) & 1u)
          for (int w = 0; w < Wm; ++w) col[w] ^= s_S[w];
      }
      ++rr;
    }
    __syncthreads();
  }

  // ---- T: the first lam non-pivot columns, in reliability order ----
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < n && cnt < lam; base += 32) {
      const int t = base + lane;
      const bool is_t = t < n && s_prow[t] < 0;
      const unsigned mask = __ballot_sync(0xffffffffu, is_t);
      const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
      if (is_t && pos < lam) s_tcol[pos] = t;
      cnt += __popc(mask);
    }
  }
  __syncthreads();

  // ---- 4. candidate sweep: block-wide first minimum of the keys ----
  const uint32_t* s = s_cols + (size_t)n * Wm;
  int bt1 = -1, bt2 = -1;
  unsigned pattern = 0u;  // K3: the winner's T bits
  if constexpr (kExhaustive) {
    const int C = 1 << lam;
    const int per = (C + kThreads - 1) / kThreads;
    const int lo = min(C, tid * per), hi = min(C, lo + per);
    unsigned long long best = Wm <= 8 ? gray_walk<8>(s, s_cols, s_tcol, Wm, lo, hi)
                                      : gray_walk<32>(s, s_cols, s_tcol, Wm, lo, hi);
    best = warp_min(best);
    if (lane == 0) s_red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = warp_min(lane < kWarps ? s_red[lane] : ~0ull);
      if (lane == 0) s_red[0] = best;
    }
    __syncthreads();
    pattern = (unsigned)(s_red[0] & 0xffffffffull);
  } else if (sweep) {
    unsigned long long best = ~0ull;
    if (tid == 0) {
      int w0 = 0;
      for (int w = 0; w < Wm; ++w) w0 += __popc(s[w]);
      best = (unsigned long long)w0 << 32;
    }
    for (int t = tid; t < n; t += kThreads) {
      if (s_prow[t] >= 0) continue;
      const uint32_t* col = s_cols + (size_t)t * Wm;
      int wt = 1;
      for (int w = 0; w < Wm; ++w) wt += __popc(s[w] ^ col[w]);
      const unsigned long long key = ((unsigned long long)wt << 32) | (unsigned)(1 + t);
      best = key < best ? key : best;
    }
    for (int q = tid; q < n_pairs; q += kThreads) {
      const uint32_t* ca = s_cols + (size_t)s_tcol[pairs[2 * q]] * Wm;
      const uint32_t* cb = s_cols + (size_t)s_tcol[pairs[2 * q + 1]] * Wm;
      int wt = 2;
      for (int w = 0; w < Wm; ++w) wt += __popc(s[w] ^ ca[w] ^ cb[w]);
      const unsigned long long key =
          ((unsigned long long)wt << 32) | (unsigned)(1 + n + q);
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
    uint32_t x = s[w];
    if (bt1 >= 0) x ^= s_cols[(size_t)bt1 * Wm + w];
    if (bt2 >= 0) x ^= s_cols[(size_t)bt2 * Wm + w];
    for (unsigned g = pattern; g; g &= g - 1)
      x ^= s_cols[(size_t)s_tcol[__ffs(g) - 1] * Wm + w];
    s_best[w] = x;
  }
  __syncthreads();

  // ---- 5. osd0 / osdw in original coordinates ----
  for (int t = tid; t < n; t += kThreads) {
    const int orig = s_perm[t];
    const int p = s_prow[t];
    uint8_t v0 = 0, vw;
    if (p >= 0) {
      v0 = (s[p >> 5] >> (p & 31)) & 1u;
      vw = (s_best[p >> 5] >> (p & 31)) & 1u;
    } else {
      vw = (t == bt1 || t == bt2);
      for (unsigned g = pattern; g; g &= g - 1)
        vw |= t == s_tcol[__ffs(g) - 1];
    }
    e0[(size_t)b * n + orig] = v0;
    ew[(size_t)b * n + orig] = vw;
  }
}

}  // namespace

extern "C" size_t osd_cs_smem_bytes(int m, int n, int W, int Wm, int lam) {
  return 8 * (size_t)kWarps +
         4 * ((size_t)(n + 1) * Wm + (size_t)m * W + 2 * (size_t)n +
              (lam > 0 ? lam : 1) + 3 * (size_t)Wm + 4);
}

namespace {

template <bool kExhaustive>
int launch(const void* h_packed, const void* perm, const void* synd, const void* skip,
           const void* pairs, void* e0, void* ew, int B, int m, int n, int W, int Wm,
           int rank, int lam, int n_pairs, int sweep, void* stream) {
  const size_t smem = osd_cs_smem_bytes(m, n, W, Wm, lam);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(osd_cs_kernel<kExhaustive>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  osd_cs_kernel<kExhaustive><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)h_packed, (const int32_t*)perm, (const uint8_t*)synd,
      (const uint8_t*)skip, (const int32_t*)pairs, (uint8_t*)e0, (uint8_t*)ew, m, n, W, Wm,
      rank, lam, n_pairs, sweep);
  return (int)cudaGetLastError();
}

}  // namespace

// K2: osd_cs (osd0 with sweep = 0).  Launches on `stream`; returns
// cudaGetLastError() of the launch.
extern "C" int osd_cs_launch(const void* h_packed, const void* perm, const void* synd,
                             const void* skip, const void* pairs, void* e0, void* ew,
                             int B, int m, int n, int W, int Wm, int rank, int lam,
                             int n_pairs, int sweep, void* stream) {
  return launch<false>(h_packed, perm, synd, skip, pairs, e0, ew, B, m, n, W, Wm, rank, lam,
                       n_pairs, sweep, stream);
}

// K3: osd_e over the 2^lam patterns of the first 1 <= lam <= 16 T columns;
// needs Wm <= 32.  Launches on `stream`; returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int osd_e_launch(const void* h_packed, const void* perm, const void* synd,
                            const void* skip, void* e0, void* ew, int B, int m, int n, int W,
                            int Wm, int rank, int lam, void* stream) {
  if (lam < 1 || lam > 16 || Wm > 32) return (int)cudaErrorInvalidValue;
  return launch<true>(h_packed, perm, synd, skip, nullptr, e0, ew, B, m, n, W, Wm, rank, lam,
                      0, 0, stream);
}
