// osd_cs.cu -- ordered-statistics decoding with the combination sweep (K2,
// one warp per sample) or the exhaustive search (K3, one block per sample).
//
// Replaces the TPU kernel bp_osd_tpu/ops/pallas_osd.py:_osd_kernel with
// mode="cs" (K2, entry osd_cs_launch) and mode="e" (K3, entry osd_e_launch),
// together with its matrix-unit pre-pass _permuted_packed_h.  The plain
// torch version is bp_osd_tpu_torch/decoder/osd.py:osd_decode_plain; both
// kernels agree with it bit for bit.
//
// Per sample, with perm the stable ascending argsort of the BP posterior:
//   1. build the column-permuted matrix, column-major and bit-packed along
//      rows: column t is H[:, perm[t]] as Wm = ceil(m/32) words; the
//      syndrome is column n;
//   2. Gauss-Jordan over columns t = 0, 1, ... until rank pivots: the pivot
//      row is the first unused row carrying column t (ballot over the
//      words), then every column holding the pivot row's bit XORs in the
//      packed set of the other rows carrying column t -- that is "add the
//      pivot row to those rows", done column by column;
//   3. osd0 reads the reduced syndrome at the pivot rows;
//   4. the sweep scores the zero pattern, weight 1 on every non-pivot column
//      (T, in reliability order) and weight 2 on the lexicographic pairs of
//      the first lam T columns by popcount of the residual syndrome; the
//      key (weight << 32 | candidate rank) makes the minimum the first
//      minimum in candidate order;
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
// What bounds K2 on an H100: integer work, ~3-5e5 operations a flagship row
// (the elimination's ~rank steps, each a bit test on n + 1 columns and Wm
// word XORs into the hit ones; 1262 candidates of Wm popcounts at order 42),
// a few hundred KB of device-memory traffic for a whole batch.  The first
// design (one 256-thread block per sample) spent it on synchronisation: two
// block barriers a pivot step (~384 a row) around ~1.6 columns of work a
// thread, a serial pivot search in warp 0, a bit-by-bit gather of every
// column from the row-packed H, and a copy of H in every block.  Now a warp
// owns a sample and a block holds several: the elimination runs with no
// block barrier (ballot for the pivot, the pivot column broadcast into every
// lane's registers by shuffles, the n + 1 columns spread over the 32 lanes,
// __syncwarp between steps), and the block's one copy of the column-packed
// H ([n, Wm] words from TannerGraph.H_cols) makes step 1 a copy of Wm-word
// columns by perm.  A skip sample writes zeros and returns.
//
// K3 keeps the first design: its Gray-code walk wants the block's 256
// threads on one sample.

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

// ---------------------------------------------------------------------------
// K3: one block per sample (the first design of this file).

__global__ void __launch_bounds__(kThreads)
osd_e_kernel(const int32_t* __restrict__ h_packed, const int32_t* __restrict__ perm,
             const uint8_t* __restrict__ synd, const uint8_t* __restrict__ skip,
             uint8_t* __restrict__ e0, uint8_t* __restrict__ ew, int m, int n, int W, int Wm,
             int rank, int lam) {
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

  // ---- 4e. Gray-code walk: block-wide first minimum of the keys ----
  const uint32_t* s = s_cols + (size_t)n * Wm;
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
  const unsigned pattern = (unsigned)(s_red[0] & 0xffffffffull);  // the winner's T bits
  for (int w = tid; w < Wm; w += kThreads) {
    uint32_t x = s[w];
    for (unsigned g = pattern; g; g &= g - 1)
      x ^= s_cols[(size_t)s_tcol[__ffs(g) - 1] * Wm + w];
    s_best[w] = x;
  }
  __syncthreads();

  // ---- 5. osd0 / osdw in original coordinates ----
  for (int t = tid; t < n; t += kThreads) {
    const int orig = s_perm[t];
    const int p = s_prow[t];
    uint8_t v0 = 0, vw = 0;
    if (p >= 0) {
      v0 = (s[p >> 5] >> (p & 31)) & 1u;
      vw = (s_best[p >> 5] >> (p & 31)) & 1u;
    } else {
      for (unsigned g = pattern; g; g &= g - 1) vw |= t == s_tcol[__ffs(g) - 1];
    }
    e0[(size_t)b * n + orig] = v0;
    ew[(size_t)b * n + orig] = vw;
  }
}

// ---------------------------------------------------------------------------
// K2: one warp per sample, several samples a block sharing one copy of H.

constexpr unsigned kFull = 0xffffffffu;

// Words of a column in K2's shared memory: Wm rounded up to even, so that a
// column is read and XORed as 64-bit pairs.
__host__ __device__ inline int pair_words(int Wm) { return (Wm + 1) & ~1; }

__host__ __device__ inline size_t warp_words(int n, int Wm, int lam) {
  // columns (n + 1) x pair_words, pivot rows as int16, T columns, best
  // residual; even, so that the next warp's columns stay 8-byte aligned
  const size_t w = (size_t)(n + 1) * pair_words(Wm) + (n + 1) / 2 + (lam > 0 ? lam : 1) + Wm;
  return (w + 1) & ~(size_t)1;
}

__device__ __forceinline__ uint32_t bit_at(const uint32_t* x, int p) {
  return (x[p >> 5] >> (p & 31)) & 1u;
}

// kWm >= Wm: words a column keeps in registers (the pivot column, the
// syndrome).
template <int kWm>
__global__ void osd_cs_warp_kernel(const int32_t* __restrict__ h_cols,
                                   const int32_t* __restrict__ perm,
                                   const uint8_t* __restrict__ synd,
                                   const uint8_t* __restrict__ skip,
                                   const int32_t* __restrict__ pairs, uint8_t* __restrict__ e0,
                                   uint8_t* __restrict__ ew, int B, int m, int n, int Wm,
                                   int rank, int lam, int n_pairs, int sweep) {
  extern __shared__ uint32_t smem32[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int Wp = pair_words(Wm);
  const int P = Wp / 2;  // 64-bit words a column
  uint32_t* s_h = smem32;  // [n][Wp], H column-packed, shared by the block's warps
  for (int i = threadIdx.x; i < n * Wp; i += blockDim.x) {
    const int c = i / Wp, w = i - c * Wp;
    s_h[i] = w < Wm ? (uint32_t)h_cols[c * Wm + w] : 0u;
  }
  __syncthreads();

  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  uint8_t* o0 = e0 + (size_t)b * n;
  uint8_t* ow = ew + (size_t)b * n;
  if (skip && skip[b]) {
    for (int t = lane; t < n; t += 32) o0[t] = ow[t] = 0;
    return;
  }
  uint32_t* cols = s_h + (size_t)n * Wp + warp * warp_words(n, Wm, lam);  // [n + 1][Wp]
  int16_t* prow = reinterpret_cast<int16_t*>(cols + (size_t)(n + 1) * Wp);  // [n]
  int32_t* tcol = reinterpret_cast<int32_t*>(cols + (size_t)(n + 1) * Wp + (n + 1) / 2);
  uint32_t* best = reinterpret_cast<uint32_t*>(tcol + (lam > 0 ? lam : 1));  // [Wm]
  const int32_t* pm = perm + (size_t)b * n;

  // ---- 1. column t = H[:, perm[t]]; the syndrome as column n ----
  for (int t = lane; t < n; t += 32) {
    const uint2* src = reinterpret_cast<const uint2*>(s_h + (size_t)pm[t] * Wp);
    uint2* dst = reinterpret_cast<uint2*>(cols + (size_t)t * Wp);
    for (int w = 0; w < P; ++w) dst[w] = src[w];
    prow[t] = -1;
  }
  const uint8_t* sy = synd + (size_t)b * m;
  for (int w = 0; w < Wp; ++w) {
    const int row = w * 32 + lane;
    const unsigned word = __ballot_sync(kFull, row < m && (sy[row] & 1));
    if (lane == 0) cols[(size_t)n * Wp + w] = word;
  }
  __syncwarp();

  // ---- 2. Gauss-Jordan in reliability order, no block barrier ----
  uint32_t used = 0u;  // lane w < Wm: the pivot rows in word w
  int rr = 0;
  for (int t = 0; t < n && rr < rank; ++t) {
    const uint32_t ct = lane < Wm ? cols[(size_t)t * Wp + lane] : 0u;
    const uint32_t x = ct & ~used;
    const unsigned hit = __ballot_sync(kFull, x != 0u);
    if (!hit) continue;  // no pivot in column t
    const int pw = __ffs(hit) - 1;
    const int pb = __ffs(__shfl_sync(kFull, x, pw)) - 1;
    const uint32_t mine = lane == pw ? ct & ~(1u << pb) : ct;
    unsigned long long S[kWm / 2];  // column t without the pivot bit, in every lane
#pragma unroll
    for (int w = 0; w < kWm / 2; ++w)
      S[w] = (unsigned long long)__shfl_sync(kFull, mine, 2 * w) |
             (unsigned long long)__shfl_sync(kFull, mine, 2 * w + 1) << 32;
    if (lane == pw) used |= 1u << pb;
    if (lane == 0) prow[t] = (int16_t)(pw * 32 + pb);
    // the lane's columns c = lane + 32 k holding the pivot row, 32 k at a time
    for (int c0 = 0; c0 <= n; c0 += 1024) {
      uint32_t hits = 0u;
      for (int k = 0, c = c0 + lane; k < 32 && c <= n; ++k, c += 32)
        hits |= ((cols[(size_t)c * Wp + pw] >> pb) & 1u) << k;
      while (hits) {
        const int k = __ffs(hits) - 1;
        hits &= hits - 1;
        unsigned long long* col =
            reinterpret_cast<unsigned long long*>(cols + (size_t)(c0 + lane + 32 * k) * Wp);
#pragma unroll
        for (int w = 0; w < kWm / 2; ++w)
          if (w < P) col[w] ^= S[w];
      }
    }
    __syncwarp();
    ++rr;
  }

  // ---- T: the first lam non-pivot columns, in reliability order ----
  int cnt = 0;
  for (int base = 0; base < n && cnt < lam; base += 32) {
    const int t = base + lane;
    const bool is_t = t < n && prow[t] < 0;
    const unsigned mask = __ballot_sync(kFull, is_t);
    const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
    if (is_t && pos < lam) tcol[pos] = t;
    cnt += __popc(mask);
  }
  __syncwarp();

  // ---- 4. candidate sweep: the warp's first minimum of the keys ----
  const uint32_t* s = cols + (size_t)n * Wp;
  uint32_t sr[kWm];
#pragma unroll
  for (int w = 0; w < kWm; ++w) sr[w] = w < Wm ? s[w] : 0u;
  int bt1 = -1, bt2 = -1;
  if (sweep) {
    unsigned long long key_min = ~0ull;
    if (lane == 0) {
      int w0 = 0;
#pragma unroll
      for (int w = 0; w < kWm; ++w) w0 += __popc(sr[w]);
      key_min = (unsigned long long)w0 << 32;
    }
    for (int t = lane; t < n; t += 32) {
      if (prow[t] >= 0) continue;
      const uint32_t* col = cols + (size_t)t * Wp;
      int wt = 1;
#pragma unroll
      for (int w = 0; w < kWm; ++w)
        if (w < Wm) wt += __popc(sr[w] ^ col[w]);
      const unsigned long long key = ((unsigned long long)wt << 32) | (unsigned)(1 + t);
      key_min = key < key_min ? key : key_min;
    }
    for (int q = lane; q < n_pairs; q += 32) {
      const uint32_t* ca = cols + (size_t)tcol[pairs[2 * q]] * Wp;
      const uint32_t* cb = cols + (size_t)tcol[pairs[2 * q + 1]] * Wp;
      int wt = 2;
#pragma unroll
      for (int w = 0; w < kWm; ++w)
        if (w < Wm) wt += __popc(sr[w] ^ ca[w] ^ cb[w]);
      const unsigned long long key = ((unsigned long long)wt << 32) | (unsigned)(1 + n + q);
      key_min = key < key_min ? key : key_min;
    }
    const int rank_id = (int)(__shfl_sync(kFull, warp_min(key_min), 0) & 0xffffffffull);
    if (rank_id >= 1 && rank_id <= n) {
      bt1 = rank_id - 1;
    } else if (rank_id > n) {
      const int q = rank_id - 1 - n;
      bt1 = tcol[pairs[2 * q]];
      bt2 = tcol[pairs[2 * q + 1]];
    }
  }
  if (lane < Wm) {
    uint32_t x = s[lane];
    if (bt1 >= 0) x ^= cols[(size_t)bt1 * Wp + lane];
    if (bt2 >= 0) x ^= cols[(size_t)bt2 * Wp + lane];
    best[lane] = x;
  }
  __syncwarp();

  // ---- 5. osd0 / osdw in original coordinates ----
  for (int t = lane; t < n; t += 32) {
    const int p = prow[t];
    uint8_t v0 = 0, vw;
    if (p >= 0) {
      v0 = bit_at(s, p);
      vw = bit_at(best, p);
    } else {
      vw = t == bt1 || t == bt2;
    }
    o0[pm[t]] = v0;
    ow[pm[t]] = vw;
  }
}

using WarpKernel = void (*)(const int32_t*, const int32_t*, const uint8_t*, const uint8_t*,
                            const int32_t*, uint8_t*, uint8_t*, int, int, int, int, int, int,
                            int, int);

WarpKernel warp_kernel(int Wm) {
  return Wm <= 8 ? osd_cs_warp_kernel<8> : osd_cs_warp_kernel<32>;
}

constexpr int kSmemLimit = 232448;  // shared memory a block may use on Hopper

}  // namespace

// K3's block (the block-per-sample layout).
extern "C" size_t osd_cs_smem_bytes(int m, int n, int W, int Wm, int lam) {
  return 8 * (size_t)kWarps +
         4 * ((size_t)(n + 1) * Wm + (size_t)m * W + 2 * (size_t)n +
              (lam > 0 ? lam : 1) + 3 * (size_t)Wm + 4);
}

// K2's block of `warps` samples: the column-packed H once, then each warp's
// columns, pivot rows, T columns and best residual.
extern "C" size_t osd_cs_warp_smem_bytes(int n, int Wm, int lam, int warps) {
  return 4 * ((size_t)n * pair_words(Wm) + (size_t)warps * warp_words(n, Wm, lam));
}

// K2's launch for B rows: out = {warps a block, blocks an SM, grid, dynamic
// shared memory bytes, registers a thread}.  Returns 0, or
// cudaErrorInvalidValue for a shape K2 does not take (Wm > 32, or one warp's
// block above the shared memory), or the CUDA error of a query.
extern "C" int osd_cs_plan(int B, int m, int n, int lam, int* out) {
  const int Wm = (m + 31) / 32;
  if (Wm > 32 || n <= 0) return (int)cudaErrorInvalidValue;
  WarpKernel kernel = warp_kernel(Wm);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long per_warp = 4 * (long long)warp_words(n, Wm, lam);
  long long warps =
      (kSmemLimit - 4LL * n * pair_words(Wm) - (long long)attr.sharedSizeBytes) / per_warp;
  if (warps > attr.maxThreadsPerBlock / 32) warps = attr.maxThreadsPerBlock / 32;
  const long long spread = ((long long)B + sms - 1) / sms;  // rows over every SM
  if (warps > spread) warps = spread;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)osd_cs_warp_smem_bytes(n, Wm, lam, (int)warps);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, (int)warps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = (int)warps;
  out[1] = per_sm;
  out[2] = (int)(((long long)B + warps - 1) / warps);
  out[3] = smem;
  out[4] = attr.numRegs;
  return 0;
}

// K2: osd_cs (osd0 with sweep = 0) on `h_cols` [n, Wm], the column-packed
// H.  Launches on `stream`; returns cudaGetLastError() of the launch, or the
// error of osd_cs_plan.
extern "C" int osd_cs_launch(const void* h_cols, const void* perm, const void* synd,
                             const void* skip, const void* pairs, void* e0, void* ew,
                             int B, int m, int n, int rank, int lam, int n_pairs, int sweep,
                             void* stream) {
  int plan[5];
  const int err = osd_cs_plan(B, m, n, lam, plan);
  if (err != 0) return err;
  const int Wm = (m + 31) / 32;
  warp_kernel(Wm)<<<plan[2], plan[0] * 32, plan[3], (cudaStream_t)stream>>>(
      (const int32_t*)h_cols, (const int32_t*)perm, (const uint8_t*)synd,
      (const uint8_t*)skip, (const int32_t*)pairs, (uint8_t*)e0, (uint8_t*)ew, B, m, n, Wm,
      rank, lam, n_pairs, sweep);
  return (int)cudaGetLastError();
}

// K3: osd_e over the 2^lam patterns of the first 1 <= lam <= 16 T columns;
// needs Wm <= 32.  Launches on `stream`; returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int osd_e_launch(const void* h_packed, const void* perm, const void* synd,
                            const void* skip, void* e0, void* ew, int B, int m, int n, int W,
                            int Wm, int rank, int lam, void* stream) {
  if (lam < 1 || lam > 16 || Wm > 32) return (int)cudaErrorInvalidValue;
  const size_t smem = osd_cs_smem_bytes(m, n, W, Wm, lam);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(osd_e_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  osd_e_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)h_packed, (const int32_t*)perm, (const uint8_t*)synd,
      (const uint8_t*)skip, (uint8_t*)e0, (uint8_t*)ew, m, n, W, Wm, rank, lam);
  return (int)cudaGetLastError();
}
