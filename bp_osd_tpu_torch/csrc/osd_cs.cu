// osd_cs.cu -- ordered-statistics decoding with the combination sweep (K2)
// or the exhaustive search (K3), and the GF(2) elimination alone (K4's warp
// kernel), one warp per sample, several samples a block sharing one copy of
// H.
//
// Replaces the TPU kernel bp_osd_tpu/ops/pallas_osd.py:_osd_kernel with
// mode="cs" (K2, entry osd_cs_launch) and mode="e" (K3, entry osd_e_launch),
// together with its matrix-unit pre-pass _permuted_packed_h.  The plain
// torch version is bp_osd_tpu_torch/decoder/osd.py:osd_decode_plain; both
// kernels agree with it bit for bit.
//
// K4 (entry gf2_elim_warp_launch) replaces the TPU kernel
// bp_osd_tpu/ops/pallas_gf2.py:_elim_kernel on every code whose warp layout
// fits a block's shared memory (the flagship's default osd0 decode); its
// plain version is decoder/osd.py:eliminate_plain, whose five outputs it
// gives bit for bit (h_work, the fully reduced H row-packed in original
// column order; s_work; pivot_ids and pivot_rows in the order found;
// pivot_mask; zeros on skipped rows).  What bounds it on an H100: integer
// operations (~1.3e5 a flagship row for the elimination's needed work) along
// a chain of ~200-250 dependent column steps a row, and the ~10 KB of h_work
// a row it must write.  The first K4 (gf2_elim.cu, kept for codes above
// this layout) ran a 256-thread block per sample: a row scan and two block
// barriers a pivot step, and each warp walking its hit rows one after
// another.  Here the chain runs in one warp with no block barrier: the
// elimination is K2's warp_eliminate (column-major, every column updated,
// so a pivot column ends as the unit vector of its row), many samples a
// block hide each other's step latency, and the write-out is warp-wide:
// lane j of a 32-column word w takes the column that original column
// 32 w + j went to (an inverse of perm, int16 in the warp's slice), each
// 32 x 32 bit tile is transposed in registers by five shuffle steps, and
// lane i stores row 32 rw + i's word; the pivot lists come from prow by a
// ballot prefix count.
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
//   4. (K2) the sweep scores the zero pattern, weight 1 on every non-pivot
//      column (T, in reliability order) and weight 2 on the lexicographic
//      pairs of the first lam T columns by popcount of the residual
//      syndrome; the key (weight << 32 | candidate rank) makes the minimum
//      the first minimum in candidate order;
//   4e. (K3, in place of 4) the walk over all 2^lam patterns on the first
//      lam <= 16 T columns: the patterns are split into 32 contiguous ranges
//      of the Gray-code sequence, one per lane; a lane seeds its residual
//      s ^ XOR(T_j for the bits j of gray(start)) and then XORs one T column
//      per step (gray(i) and gray(i-1) differ in bit ctz(i)).  The key
//      (popcount(residual) + popcount(g)) << 32 | g, with g = gray(i) the
//      pattern, makes the warp's minimum the first minimum in pattern
//      counting order, as in the JAX package.  The residual stays in
//      registers (8 or 32 words, so m <= 1024);
//   5. osd0 and osdw are scattered to original coordinates through perm.
// Weights count every row; the non-pivot rows of a reduced column are zero,
// so this adds the same constant to every candidate as the JAX package's
// pivot-row weights and picks the same winner.
//
// What bounds them on an H100: integer work, ~3-5e5 operations a flagship
// row (the elimination's ~rank steps, each a bit test on n + 1 columns and
// Wm word XORs into the hit ones; K2's 1262 candidates of Wm popcounts at
// order 42, K3's 2^lam patterns of Wm XORs and popcounts), a few hundred KB
// of device-memory traffic for a whole batch.  The first design (one
// 256-thread block per sample) spent it on synchronisation: two block
// barriers a pivot step (~384 a row) around ~1.6 columns of work a thread,
// a serial pivot search in warp 0, a bit-by-bit gather of every column from
// the row-packed H, and a copy of H in every block.  Now a warp owns a
// sample and a block holds several: the elimination (warp_eliminate, shared
// by K2 and K3) runs with no block barrier (ballot for the pivot, the pivot
// column broadcast into every lane's registers by shuffles, the n + 1
// columns spread over the 32 lanes, __syncwarp between steps), and the
// block's one copy of the column-packed H ([n, Wm] words from
// TannerGraph.H_cols) makes step 1 a copy of Wm-word columns by perm.  K3's
// walk then gives each lane 2^lam / 32 patterns (128 at order 12, 2048 at
// order 16).  A skip sample writes zeros and returns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;  // shared memory a block may use on Hopper

__device__ __forceinline__ unsigned long long warp_min(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long y = __shfl_down_sync(kFull, x, off);
    x = y < x ? y : x;
  }
  return x;
}

// Words of a column in shared memory: Wm rounded up to even, so that a
// column is read and XORed as 64-bit pairs.
__host__ __device__ inline int pair_words(int Wm) { return (Wm + 1) & ~1; }

// `inv`: K4's warp also keeps the inverse of perm (n int16).
__host__ __device__ inline size_t warp_words(int n, int Wm, int lam, bool inv = false) {
  // columns (n + 1) x pair_words, pivot rows as int16, T columns, best
  // residual, [inverse perm]; even, so that the next warp's columns stay
  // 8-byte aligned
  const size_t w = (size_t)(n + 1) * pair_words(Wm) + (n + 1) / 2 + (lam > 0 ? lam : 1) + Wm +
                   (inv ? (n + 1) / 2 : 0);
  return (w + 1) & ~(size_t)1;
}

// A block of `warps` samples: the column-packed H once, then each warp's
// slice (mode 2, K4's warp kernel, with the inverse perm and lam = 0).
__host__ __device__ inline size_t block_words(int n, int Wm, int lam, int mode, int warps) {
  return (size_t)n * pair_words(Wm) +
         (size_t)warps * warp_words(n, Wm, mode == 2 ? 0 : lam, mode == 2);
}

__device__ __forceinline__ uint32_t bit_at(const uint32_t* x, int p) {
  return (x[p >> 5] >> (p & 31)) & 1u;
}

// One warp's sample in shared memory: its columns, pivot rows, T columns,
// best residual and (K4) the inverse perm.
struct WarpSample {
  uint32_t* cols;  // [n + 1][Wp], the syndrome as column n
  int16_t* prow;   // [n]
  int32_t* tcol;   // [max(lam, 1)]
  uint32_t* best;  // [Wm]
  int16_t* inv;    // [n], K4 only: inv[perm[t]] = t
};

__device__ __forceinline__ WarpSample warp_sample(uint32_t* s_h, int warp, int n, int Wm,
                                                  int lam, bool inv = false) {
  const int Wp = pair_words(Wm);
  WarpSample ws;
  ws.cols = s_h + (size_t)n * Wp + warp * warp_words(n, Wm, lam, inv);
  ws.prow = reinterpret_cast<int16_t*>(ws.cols + (size_t)(n + 1) * Wp);
  ws.tcol = reinterpret_cast<int32_t*>(ws.cols + (size_t)(n + 1) * Wp + (n + 1) / 2);
  ws.best = reinterpret_cast<uint32_t*>(ws.tcol + (lam > 0 ? lam : 1));
  ws.inv = reinterpret_cast<int16_t*>(ws.best + Wm);
  return ws;
}

// The block's copy of the column-packed H, [n][Wp] words (odd Wm padded).
__device__ __forceinline__ void load_h(uint32_t* s_h, const int32_t* __restrict__ h_cols,
                                       int n, int Wm) {
  const int Wp = pair_words(Wm);
  for (int i = threadIdx.x; i < n * Wp; i += blockDim.x) {
    const int c = i / Wp, w = i - c * Wp;
    s_h[i] = w < Wm ? (uint32_t)h_cols[c * Wm + w] : 0u;
  }
  __syncthreads();
}

// Steps 1-2 and the T collection of one warp's sample (K2 and K3): the
// columns by perm from the block's H, the syndrome, the Gauss-Jordan with no
// block barrier, then the first lam non-pivot columns in reliability order.
// kWm >= Wm: words a column keeps in registers (the pivot column).
template <int kWm>
__device__ __forceinline__ void warp_eliminate(const uint32_t* s_h, const WarpSample& ws,
                                               const int32_t* pm, const uint8_t* sy, int m,
                                               int n, int Wm, int rank, int lam, int lane) {
  const int Wp = pair_words(Wm);
  const int P = Wp / 2;  // 64-bit words a column
  uint32_t* cols = ws.cols;

  // ---- 1. column t = H[:, perm[t]]; the syndrome as column n ----
  for (int t = lane; t < n; t += 32) {
    const uint2* src = reinterpret_cast<const uint2*>(s_h + (size_t)pm[t] * Wp);
    uint2* dst = reinterpret_cast<uint2*>(cols + (size_t)t * Wp);
    for (int w = 0; w < P; ++w) dst[w] = src[w];
    ws.prow[t] = -1;
  }
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
    if (lane == 0) ws.prow[t] = (int16_t)(pw * 32 + pb);
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
    const bool is_t = t < n && ws.prow[t] < 0;
    const unsigned mask = __ballot_sync(kFull, is_t);
    const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
    if (is_t && pos < lam) ws.tcol[pos] = t;
    cnt += __popc(mask);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// K2: the combination sweep.

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
  load_h(smem32, h_cols, n, Wm);

  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  uint8_t* o0 = e0 + (size_t)b * n;
  uint8_t* ow = ew + (size_t)b * n;
  if (skip && skip[b]) {
    for (int t = lane; t < n; t += 32) o0[t] = ow[t] = 0;
    return;
  }
  const WarpSample ws = warp_sample(smem32, warp, n, Wm, lam);
  const int32_t* pm = perm + (size_t)b * n;
  warp_eliminate<kWm>(smem32, ws, pm, synd + (size_t)b * m, m, n, Wm, rank, lam, lane);
  const uint32_t* cols = ws.cols;
  const int16_t* prow = ws.prow;
  const int32_t* tcol = ws.tcol;

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
    ws.best[lane] = x;
  }
  __syncwarp();

  // ---- 5. osd0 / osdw in original coordinates ----
  for (int t = lane; t < n; t += 32) {
    const int p = prow[t];
    uint8_t v0 = 0, vw;
    if (p >= 0) {
      v0 = bit_at(s, p);
      vw = bit_at(ws.best, p);
    } else {
      vw = t == bt1 || t == bt2;
    }
    o0[pm[t]] = v0;
    ow[pm[t]] = vw;
  }
}

// ---------------------------------------------------------------------------
// K3: the Gray-code walk, on the warp's own sample.

// A lane's walk over the patterns [lo, hi) of the Gray-code sequence on the
// T columns `tcol` of `cols` (stride Wp); returns the least key of the
// range.  kWm >= Wm words of residual in registers.
template <int kWm>
__device__ unsigned long long gray_walk(const uint32_t* s, const uint32_t* cols,
                                        const int32_t* tcol, int Wm, int Wp, int lo, int hi) {
  if (lo >= hi) return ~0ull;  // an idle lane (2^lam < 32); gray(lo) may name T_lam
  uint32_t res[kWm];
#pragma unroll
  for (int w = 0; w < kWm; ++w) res[w] = w < Wm ? s[w] : 0u;
  for (unsigned g = lo ^ (lo >> 1); g; g &= g - 1) {
    const uint32_t* col = cols + (size_t)tcol[__ffs(g) - 1] * Wp;
#pragma unroll
    for (int w = 0; w < kWm; ++w)
      if (w < Wm) res[w] ^= col[w];
  }
  unsigned long long best = ~0ull;
  for (int i = lo; i < hi; ++i) {
    if (i > lo) {
      const uint32_t* col = cols + (size_t)tcol[__ffs(i) - 1] * Wp;
#pragma unroll
      for (int w = 0; w < kWm; ++w)
        if (w < Wm) res[w] ^= col[w];
    }
    const unsigned g = i ^ (i >> 1);
    int wt = __popc(g);
#pragma unroll
    for (int w = 0; w < kWm; ++w)
      if (w < Wm) wt += __popc(res[w]);
    const unsigned long long key = ((unsigned long long)wt << 32) | g;
    best = key < best ? key : best;
  }
  return best;
}

template <int kWm>
__global__ void osd_e_warp_kernel(const int32_t* __restrict__ h_cols,
                                  const int32_t* __restrict__ perm,
                                  const uint8_t* __restrict__ synd,
                                  const uint8_t* __restrict__ skip, const int32_t* /*pairs*/,
                                  uint8_t* __restrict__ e0, uint8_t* __restrict__ ew, int B,
                                  int m, int n, int Wm, int rank, int lam, int /*n_pairs*/,
                                  int /*sweep*/) {
  extern __shared__ uint32_t smem32[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int Wp = pair_words(Wm);
  load_h(smem32, h_cols, n, Wm);

  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  uint8_t* o0 = e0 + (size_t)b * n;
  uint8_t* ow = ew + (size_t)b * n;
  if (skip && skip[b]) {
    for (int t = lane; t < n; t += 32) o0[t] = ow[t] = 0;
    return;
  }
  const WarpSample ws = warp_sample(smem32, warp, n, Wm, lam);
  const int32_t* pm = perm + (size_t)b * n;
  warp_eliminate<kWm>(smem32, ws, pm, synd + (size_t)b * m, m, n, Wm, rank, lam, lane);
  const uint32_t* cols = ws.cols;
  const uint32_t* s = cols + (size_t)n * Wp;

  // ---- 4e. Gray-code walk: the warp's first minimum of the keys ----
  const int C = 1 << lam;
  const int per = (C + 31) / 32;
  const int lo = min(C, lane * per), hi = min(C, lo + per);
  const unsigned long long best = warp_min(gray_walk<kWm>(s, cols, ws.tcol, Wm, Wp, lo, hi));
  const unsigned pattern = (unsigned)(__shfl_sync(kFull, best, 0) & 0xffffffffull);
  if (lane < Wm) {
    uint32_t x = s[lane];
    for (unsigned g = pattern; g; g &= g - 1)
      x ^= cols[(size_t)ws.tcol[__ffs(g) - 1] * Wp + lane];
    ws.best[lane] = x;
  }
  __syncwarp();

  // ---- 5. osd0 / osdw in original coordinates ----
  for (int t = lane; t < n; t += 32) {
    const int p = ws.prow[t];
    uint8_t v0 = 0, vw = 0;
    if (p >= 0) {
      v0 = bit_at(s, p);
      vw = bit_at(ws.best, p);
    } else {
      for (unsigned g = pattern; g; g &= g - 1) vw |= t == ws.tcol[__ffs(g) - 1];
    }
    o0[pm[t]] = v0;
    ow[pm[t]] = vw;
  }
}

// ---------------------------------------------------------------------------
// K4: the elimination alone, with the JAX package's five outputs.

// Lane j holds row j of a 32 x 32 bit tile (bit i = entry (j, i)); returns
// column `lane` of it (bit j = entry (j, lane)).  Five butterfly steps: at
// step s the lanes j and j ^ s swap the s x s blocks off the diagonal.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    // the bits i with (i & s) == 0: 0x0000ffff, 0x00ff00ff, ..., 0x55555555
    const uint32_t lo = kFull / ((1ull << s) + 1);
    const uint32_t y = __shfl_xor_sync(kFull, x, s);
    x = (lane & s) ? (x & ~lo) | ((y & ~lo) >> s) : (x & lo) | ((y & lo) << s);
  }
  return x;
}

template <int kWm>
__global__ void gf2_elim_warp_kernel(const int32_t* __restrict__ h_cols,
                                     const int32_t* __restrict__ perm,
                                     const uint8_t* __restrict__ synd,
                                     const uint8_t* __restrict__ skip,
                                     uint32_t* __restrict__ h_work, int32_t* __restrict__ s_work,
                                     int32_t* __restrict__ pivot_ids,
                                     int32_t* __restrict__ pivot_rows,
                                     uint8_t* __restrict__ pivot_mask, int B, int m, int n,
                                     int Wm, int rank) {
  extern __shared__ uint32_t smem32[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int Wp = pair_words(Wm);
  const int W = (n + 31) / 32;
  load_h(smem32, h_cols, n, Wm);

  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;
  uint32_t* hw = h_work + (size_t)b * m * W;
  int32_t* sw = s_work + (size_t)b * m;
  int32_t* pid = pivot_ids + (size_t)b * rank;
  int32_t* prw = pivot_rows + (size_t)b * rank;
  uint8_t* pmk = pivot_mask + (size_t)b * n;
  if (skip && skip[b]) {
    for (size_t i = lane; i < (size_t)m * W; i += 32) hw[i] = 0u;
    for (int i = lane; i < m; i += 32) sw[i] = 0;
    for (int i = lane; i < rank; i += 32) pid[i] = prw[i] = 0;
    for (int t = lane; t < n; t += 32) pmk[t] = 0;
    return;
  }
  const WarpSample ws = warp_sample(smem32, warp, n, Wm, 0, true);
  const int32_t* pm = perm + (size_t)b * n;
  warp_eliminate<kWm>(smem32, ws, pm, synd + (size_t)b * m, m, n, Wm, rank, 0, lane);
  const uint32_t* cols = ws.cols;

  // ---- the pivots in the order found, the pivot mask, the inverse perm ----
  int cnt = 0;
  for (int base = 0; base < n; base += 32) {
    const int t = base + lane;
    const int p = t < n ? ws.prow[t] : -1;
    const unsigned mask = __ballot_sync(kFull, p >= 0);
    const int pos = cnt + __popc(mask & ((1u << lane) - 1u));
    if (t < n) {
      const int col = pm[t];
      ws.inv[col] = (int16_t)t;
      pmk[t] = p >= 0;
      if (p >= 0 && pos < rank) {
        pid[pos] = col;
        prw[pos] = p;
      }
    }
    cnt += __popc(mask);
  }
  for (int row = lane; row < m; row += 32) sw[row] = (int32_t)bit_at(cols + (size_t)n * Wp, row);
  __syncwarp();

  // ---- h_work: the 32 x 32 tiles of word w, transposed from columns to rows ----
  for (int w = 0; w < W; ++w) {
    const int oc = 32 * w + lane;  // original column; zero beyond n
    const uint32_t* col = oc < n ? cols + (size_t)ws.inv[oc] * Wp : nullptr;
    for (int rw = 0; rw < Wm; ++rw) {
      const uint32_t x = transpose32(col ? col[rw] : 0u, lane);
      const int row = 32 * rw + lane;
      if (row < m) hw[(size_t)row * W + w] = x;
    }
  }
}

using WarpKernel = void (*)(const int32_t*, const int32_t*, const uint8_t*, const uint8_t*,
                            const int32_t*, uint8_t*, uint8_t*, int, int, int, int, int, int,
                            int, int);
using ElimKernel = void (*)(const int32_t*, const int32_t*, const uint8_t*, const uint8_t*,
                            uint32_t*, int32_t*, int32_t*, int32_t*, uint8_t*, int, int, int,
                            int, int);

// mode 0: K2 (osd_cs), mode 1: K3 (osd_e)
WarpKernel warp_kernel(int Wm, int mode) {
  if (mode == 1) return Wm <= 8 ? osd_e_warp_kernel<8> : osd_e_warp_kernel<32>;
  return Wm <= 8 ? osd_cs_warp_kernel<8> : osd_cs_warp_kernel<32>;
}

ElimKernel elim_kernel(int Wm) {
  return Wm <= 8 ? gf2_elim_warp_kernel<8> : gf2_elim_warp_kernel<32>;
}

// mode 2: K4's warp kernel
const void* any_kernel(int Wm, int mode) {
  return mode == 2 ? (const void*)elim_kernel(Wm) : (const void*)warp_kernel(Wm, mode);
}

}  // namespace

// A block of `warps` samples: the column-packed H once, then each warp's
// columns, pivot rows, T columns and best residual (K2 and K3 alike).
extern "C" size_t osd_cs_warp_smem_bytes(int n, int Wm, int lam, int warps) {
  return 4 * block_words(n, Wm, lam, 0, warps);
}

// A block of K4's warp kernel: K2's layout at lam = 0 and the inverse perm.
extern "C" size_t gf2_elim_warp_smem_bytes(int n, int Wm, int warps) {
  return 4 * block_words(n, Wm, 0, 2, warps);
}

// The launch of K2 (mode 0), K3 (mode 1) or K4's warp kernel (mode 2, lam
// ignored) for B rows: out = {warps a block, blocks an SM, grid, dynamic
// shared memory bytes, registers a thread}.  Returns 0, or
// cudaErrorInvalidValue for a shape the kernels do not take (Wm > 32, or
// one warp's block above the shared memory), or the CUDA error of a query.
extern "C" int osd_cs_plan(int B, int m, int n, int lam, int mode, int* out) {
  const int Wm = (m + 31) / 32;
  if (Wm > 32 || n <= 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const void* kernel = any_kernel(Wm, mode);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long h_bytes = 4 * (long long)block_words(n, Wm, lam, mode, 0);
  const long long per_warp = 4 * (long long)block_words(n, Wm, lam, mode, 1) - h_bytes;
  long long warps = (kSmemLimit - h_bytes - (long long)attr.sharedSizeBytes) / per_warp;
  if (warps > attr.maxThreadsPerBlock / 32) warps = attr.maxThreadsPerBlock / 32;
  const long long spread = ((long long)B + sms - 1) / sms;  // rows over every SM
  if (warps > spread) warps = spread;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const int smem = (int)(4 * block_words(n, Wm, lam, mode, (int)warps));
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

namespace {

int launch(int mode, const void* h_cols, const void* perm, const void* synd, const void* skip,
           const void* pairs, void* e0, void* ew, int B, int m, int n, int rank, int lam,
           int n_pairs, int sweep, void* stream) {
  int plan[5];
  const int err = osd_cs_plan(B, m, n, lam, mode, plan);
  if (err != 0) return err;
  const int Wm = (m + 31) / 32;
  warp_kernel(Wm, mode)<<<plan[2], plan[0] * 32, plan[3], (cudaStream_t)stream>>>(
      (const int32_t*)h_cols, (const int32_t*)perm, (const uint8_t*)synd,
      (const uint8_t*)skip, (const int32_t*)pairs, (uint8_t*)e0, (uint8_t*)ew, B, m, n, Wm,
      rank, lam, n_pairs, sweep);
  return (int)cudaGetLastError();
}

}  // namespace

// K2: osd_cs (osd0 with sweep = 0) on `h_cols` [n, Wm], the column-packed
// H.  Launches on `stream`; returns cudaGetLastError() of the launch, or the
// error of osd_cs_plan.
extern "C" int osd_cs_launch(const void* h_cols, const void* perm, const void* synd,
                             const void* skip, const void* pairs, void* e0, void* ew,
                             int B, int m, int n, int rank, int lam, int n_pairs, int sweep,
                             void* stream) {
  return launch(0, h_cols, perm, synd, skip, pairs, e0, ew, B, m, n, rank, lam, n_pairs, sweep,
                stream);
}

// K3: osd_e over the 2^lam patterns of the first 1 <= lam <= 16 T columns,
// on `h_cols` as K2.  Launches on `stream`; returns cudaGetLastError() of
// the launch, cudaErrorInvalidValue for lam outside [1, 16], or the error of
// osd_cs_plan.
extern "C" int osd_e_launch(const void* h_cols, const void* perm, const void* synd,
                            const void* skip, void* e0, void* ew, int B, int m, int n, int rank,
                            int lam, void* stream) {
  if (lam < 1 || lam > 16) return (int)cudaErrorInvalidValue;
  return launch(1, h_cols, perm, synd, skip, nullptr, e0, ew, B, m, n, rank, lam, 0, 0, stream);
}

// K4's warp kernel: the elimination of B rows in the column orders `perm`
// on `h_cols` as K2, the five outputs given at the chunk's first row
// (h_work [B, m, ceil(n/32)] uint32, s_work [B, m] and pivot_ids /
// pivot_rows [B, rank] int32, pivot_mask [B, n] bytes).  Launches on
// `stream`; returns cudaGetLastError() of the launch, or the error of
// osd_cs_plan.
extern "C" int gf2_elim_warp_launch(const void* h_cols, const void* perm, const void* synd,
                                    const void* skip, void* h_work, void* s_work,
                                    void* pivot_ids, void* pivot_rows, void* pivot_mask, int B,
                                    int m, int n, int rank, void* stream) {
  int plan[5];
  const int err = osd_cs_plan(B, m, n, 0, 2, plan);
  if (err != 0) return err;
  const int Wm = (m + 31) / 32;
  elim_kernel(Wm)<<<plan[2], plan[0] * 32, plan[3], (cudaStream_t)stream>>>(
      (const int32_t*)h_cols, (const int32_t*)perm, (const uint8_t*)synd, (const uint8_t*)skip,
      (uint32_t*)h_work, (int32_t*)s_work, (int32_t*)pivot_ids, (int32_t*)pivot_rows,
      (uint8_t*)pivot_mask, B, m, n, Wm, rank);
  return (int)cudaGetLastError();
}
