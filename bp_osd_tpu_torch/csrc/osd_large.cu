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
//      column c sits at w * ns + c (word-major; the stride ns is n + 1
//      rounded up to a multiple of four);
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
// What bounds it on an H100: one sample's matrix is (n + 1) * Wm * 4 bytes
// (6.0 MB at the [[10000,420]] code), far above a block's 227 KB of shared
// memory, and a heavy batch's matrices (~129 x 6 MB) far above the 50 MB L2;
// its elimination is a chain of ~n dependent column steps on one SM.  The
// design before this one took each pivot to the later columns at once: two
// block barriers and two or three dependent device-memory round trips a
// pivot, ~9,600 barriers a lift-400 row.  This design is a blocked,
// right-looking Gauss-Jordan with a delayed trailing update:
//   - the elimination walks panels of P <= 32 columns (the wrapper's
//     osd_large_panel).  Warp 0 factorises panel k in its shared-memory
//     buffer with no block barrier: the pivot search in registers, the pivot
//     bit cleared in place (the column is then S_i), S_i XORed into the
//     panel's later columns carrying row r_i, the dependent columns passed
//     over.  It records each of the panel's q pivots: r_i, the column's
//     place, the row L[i] of the bit table L[i][j] = S_j[r_i] (j < i) and,
//     from it, the columns N[j] of (I + L)^-1; at the panel's end, the
//     distinct words of the pivot rows and the words where some S_i is
//     nonzero (the union);
//   - warps 1-31 take a factorised panel to the columns after it in one
//     trailing pass: for column c, cb_i = c[r_i] (the words at the pivot
//     rows, 16-byte loads coalesced across neighbouring columns), g = XOR of
//     N[j] over the bits j of cb, which is g_i = cb_i ^ parity(g & L[i]) in
//     pivot order, then c ^= XOR of the S_i with g_i = 1.  That is the
//     per-pivot sequence exactly: XOR commutes, and whether c takes S_i
//     depends only on c's bit r_i after the earlier S_j.  A column that
//     takes one S_i gets its nonzero words, one that takes more the union's
//     words where they are nonzero, merged, each word XORed once by a
//     red.global.xor, which the L2 applies while the warp goes on;
//   - look-ahead: panel j lives in buffer j % 3.  While warp 0 factorises
//     panel k, the workers write panel k - 1 back, load panel k + 1
//     (cp.async), take panel k - 1 to the columns after panel k + 1 in device
//     memory (chunks of kChunk columns: the hits at the pivot rows, each hit
//     column's g, the XORs; named barriers among the workers only) and take
//     panel k + 1 past panel k - 1 in shared memory.  After the barrier every
//     warp takes a column of panel k + 1 past panel k; after a second,
//     warp 0 goes on to panel k + 1.  So a panel costs two block barriers.
//     The records of two panels are kept (by the panel's parity), and S_i is
//     read from panel k's buffer until panel k + 3 replaces it.
// Lift 400, panels of 32 (NVIDIA H100 80GB HBM3, 700 W; the design before
// in the same calls): a lone BP-failing row 5.7 ms at p = 0.028 (11.5) and
// 6.3 ms at p = 0.005 (12.7), 8 rows 7.9 ms (15.1), 129 rows 15.2 ms (25.6);
// ~281 trailing passes a row for 4,790 pivots.  Warp 0's chain takes most
// of a lone row (~250 cycles a column step, ~1,200 a pivot with its panel
// updates, slower while warps 1-31 issue on its scheduler); 129 rows move
// ~2.5 TB/s of device memory.
// Shared memory: the three panel buffers (column-major, odd stride: one word
// of every panel column is read without bank conflicts), two panel records,
// the syndromes, a chunk's hit bits and g, two chunks' hit lists, the T
// columns and the pivot row of each column (int16, so m and n are below
// 32768).  A skip sample writes zeros and returns.  While the profiler's
// recorder is on, each block adds its pivots and its trailing passes to
// `stats` (one atomic each).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWorkWarps = kWarps - 1;  // warps 1-31 make the trailing passes
constexpr int kWorkers = 32 * kWorkWarps;
constexpr int kMaxPanel = 32;  // a panel's pivots are the bits of a 32-bit word
constexpr int kChunk = 4096;   // columns a trailing pass takes at once
constexpr int kScan = 4;       // 16-byte loads of pivot-row words a worker issues at once

__host__ __device__ inline int panel_stride(int Wm) { return Wm | 1; }

// words between word w and word w + 1 of a column in the scratch: n + 1
// columns rounded up to a multiple of four, so four neighbouring columns
// from a multiple of four are one aligned 16-byte load
__host__ __device__ inline int scratch_stride(int n) { return (n + 4) & ~3; }

// words of one panel record: N, tc, pw, pm, cnt [P], Unz, Uw [Wm], the
// header {q, D, nU, -}, piv [P][32] bytes and Sidx [P][Wm] int16
__host__ __device__ inline size_t record_words(int P, int Wm) {
  return ((size_t)P * Wm + 1) / 2 + 13 * (size_t)P + 2 * (size_t)Wm + 4;
}

// A factorised panel of q <= P pivots, in shared memory: what a trailing
// pass needs to bring a column past all of them at once.
struct Panel {
  // S_i, pivot column t_i at its step without the pivot bit, is that
  // column of the panel's buffer (warp 0 clears the pivot bit there; a
  // pivot column is never read after the elimination): word w at
  // Sb[tc[i] * Wp + w]
  const uint32_t* Sb;
  int Wp;
  int32_t* tc;     // [q] the pivot columns' places in the panel
  // [q] column j of (I + L)^-1, L[i][j] = S_j[r_i] (j < i): g = XOR of N[j]
  // over the bits j of cb
  uint32_t* N;
  int32_t* pw;     // [D] the distinct words of the pivot rows
  uint32_t* pm;    // [D] the pivot-row bits of each
  int32_t* cnt;    // [q] nonzero words of S_i (the workers' lists)
  uint32_t* Unz;   // [nU] for each word of the union of the S_i: which S_i are nonzero there
  int32_t* Uw;     // [nU] the union's words
  int32_t* hdr;    // q, D, nU
  uint8_t* piv;    // [D][32] the pivot index of bit b of distinct word d
  int16_t* Sidx;   // [q][Wm] the nonzero words of S_i (the workers' lists)
};

__device__ __forceinline__ Panel panel_at(uint32_t* base, const uint32_t* Sb, int P, int Wm) {
  Panel R;
  R.Sb = Sb;
  R.Wp = panel_stride(Wm);
  R.N = base;
  R.tc = reinterpret_cast<int32_t*>(R.N + P);
  R.pw = R.tc + P;
  R.pm = reinterpret_cast<uint32_t*>(R.pw + P);
  R.cnt = reinterpret_cast<int32_t*>(R.pm + P);
  R.Unz = reinterpret_cast<uint32_t*>(R.cnt + P);
  R.Uw = reinterpret_cast<int32_t*>(R.Unz + Wm);
  R.hdr = R.Uw + Wm;
  R.piv = reinterpret_cast<uint8_t*>(R.hdr + 4);
  R.Sidx = reinterpret_cast<int16_t*>(R.piv + 32 * (size_t)P);
  return R;
}

// the pivot indices (bits of the result) of the pivot-row bits x of distinct word d
__device__ __forceinline__ uint32_t pivot_bits(uint32_t x, const uint8_t* piv_d) {
  uint32_t cb = 0u;
  for (; x; x &= x - 1u) cb |= 1u << piv_d[__ffs(x) - 1];
  return cb;
}

// g from cb, a column's bits at the pivot rows before the panel: the
// pivots whose S the column takes in turn, g_i = cb_i ^ parity(g & L[i])
__device__ __forceinline__ uint32_t g_of(uint32_t cb, const uint32_t* N) {
  uint32_t g = 0u;
  for (; cb; cb &= cb - 1u) g ^= N[__ffs(cb) - 1];
  return g;
}

// XOR of the S_i that gm selects, at word w
__device__ __forceinline__ uint32_t s_word(const Panel& R, uint32_t gm, int w) {
  uint32_t x = 0u;
  for (; gm; gm &= gm - 1u) x ^= R.Sb[(size_t)R.tc[__ffs(gm) - 1] * R.Wp + w];
  return x;
}

__device__ __forceinline__ void cp_async4(uint32_t* smem, const uint32_t* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void workers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWorkers) : "memory");
}

// a fire-and-forget XOR into device memory (done in the L2)
__device__ __forceinline__ void red_xor(uint32_t* p, uint32_t v) {
  asm volatile("red.global.xor.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long x) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long y = __shfl_down_sync(kFull, x, off);
    x = y < x ? y : x;
  }
  return x;
}

// word w of column c in the word-major scratch of stride ns
__device__ __forceinline__ size_t at(int c, int w, int ns) { return (size_t)w * ns + c; }

// kLW >= ceil(Wm / 32): words of a column each lane of warp 0 keeps in
// registers for the pivot search, with the used-row mask (5: m <= 5120, the
// [[10000,420]] code; 8: m <= 8192; 32: m < 32768, which spills).  Every
// thread holds them, so they share the 64 registers a 1024-thread block
// allows with the workers' loads in flight.
template <int kLW>
__global__ void __launch_bounds__(kThreads)
osd_large_kernel(const int32_t* __restrict__ h_cols, const int32_t* __restrict__ perm,
                 const uint8_t* __restrict__ synd, const uint8_t* __restrict__ skip,
                 const int32_t* __restrict__ pairs, uint32_t* scratch,
                 uint8_t* __restrict__ e0, uint8_t* __restrict__ ew, int row0, int m, int n,
                 int Wm, int rank, int lam, int n_pairs, int sweep, int P,
                 unsigned long long* stats) {
  const int b = row0 + blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ww = warp - 1;      // a worker's warp index
  const int wid = 32 * ww + lane;  // a worker's index
  const unsigned lt_mask = (1u << lane) - 1u;

  if (skip && skip[b]) {
    for (int v = tid; v < n; v += kThreads) {
      e0[(size_t)b * n + v] = 0;
      ew[(size_t)b * n + v] = 0;
    }
    return;
  }

  const int n1 = n + 1;
  const int ns = scratch_stride(n);
  const int Wp = panel_stride(Wm);
  uint32_t* M = scratch + (size_t)blockIdx.x * ns * Wm;
  const int32_t* pb = perm + (size_t)b * n;

  extern __shared__ unsigned long long smem64[];
  unsigned long long* s_red = smem64;                               // [kWarps]
  uint32_t* s_panel = reinterpret_cast<uint32_t*>(s_red + kWarps);  // [3][P][Wp]
  uint32_t* s_rec = s_panel + 3 * (size_t)P * Wp;                   // [2][record_words]
  uint32_t* s_syn = s_rec + 2 * record_words(P, Wm);                // [Wm]
  uint32_t* s_best = s_syn + Wm;                                    // [Wm]
  uint32_t* s_cb = s_best + Wm;                                     // [kChunk]
  uint32_t* s_hg = s_cb + kChunk;                                   // [kChunk]
  int32_t* s_tcol = reinterpret_cast<int32_t*>(s_hg + kChunk);      // [max(lam, 1)]
  int32_t* s_misc = s_tcol + (lam > 0 ? lam : 1);                   // [4]
  int16_t* s_hc = reinterpret_cast<int16_t*>(s_misc + 4);           // [2][kChunk]
  int16_t* s_prow = s_hc + 2 * kChunk;                              // [n]
  // s_misc: the done flag, then the hit counts of two chunks by parity

  auto slot = [&](int c) {  // column c of the window: panel c / P in buffer (c / P) % 3
    return s_panel + ((size_t)((c / P) % 3) * P + c % P) * Wp;
  };
  auto record = [&](int k) {  // panel k's record; its S_i are in panel k's buffer
    return panel_at(s_rec + (k & 1) * record_words(P, Wm), s_panel + (size_t)(k % 3) * P * Wp, P,
                    Wm);
  };

  // ---- 1. column-permuted, row-packed matrix; syndrome as column n ----
  // a warp writes 32 neighbouring columns, word by word
  for (int c0 = warp * 32; c0 < n; c0 += kThreads) {
    const int c = c0 + lane;
    if (c < n) {
      const int32_t* src = h_cols + (size_t)pb[c] * Wm;
      for (int w = 0; w < Wm; ++w) M[at(c, w, ns)] = (uint32_t)__ldg(src + w);
    }
  }
  for (int w = tid; w < Wm; w += kThreads) {
    uint32_t word = 0u;
    for (int bit = 0; bit < 32; ++bit) {
      const int row = w * 32 + bit;
      if (row < m) word |= (uint32_t)(synd[(size_t)b * m + row] & 1) << bit;
    }
    M[at(n, w, ns)] = word;
  }
  for (int t = tid; t < n; t += kThreads) s_prow[t] = -1;
  for (int i = tid; i < kChunk; i += kThreads) s_cb[i] = 0u;
  if (tid == 0) s_misc[1] = 0;
  __syncthreads();
  // Element e of a panel is column e % P, word e / P: neighbouring threads
  // take neighbouring columns (coalesced in the word-major layout).
  for (int i = tid; i < P * Wm; i += kThreads) {
    const int c = i % P, w = i / P;
    if (c < n) slot(c)[w] = M[at(c, w, ns)];
  }
  __syncthreads();

  // panel j's columns in shared memory past panel R's pivots: a warp a
  // column (helper warp hw of nw), g from the words at the pivot rows, then
  // the union's words
  auto panel_apply = [&](const Panel& R, int j, int hw, int nw) {
    const int D = R.hdr[1], nU = R.hdr[2];
    for (int jj = hw; jj < P; jj += nw) {
      const int c = j * P + jj;
      if (c >= n) break;
      uint32_t* col = slot(c);
      uint32_t cb = 0u;
      if (lane < D) cb = pivot_bits(col[R.pw[lane]] & R.pm[lane], R.piv + 32 * lane);
      cb = __reduce_or_sync(kFull, cb);
      if (cb == 0u) continue;
      const uint32_t g = g_of(cb, R.N);
      for (int u0 = lane; u0 < nU; u0 += 128) {  // four union words a lane at once
        uint32_t x[4], v[4];
        int w[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int u = u0 + 32 * s;
          const uint32_t gm = u < nU ? g & R.Unz[u] : 0u;
          w[s] = u < nU ? R.Uw[u] : 0;
          x[s] = gm ? s_word(R, gm, w[s]) : 0u;
          v[s] = x[s] ? col[w[s]] : 0u;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (x[s]) col[w[s]] = v[s] ^ x[s];
      }
    }
  };

  // ---- the trailing pass of panel R over columns [cstart, n] in device
  // memory (workers): chunks of kChunk columns, each in three steps ----
  int chunk = 0;  // chunks passed so far (the parity of the hit list)
  auto trailing_pass = [&](const Panel& R, int cstart) {
    const int q = R.hdr[0], D = R.hdr[1], nU = R.hdr[2];
    // the nonzero words of each S_i, for the hit columns that take one S_i
    // (a warp a pivot)
    for (int i = ww; i < q; i += kWorkWarps) {
      int cnt = 0;
      for (int u0 = 0; u0 < nU; u0 += 32) {
        const int u = u0 + lane;
        const bool has = u < nU && ((R.Unz[u] >> i) & 1u);
        const unsigned mk = __ballot_sync(kFull, has);
        if (has) R.Sidx[(size_t)i * Wm + cnt + __popc(mk & lt_mask)] = (int16_t)R.Uw[u];
        cnt += __popc(mk);
      }
      if (lane == 0) R.cnt[i] = cnt;
    }
    for (int c0 = cstart & ~3; c0 <= n; c0 += kChunk, ++chunk) {
      const int C = min(kChunk, n1 - c0);  // columns c0 + c, c < C; those before cstart stay
      const int G = (C + 3) >> 2;          // groups of four columns
      int32_t* count = s_misc + 1 + (chunk & 1);
      int16_t* hc = s_hc + (chunk & 1) * kChunk;
      // (a) each column's words at the pivot rows: item (four columns,
      // distinct word), columns fastest, so a warp reads a coalesced run of
      // one word, 16 bytes a thread; a column's pivot bits gather in s_cb,
      // and the first hit lists the column
      {
        const int dd = kWorkers / G, dg = kWorkers - dd * G;
        int d = wid / G, g = wid - d * G;
        while (d < D) {
          uint4 x[kScan];
          int key[kScan];
#pragma unroll
          for (int u = 0; u < kScan; ++u) {
            key[u] = d < D ? g | d << 16 : -1;
            x[u] = d < D ? *reinterpret_cast<const uint4*>(M + at(c0 + 4 * g, R.pw[d], ns))
                         : make_uint4(0u, 0u, 0u, 0u);
            g += dg;
            d += dd;
            if (g >= G) {
              g -= G;
              ++d;
            }
          }
#pragma unroll
          for (int u = 0; u < kScan; ++u) {
            if (key[u] < 0) continue;
            const int dk = key[u] >> 16, c4 = 4 * (key[u] & 0xffff);
            const uint32_t pm = R.pm[dk];
            const uint32_t hit[4] = {x[u].x & pm, x[u].y & pm, x[u].z & pm, x[u].w & pm};
            if ((hit[0] | hit[1] | hit[2] | hit[3]) == 0u) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (hit[j] && c4 + j < C && c0 + c4 + j >= cstart) {
                const uint32_t old = atomicOr(&s_cb[c4 + j], pivot_bits(hit[j], R.piv + 32 * dk));
                if (old == 0u) hc[atomicAdd(count, 1)] = (int16_t)(c0 + c4 + j);
              }
          }
        }
      }
      workers_sync();
      // (b) each listed column's g
      if (wid == 0) s_misc[1 + ((chunk + 1) & 1)] = 0;
      const int nh = *count;
      for (int h = wid; h < nh; h += kWorkers) {
        const int c = hc[h] - c0;
        s_hg[h] = g_of(s_cb[c], R.N);
        s_cb[c] = 0u;
      }
      workers_sync();
      // (c) the S_i each listed column takes, XORed in device memory with
      // no wait: a warp a column; one S_i: its nonzero words; more: the
      // union's words where they are nonzero, merged
      for (int h = ww; h < nh; h += kWorkWarps) {
        const uint32_t g = s_hg[h];
        uint32_t* col = M + hc[h];
        if ((g & (g - 1u)) == 0u) {
          const int i = __ffs(g) - 1;
          const int16_t* idx = R.Sidx + (size_t)i * Wm;
          const uint32_t* Si = R.Sb + (size_t)R.tc[i] * Wp;
          for (int e = lane; e < R.cnt[i]; e += 32) {
            const int w = idx[e];
            red_xor(col + (size_t)w * ns, Si[w]);
          }
        } else {
          for (int u = lane; u < nU; u += 32) {
            const uint32_t gm = g & R.Unz[u];
            if (gm == 0u) continue;
            const int w = R.Uw[u];
            const uint32_t x = s_word(R, gm, w);
            if (x) red_xor(col + (size_t)w * ns, x);
          }
        }
      }
    }
  };

  // ---- 2. Gauss-Jordan in reliability order, a panel of P columns at a
  // time.  Panel j lives in buffer j % 3.  While warp 0 factorises panel k,
  // the workers write panel k - 1 back, load panel k + 1, take panel k - 1
  // to the columns after panel k + 1 in device memory and take panel k + 1
  // past it; after the barrier every warp takes a column of panel k + 1
  // past panel k, and after a second warp 0 goes on to it ----
  int t = 0;       // warp 0's next column
  int rr = 0;      // warp 0: pivots found
  int passes = 0;  // warp 0: panels with a pivot
  uint32_t used[kLW];  // warp 0, lane l: the pivot rows in words l, l + 32, ...
#pragma unroll
  for (int i = 0; i < kLW; ++i) used[i] = 0u;
  for (int k = 0;; ++k) {
    const Panel R = record(k);
    if (warp == 0) {
      const int k0 = k * P;
      const int tend = min(n, k0 + P);
      uint32_t* buf = s_panel + (size_t)(k % 3) * P * Wp;
      uint32_t nzr[kLW];  // lane l, word l + 32 i: which of the panel's S_i are nonzero there
#pragma unroll
      for (int i = 0; i < kLW; ++i) nzr[i] = 0u;
      // lane j, for the panel's pivot j: its row, its place in the panel and
      // its row of (I + L)^-1 (e_j XOR the rows j' that L[j] names); and
      // column j of (I + L)^-1
      int my_r = 0, my_tc = 0;
      uint32_t my_N = 0u, my_Ncol = 0u;
      int q = 0;
      for (; t < tend && rr < rank; ++t) {
        uint32_t* col = buf + (size_t)(t - k0) * Wp;
        uint32_t cw[kLW];  // the lane's words of column t
#pragma unroll
        for (int i = 0; i < kLW; ++i) cw[i] = lane + 32 * i < Wm ? col[lane + 32 * i] : 0u;
        uint32_t any = 0u;
#pragma unroll
        for (int i = 0; i < kLW; ++i) any |= cw[i] & ~used[i];
        if (!__any_sync(kFull, any != 0u)) continue;  // a dependent column: on to the next
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
        const int pw = __reduce_min_sync(kFull, fw);
        const unsigned src = __ballot_sync(kFull, fw == pw);
        const uint32_t xs = __shfl_sync(kFull, fx, __ffs(src) - 1);
        const int pr = pw * 32 + (__ffs(xs) - 1);
        const uint32_t pbit = 1u << (pr & 31);
        // S_q: column t without the pivot bit, left in the buffer
#pragma unroll
        for (int i = 0; i < kLW; ++i) {
          if (lane + 32 * i == pw) {
            cw[i] &= ~pbit;
            used[i] |= pbit;
            col[pw] = cw[i];
          }
          nzr[i] |= (uint32_t)(cw[i] != 0u) << q;
        }
        // row q of L (the panel's earlier S_j that carry row pr, lanes j),
        // and row q of (I + L)^-1: e_q XOR the rows j that L[q] names
        const bool lbit = lane < q && ((buf[(size_t)my_tc * Wp + pw] >> (pr & 31)) & 1u);
        const unsigned Nq = __reduce_xor_sync(kFull, lbit ? my_N : 0u) ^ (1u << q);
        my_Ncol |= ((Nq >> lane) & 1u) << q;
        if (lane == q) {
          my_r = pr;
          my_tc = t - k0;
          my_N = Nq;
        }
        if (lane == 0) s_prow[t] = (int16_t)pr;
        // the panel's columns after t that carry row pr take S_q now
        for (int c0 = t + 1; c0 < tend; c0 += 32) {
          const int c = c0 + lane;
          unsigned hm =
              __ballot_sync(kFull, c < tend && (buf[(size_t)(c - k0) * Wp + pw] & pbit) != 0u);
          while (hm) {
            uint32_t* hit = buf + (size_t)(c0 + __ffs(hm) - 1 - k0) * Wp;
            hm &= hm - 1u;
#pragma unroll
            for (int i = 0; i < kLW; ++i)
              if (lane + 32 * i < Wm && cw[i]) hit[lane + 32 * i] ^= cw[i];
          }
        }
        __syncwarp();
        ++q;
        ++rr;
      }
      __syncwarp();
      // the record: the pivots, the columns of (I + L)^-1, the distinct words
      // of the pivot rows, and the words where some S_i is nonzero
      const bool has = lane < q;
      if (has) {
        R.tc[lane] = my_tc;
        R.N[lane] = my_Ncol;
      }
      const unsigned grp = __match_any_sync(kFull, has ? my_r >> 5 : -1 - lane);
      const int leader = __ffs(grp) - 1;
      const unsigned leaders = __ballot_sync(kFull, has && leader == lane);
      const int d = __popc(leaders & ((1u << leader) - 1u));
      if (has && leader == lane) {
        R.pw[d] = my_r >> 5;
        R.pm[d] = 0u;
      }
      __syncwarp();
      if (has) {
        atomicOr(&R.pm[d], 1u << (my_r & 31));
        R.piv[32 * d + (my_r & 31)] = (uint8_t)lane;
      }
      int nU = 0;
#pragma unroll
      for (int i = 0; i < kLW; ++i) {
        const int w = lane + 32 * i;
        const uint32_t nz = w < Wm ? nzr[i] : 0u;
        const unsigned mk = __ballot_sync(kFull, nz != 0u);
        if (nz) {
          const int pos = nU + __popc(mk & lt_mask);
          R.Uw[pos] = w;
          R.Unz[pos] = nz;
        }
        nU += __popc(mk);
      }
      if (lane == 0) {
        R.hdr[0] = q;
        R.hdr[1] = __popc(leaders);
        R.hdr[2] = nU;
        s_misc[0] = t >= n || rr >= rank;
      }
      passes += q > 0;
    } else {
      // panel k - 1 back to device memory; panel k + 1 on its way into its
      // buffer (element e: column e % P, word e / P) while panel k - 1 goes
      // to the columns after panel k + 1; then panel k + 1 past panel k - 1
      const uint32_t* prev = s_panel + (size_t)((k + 2) % 3) * P * Wp;
      uint32_t* next = s_panel + (size_t)((k + 1) % 3) * P * Wp;
      const int dw = kWorkers / P, dj = kWorkers - dw * P;
      for (int j = wid % P, w = wid / P; w < Wm;) {
        const int c = (k - 1) * P + j, c2 = (k + 1) * P + j;
        if (k > 0 && c < n) M[at(c, w, ns)] = prev[j * Wp + w];
        if (c2 < n) cp_async4(next + j * Wp + w, M + at(c2, w, ns));
        j += dj;
        w += dw;
        if (j >= P) {
          j -= P;
          ++w;
        }
      }
      const Panel Rp = record(max(k - 1, 0));
      const bool pass = k > 0 && Rp.hdr[0] > 0;
      if (pass) trailing_pass(Rp, min(n, (k + 2) * P));
      cp_async_wait_all();
      if (pass) {
        workers_sync();
        panel_apply(Rp, k + 1, ww, kWorkWarps);
      }
    }
    __syncthreads();
    const bool done = s_misc[0] != 0;
    const int q = R.hdr[0];
    if (q > 0) panel_apply(R, k + 1, warp, kWarps);
    __syncthreads();
    if (done) {
      // panels k and k + 1 back to device memory; panel k to the columns after them
      for (int i = tid; i < 2 * P * Wm; i += kThreads) {
        const int j = i % (2 * P), w = i / (2 * P);
        const int c = k * P + j;
        if (c < n) M[at(c, w, ns)] = slot(c)[w];
      }
      if (warp != 0 && q > 0) trailing_pass(R, min(n, (k + 2) * P));
      __syncthreads();
      break;
    }
  }
  if (stats && tid == 0) {
    atomicAdd(stats, (unsigned long long)rr);
    atomicAdd(stats + 1, (unsigned long long)passes);
  }

  // ---- T: the first lam non-pivot columns, in reliability order ----
  for (int w = tid; w < Wm; w += kThreads) s_syn[w] = M[at(n, w, ns)];
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
      s_panel[(size_t)j * Wp + w] = M[at(s_tcol[j], w, ns)];
    }
  __syncthreads();
  auto tword = [&](int j, int w) {
    return t_shared ? s_panel[(size_t)j * Wp + w] : M[at(s_tcol[j], w, ns)];
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
      for (int w = 0; w < Wm; ++w) wt += __popc(s_syn[w] ^ M[at(c, w, ns)]);
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
    if (bt1 >= 0) x ^= M[at(bt1, w, ns)];
    if (bt2 >= 0) x ^= M[at(bt2, w, ns)];
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
                             int, int, int, int, int, unsigned long long*);

LargeKernel large_kernel(int Wm) {
  if (Wm <= 5 * 32) return osd_large_kernel<5>;
  if (Wm <= 8 * 32) return osd_large_kernel<8>;
  return osd_large_kernel<32>;
}

}  // namespace

// Shared memory of one block: the reduction slots, three panels of P
// columns (odd stride), two panel records, the syndromes, a chunk's hit
// bits and g, the T columns and four flag words; two chunks' hit lists and
// the pivot rows as int16.
extern "C" size_t osd_large_smem_bytes(int n, int Wm, int lam, int P) {
  return 8 * (size_t)kWarps +
         4 * (3 * (size_t)P * panel_stride(Wm) + 2 * record_words(P, Wm) + 2 * (size_t)Wm +
              2 * (size_t)kChunk + (lam > 0 ? lam : 1) + 4) +
         2 * (2 * (size_t)kChunk + n);
}

// Launches blocks for samples row0 .. row0 + rows - 1 on `stream`, panels of
// P columns; block i works in scratch[i * Wm * ns ...], ns = n + 1 rounded
// up to a multiple of four (scratch_stride).  `stats` is
// null or two int64 the blocks add their pivots and trailing passes to.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int osd_large_launch(const void* h_cols, const void* perm, const void* synd,
                                const void* skip, const void* pairs, void* scratch, void* e0,
                                void* ew, int row0, int rows, int m, int n, int Wm, int rank,
                                int lam, int n_pairs, int sweep, int P, void* stats,
                                void* stream) {
  if (P < 1 || P > kMaxPanel || m > 32767 || n > 32767) return (int)cudaErrorInvalidValue;
  const size_t smem = osd_large_smem_bytes(n, Wm, lam, P);
  auto kernel = large_kernel(Wm);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)h_cols, (const int32_t*)perm, (const uint8_t*)synd, (const uint8_t*)skip,
      (const int32_t*)pairs, (uint32_t*)scratch, (uint8_t*)e0, (uint8_t*)ew, row0, m, n, Wm,
      rank, lam, n_pairs, sweep, P, (unsigned long long*)stats);
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
