// osd_large.cu -- ordered-statistics decoding (osd0 / osd_cs) for codes whose
// matrix does not fit in a block's shared memory, one thread block (or one
// thread-block cluster) per sample, the matrix in device memory and a window
// of it in shared memory.
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
// pivot, ~9,600 barriers a lift-400 row.  This design is a blocked
// Gauss-Jordan, right-looking across panels (a delayed trailing update) and
// left-looking inside one:
//   - the elimination walks panels of P <= 32 columns (the wrapper's
//     osd_large_panel).  Warp 0 factorises panel k in its shared-memory
//     buffer with no block barrier, left-looking in the panel: on reaching
//     a column it takes the panel's pivots so far to it at once (catch_up:
//     g from the column's bits at their rows, then the S_i g selects, in
//     registers), then the pivot search in registers, the pivot bit cleared
//     in place (the column is then S_i), the dependent columns passed over.
//     It records each of the panel's q pivots: r_i, the column's
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
// ~2.5 TB/s of device memory.  The factorisation before this one took each
// pivot to the panel's later columns at once, and panel_apply's g was a
// chain of dependent loads (same bits).  Against it, in turns on the same
// rows, a block a sample: a lone row and 8 rows 0-2% faster, 129 rows 1.4%
// faster, 96 rows of the gross code's space-time matrix 0.6% slower; the
// cluster plan's lone row ~12% faster (its chain is warp 0's alone).
// Two plans, picked by the wrapper (ops/cuda_osd_large.py:osd_large_cluster)
// from the launch's rows B, the card's SMs and the graph:
//   - a block a sample, as above, wherever B x 2 exceeds the SMs (a heavy
//     batch already fills the card);
//   - the cluster plan below that: a thread-block cluster of C = 8, 4 or 2
//     blocks a sample (the most whose B clusters the card holds at once,
//     cudaOccupancyMaxActiveClusters), C x B blocks, kCluster.  Block 0,
//     the leader, does what the lone block does but the far trailing
//     passes: warp 0 factorises, the workers write back, load (from the
//     L2, ld.global.cg) and take the next panel past the last two.  Blocks
//     1..C-1, the members, make the far passes, each over its share of the
//     columns (from the pass's first column rounded down to a multiple of
//     four, shares of a multiple of four columns).  One split cluster
//     barrier a panel orders the two: phase k ends when the leader has
//     factorised panel k (and arrived after its second block barrier) and
//     every member has passed panel k - 1 (and fenced its XORs).  Then a
//     member copies panel k's record (up to the hit lists, which it builds)
//     and pivot columns from the leader's shared memory (distributed shared
//     memory) and passes panel k; the leader's workers wait for phase k
//     before they load panel k + 2, and warp 0 for phase k + 1 before it
//     writes panel k + 2's record over panel k's.  The record's fourth
//     header word says the panel is the last, whose pass starts after the
//     next panel.  The members read the scratch from the L2 too: no SM's
//     L1 sees another's XORs.  Every block of the cluster copies in part
//     of the matrix.  With its SM to itself, warp 0 is the chain (clock64
//     counters: ~21,000 of ~25,000 cycles a panel at lift 400); both plans
//     share its factorisation and panel_apply (one warp reduction for g,
//     the S_i's loads side by side).
//     A lone lift-400 row (H100, 700 W): 5.41 -> 4.03 ms at p = 0.005, 7.15
//     -> 4.81 ms at p = 0.028 (8 blocks; 8 rows 10.10 -> 4.90 and 7.75 ->
//     4.98 ms).  In turns against a block a sample on BP-failing lift-400
//     rows and on the gross code's: 16 rows, clusters of 4, 29-48% faster;
//     31, 48 and 66 rows, clusters of 2, 3-13% faster; 129 rows, clusters
//     of 2 in two waves, 5-6% slower (so the rule stops at B x 2 <= SMs).  A
//     row whose far passes are heavy still waits for the members: their
//     copy (~7,000 cycles) and pass (~15,000) outlast the leader's panel.
// Shared memory: the three panel buffers (column-major, odd stride: one word
// of every panel column is read without bank conflicts), two panel records,
// the syndromes, a chunk's hit bits and g, two chunks' hit lists, the T
// columns and the pivot row of each column (int16, so m and n are below
// 32768).  A skip sample writes zeros and returns.  While the profiler's
// recorder is on, each sample's (leader) block adds its pivots and its
// trailing passes to `stats` (one atomic each).

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWorkWarps = kWarps - 1;  // warps 1-31 make the trailing passes
constexpr int kWorkers = 32 * kWorkWarps;
constexpr int kMaxPanel = 32;  // a panel's pivots are the bits of a 32-bit word
constexpr int kChunk = 4096;   // columns a trailing pass takes at once
constexpr int kScan = 4;       // 16-byte loads of pivot-row words a worker issues at once
constexpr int kMaxCluster = 8;  // blocks a sample in the cluster plan (the portable most)

__host__ __device__ inline int panel_stride(int Wm) { return Wm | 1; }

// words between word w and word w + 1 of a column in the scratch: n + 1
// columns rounded up to a multiple of four, so four neighbouring columns
// from a multiple of four are one aligned 16-byte load
__host__ __device__ inline int scratch_stride(int n) { return (n + 4) & ~3; }

// words of one panel record: N, tc, pw, pm, cnt [P], Unz, Uw [Wm], the
// header {q, D, nU, last}, piv [P][32] bytes (record_head words), then
// Sidx [P][Wm] int16
__host__ __device__ inline size_t record_head(int P, int Wm) {
  return 13 * (size_t)P + 2 * (size_t)Wm + 4;
}

__host__ __device__ inline size_t record_words(int P, int Wm) {
  return ((size_t)P * Wm + 1) / 2 + record_head(P, Wm);
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
  int32_t* hdr;    // q, D, nU, and whether the panel is the last
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

// Warp 0 takes a panel's pivots so far (q, lane i < q holding pivot i's
// row r, its place tc and its column Ncol of (I + L)^-1) to column col (the
// lane's words cw) when it reaches it (left-looking in the panel): the
// column's bits at their rows (cb) give g = (I + L)^-1 cb, the XOR of the
// Ncol of lanes in cb; then it takes the S_i that g selects, in registers,
// and goes back to the buffer if it changed.  A pivot then costs no pass
// over the panel's later columns
template <int kLW>
__device__ __forceinline__ void catch_up(uint32_t* col, uint32_t (&cw)[kLW],
                                         const uint32_t* buf, int Wp, int Wm, int lane, int q,
                                         int r, int tc, uint32_t Ncol) {
  const bool hit = lane < q && ((col[r >> 5] >> (r & 31)) & 1u);
  const unsigned cb = __ballot_sync(kFull, hit);
  if (cb == 0u) return;
  for (uint32_t gm = __reduce_xor_sync(kFull, hit ? Ncol : 0u); gm; gm &= gm - 1u) {
    const uint32_t* Si = buf + (size_t)__shfl_sync(kFull, tc, __ffs(gm) - 1) * Wp;
#pragma unroll
    for (int i = 0; i < kLW; ++i)
      if (lane + 32 * i < Wm) cw[i] ^= Si[lane + 32 * i];
  }
#pragma unroll
  for (int i = 0; i < kLW; ++i)
    if (lane + 32 * i < Wm) col[lane + 32 * i] = cw[i];
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

// the split cluster barrier: arrive releases this thread's writes (shared
// and device memory) to the cluster, wait acquires the others'
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// a load of the scratch; in the cluster plan from the L2 (ld.global.cg),
// since other SMs' XORs never reach this SM's L1
template <bool kL2, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kL2) return __ldcg(p);
  else return *p;
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
// allows with the workers' loads in flight.  kCluster: the cluster plan, a
// cluster of blocks a sample (block 0 the leader, the others members).
template <int kLW, bool kCluster>
__global__ void __launch_bounds__(kThreads)
osd_large_kernel(const int32_t* __restrict__ h_cols, const int32_t* __restrict__ perm,
                 const uint8_t* __restrict__ synd, const uint8_t* __restrict__ skip,
                 const int32_t* __restrict__ pairs, uint32_t* scratch,
                 uint8_t* __restrict__ e0, uint8_t* __restrict__ ew, int row0, int m, int n,
                 int Wm, int rank, int lam, int n_pairs, int sweep, int P,
                 unsigned long long* stats) {
  int crank = 0, nc = 1;  // this block's rank in its cluster, and the cluster's blocks
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    crank = (int)cluster.block_rank();
    nc = (int)cluster.num_blocks();
  }
  const int smp = blockIdx.x / nc;  // the launch's sample of this block
  const int b = row0 + smp;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ww = warp - 1;      // a worker's warp index
  const int wid = 32 * ww + lane;  // a worker's index
  const unsigned lt_mask = (1u << lane) - 1u;

  if (skip && skip[b]) {  // the whole cluster returns
    if (crank == 0)
      for (int v = tid; v < n; v += kThreads) {
        e0[(size_t)b * n + v] = 0;
        ew[(size_t)b * n + v] = 0;
      }
    return;
  }

  const int n1 = n + 1;
  const int ns = scratch_stride(n);
  const int Wp = panel_stride(Wm);
  uint32_t* M = scratch + (size_t)smp * ns * Wm;
  const int32_t* pb = perm + (size_t)b * n;
  auto ldm = [&](size_t i) { return load<kCluster>(M + i); };

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
  // a warp writes 32 neighbouring columns, word by word (the cluster's
  // blocks share the columns)
  for (int c0 = (crank * kWarps + warp) * 32; c0 < n; c0 += nc * kThreads) {
    const int c = c0 + lane;
    if (c < n) {
      const int32_t* src = h_cols + (size_t)pb[c] * Wm;
      for (int w = 0; w < Wm; ++w) M[at(c, w, ns)] = (uint32_t)__ldg(src + w);
    }
  }
  if (crank == 0)
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

  // panel j's columns in shared memory past panel R's pivots: a warp a
  // column (helper warp hw of nw).  Lane i holds pivot i's column of
  // (I + L)^-1 and S_i's place, so g is one warp reduction of the column's
  // pivot bits, and each lane XORs the S_i that g selects at its union
  // words, kU at a time, two pivots' loads side by side (no dependent load
  // a pivot: this lies on warp 0's chain after each panel)
  auto panel_apply = [&](const Panel& R, int j, int hw, int nw) {
    constexpr int kU = kLW < 8 ? kLW : 8;  // union words a lane at once (32 would spill)
    const int q = R.hdr[0], D = R.hdr[1], nU = R.hdr[2];
    const uint32_t my_n = lane < q ? R.N[lane] : 0u;
    const int my_base = lane < q ? R.tc[lane] * R.Wp : 0;  // S_i's place
    for (int jj = hw; jj < P; jj += nw) {
      const int c = j * P + jj;
      if (c >= n) break;
      uint32_t* col = slot(c);
      uint32_t cb = 0u;
      if (lane < D) cb = pivot_bits(col[R.pw[lane]] & R.pm[lane], R.piv + 32 * lane);
      cb = __reduce_or_sync(kFull, cb);
      if (cb == 0u) continue;
      const uint32_t g = __reduce_xor_sync(kFull, (cb >> lane) & 1u ? my_n : 0u);
      for (int u0 = 0; u0 < nU; u0 += 32 * kU) {
        int wl[kU];  // the lane's union words, -1 past the union
#pragma unroll
        for (int s = 0; s < kU; ++s) {
          const int u = u0 + lane + 32 * s;
          wl[s] = u < nU ? R.Uw[u] : -1;
        }
        uint32_t x[kU];
#pragma unroll
        for (int s = 0; s < kU; ++s) x[s] = 0u;
        for (uint32_t gm = g; gm;) {  // two pivots' loads at a time
          const int b0 = __shfl_sync(kFull, my_base, __ffs(gm) - 1);
          gm &= gm - 1u;
          const bool two = gm != 0u;
          const int b1 = __shfl_sync(kFull, my_base, two ? __ffs(gm) - 1 : 0);
          if (two) gm &= gm - 1u;
          uint32_t v0[kU], v1[kU];
#pragma unroll
          for (int s = 0; s < kU; ++s) {
            v0[s] = wl[s] >= 0 ? R.Sb[b0 + wl[s]] : 0u;
            v1[s] = two && wl[s] >= 0 ? R.Sb[b1 + wl[s]] : 0u;
          }
#pragma unroll
          for (int s = 0; s < kU; ++s) x[s] ^= v0[s] ^ v1[s];
        }
#pragma unroll
        for (int s = 0; s < kU; ++s)
          if (x[s]) col[wl[s]] ^= x[s];
      }
    }
  };

  // ---- the trailing pass of panel R over columns [cstart, cend) in device
  // memory (workers): chunks of kChunk columns, each in three steps ----
  int chunk = 0;  // chunks passed so far (the parity of the hit list)
  auto trailing_pass = [&](const Panel& R, int cstart, int cend) {
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
    for (int c0 = cstart & ~3; c0 < cend; c0 += kChunk, ++chunk) {
      const int C = min(kChunk, cend - c0);  // columns c0 + c, c < C; those before cstart stay
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
            x[u] = d < D ? load<kCluster>(
                               reinterpret_cast<const uint4*>(M + at(c0 + 4 * g, R.pw[d], ns)))
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

  if constexpr (kCluster) {
    __threadfence();
    cluster_arrive();
    cluster_wait();  // the matrix is whole in device memory
    if (crank != 0) {
      // ---- a member: the far trailing pass of every panel over its share
      // of the columns.  Phase k of the cluster barrier ends once the
      // leader has factorised panel k and every member has passed panel
      // k - 1; then a member copies panel k's record (up to its hit lists,
      // which it builds itself) and its pivot columns from the leader's
      // shared memory into the same places of its own, and passes panel k
      // to the columns after panel k + 2 (after panel k + 1 for the last
      // panel), which the leader loads only after phase k + 1 ----
      cg::cluster_group cluster = cg::this_cluster();
      const uint32_t* lead_rec = cluster.map_shared_rank(s_rec, 0);
      const uint32_t* lead_panel = cluster.map_shared_rank(s_panel, 0);
      const size_t rw = record_words(P, Wm);
      const size_t head = record_head(P, Wm);  // the record before Sidx
      const size_t pw = (size_t)P * Wp;
      const int mi = crank - 1, nm = nc - 1;
      // words off(i), i < cnt, of the leader's shared memory from src to
      // the same places from dst, four loads a thread in flight
      auto pull = [&](const uint32_t* src, uint32_t* dst, int cnt, auto off) {
        for (int i0 = tid; i0 < cnt; i0 += 4 * kThreads) {
          uint32_t v[4];
          size_t o[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = i0 + u * kThreads;
            o[u] = i < cnt ? off(i) : 0;
            v[u] = i < cnt ? src[o[u]] : 0u;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (i0 + u * kThreads < cnt) dst[o[u]] = v[u];
        }
      };
      for (int k = 0;; ++k) {
        cluster_arrive();
        cluster_wait();
        const size_t ro = (k & 1) * rw, po = (size_t)(k % 3) * pw;
        pull(lead_rec, s_rec, (int)head, [&](int i) { return ro + i; });
        __syncthreads();
        const Panel R = record(k);
        // the S_i: the panel's pivot columns
        pull(lead_panel, s_panel, R.hdr[0] * Wm,
             [&](int i) { return po + (size_t)R.tc[i / Wm] * Wp + i % Wm; });
        __syncthreads();
        const bool last = R.hdr[3] != 0;
        if (warp != 0 && R.hdr[0] > 0) {
          // columns [cs, n], split at multiples of four among the members
          const int cs = min(n, (k + (last ? 2 : 3)) * P);
          const int base = cs & ~3;
          const int per = ((n1 - base + nm - 1) / nm + 3) & ~3;
          const int lo = base + mi * per, hi = min(n1, lo + per);
          if (lo < hi) trailing_pass(R, max(lo, cs), hi);
        }
        __threadfence();  // the XORs done in the L2 before the next phase
        if (last) {
          cluster_arrive();
          cluster_wait();
          return;
        }
      }
    }
  } else {
    __syncthreads();
  }
  // Element e of a panel is column e % P, word e / P: neighbouring threads
  // take neighbouring columns (coalesced in the word-major layout).
  for (int i = tid; i < P * Wm; i += kThreads) {
    const int c = i % P, w = i / P;
    if (c < n) slot(c)[w] = ldm(at(c, w, ns));
  }
  __syncthreads();

  // ---- 2. Gauss-Jordan in reliability order, a panel of P columns at a
  // time.  Panel j lives in buffer j % 3.  While warp 0 factorises panel k,
  // the workers write panel k - 1 back, load panel k + 1, take panel k - 1
  // to the columns after panel k + 1 in device memory (the members, in the
  // cluster plan) and take panel k + 1 past it; after the barrier every
  // warp takes a column of panel k + 1 past panel k, and after a second
  // warp 0 goes on to it.  In the cluster plan the leader arrives at phase k
  // of the cluster barrier after that second barrier, and waits for phase
  // k - 1 before it loads panel k + 1 (the workers) or writes panel k + 1's
  // record over panel k - 1's (warp 0) ----
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
        catch_up(col, cw, buf, Wp, Wm, lane, q, my_r, my_tc, my_Ncol);
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
        __syncwarp();
        ++q;
        ++rr;
      }
      for (int c = t; c < tend; ++c) {  // rank reached: the panel's other columns catch up
        uint32_t* col = buf + (size_t)(c - k0) * Wp;
        uint32_t cw[kLW];
#pragma unroll
        for (int i = 0; i < kLW; ++i) cw[i] = lane + 32 * i < Wm ? col[lane + 32 * i] : 0u;
        catch_up(col, cw, buf, Wp, Wm, lane, q, my_r, my_tc, my_Ncol);
      }
      __syncwarp();
      if constexpr (kCluster)
        if (k > 0) cluster_wait();  // the members hold panel k - 2's record no more
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
        const int fin = t >= n || rr >= rank;  // the last panel
        R.hdr[0] = q;
        R.hdr[1] = __popc(leaders);
        R.hdr[2] = nU;
        R.hdr[3] = fin;
        s_misc[0] = fin;
      }
      passes += q > 0;
    } else {
      // panel k - 1 back to device memory; panel k + 1 on its way into its
      // buffer (element e: column e % P, word e / P) while panel k - 1 goes
      // to the columns after panel k + 1; then panel k + 1 past panel k - 1.
      // In the cluster plan the members pass panel k - 1, and panel k + 1
      // comes from the L2 once they have passed panel k - 2
      if constexpr (kCluster)
        if (k > 0) cluster_wait();
      const uint32_t* prev = s_panel + (size_t)((k + 2) % 3) * P * Wp;
      uint32_t* next = s_panel + (size_t)((k + 1) % 3) * P * Wp;
      const int dw = kWorkers / P, dj = kWorkers - dw * P;
      for (int j = wid % P, w = wid / P; w < Wm;) {
        const int c = (k - 1) * P + j, c2 = (k + 1) * P + j;
        if (k > 0 && c < n) M[at(c, w, ns)] = prev[j * Wp + w];
        if (c2 < n) {
          if constexpr (kCluster) next[j * Wp + w] = ldm(at(c2, w, ns));
          else cp_async4(next + j * Wp + w, M + at(c2, w, ns));
        }
        j += dj;
        w += dw;
        if (j >= P) {
          j -= P;
          ++w;
        }
      }
      const Panel Rp = record(max(k - 1, 0));
      const bool pass = k > 0 && Rp.hdr[0] > 0;
      if constexpr (!kCluster) {
        if (pass) trailing_pass(Rp, min(n, (k + 2) * P), n1);
        cp_async_wait_all();
      }
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
    if constexpr (kCluster) cluster_arrive();  // phase k: panel k's record is final
    if (done) {
      // panels k and k + 1 back to device memory; panel k to the columns
      // after them (by the members in the cluster plan: phase k + 1 ends
      // when they have)
      for (int i = tid; i < 2 * P * Wm; i += kThreads) {
        const int j = i % (2 * P), w = i / (2 * P);
        const int c = k * P + j;
        if (c < n) M[at(c, w, ns)] = slot(c)[w];
      }
      if constexpr (kCluster) {
        cluster_wait();
        cluster_arrive();
        cluster_wait();
      } else {
        if (warp != 0 && q > 0) trailing_pass(R, min(n, (k + 2) * P), n1);
        __syncthreads();
      }
      break;
    }
  }
  if (stats && tid == 0) {
    atomicAdd(stats, (unsigned long long)rr);
    atomicAdd(stats + 1, (unsigned long long)passes);
  }

  // ---- T: the first lam non-pivot columns, in reliability order ----
  for (int w = tid; w < Wm; w += kThreads) s_syn[w] = ldm(at(n, w, ns));
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
      s_panel[(size_t)j * Wp + w] = ldm(at(s_tcol[j], w, ns));
    }
  __syncthreads();
  auto tword = [&](int j, int w) {
    return t_shared ? s_panel[(size_t)j * Wp + w] : ldm(at(s_tcol[j], w, ns));
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
      for (int w = 0; w < Wm; ++w) wt += __popc(s_syn[w] ^ ldm(at(c, w, ns)));
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
    if (bt1 >= 0) x ^= ldm(at(bt1, w, ns));
    if (bt2 >= 0) x ^= ldm(at(bt2, w, ns));
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

LargeKernel large_kernel(int Wm, bool cluster) {
  if (Wm <= 5 * 32) return cluster ? osd_large_kernel<5, true> : osd_large_kernel<5, false>;
  if (Wm <= 8 * 32) return cluster ? osd_large_kernel<8, true> : osd_large_kernel<8, false>;
  return cluster ? osd_large_kernel<32, true> : osd_large_kernel<32, false>;
}

// A launch of `grid` blocks in clusters of `cluster` on `stream`
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int grid, int cluster, size_t smem,
                                  void* stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
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

// Launches the samples row0 .. row0 + rows - 1 on `stream`, panels of P
// columns, `cluster` blocks a sample (1: a block a sample; 2-8: the
// cluster plan, blocks i * cluster .. (i + 1) * cluster - 1 for the
// launch's sample i); sample i works in scratch[i * Wm * ns ...], ns = n + 1
// rounded up to a multiple of four (scratch_stride).  `stats` is null or two
// int64 the blocks add their pivots and trailing passes to.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel does
// not take.
extern "C" int osd_large_launch(const void* h_cols, const void* perm, const void* synd,
                                const void* skip, const void* pairs, void* scratch, void* e0,
                                void* ew, int row0, int rows, int m, int n, int Wm, int rank,
                                int lam, int n_pairs, int sweep, int P, int cluster, void* stats,
                                void* stream) {
  if (P < 1 || P > kMaxPanel || m > 32767 || n > 32767 || cluster < 1 || cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const size_t smem = osd_large_smem_bytes(n, Wm, lam, P);
  auto kernel = large_kernel(Wm, cluster > 1);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int32_t* h = (const int32_t*)h_cols;
  const int32_t* pm = (const int32_t*)perm;
  const uint8_t* sy = (const uint8_t*)synd;
  const uint8_t* sk = (const uint8_t*)skip;
  const int32_t* pr = (const int32_t*)pairs;
  uint32_t* sc = (uint32_t*)scratch;
  uint8_t* o0 = (uint8_t*)e0;
  uint8_t* ow = (uint8_t*)ew;
  unsigned long long* st = (unsigned long long*)stats;
  if (cluster == 1) {
    kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
        h, pm, sy, sk, pr, sc, o0, ow, row0, m, n, Wm, rank, lam, n_pairs, sweep, P, st);
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(&attr, rows * cluster, cluster, smem, stream);
    err = cudaLaunchKernelEx(&cfg, kernel, h, pm, sy, sk, pr, sc, o0, ow, row0, m, n, Wm, rank,
                             lam, n_pairs, sweep, P, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// The kernel's registers a thread and resident blocks an SM at this shape:
// out = {registers, blocks an SM}.  Returns 0 or the CUDA error.
extern "C" int osd_large_plan(int n, int Wm, int lam, int P, int* out) {
  auto kernel = large_kernel(Wm, false);
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

// The cluster plan at this shape with `cluster` blocks a sample: out =
// {registers a thread, clusters the card holds at once
// (cudaOccupancyMaxActiveClusters)}.  Returns 0 or the CUDA error.
extern "C" int osd_large_clusters(int n, int Wm, int lam, int P, int cluster, int* out) {
  if (cluster < 2 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  auto kernel = large_kernel(Wm, true);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = osd_large_smem_bytes(n, Wm, lam, P);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cattr;
  const cudaLaunchConfig_t cfg = cluster_config(&cattr, cluster, cluster, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = clusters;
  return 0;
}
