// bp_flood.cu -- flooding belief propagation (K1): persistent blocks whose
// teams of warps each decode one sample at a time where a launch fills the
// card, one row a block with its check rows in registers where it does not.
//
// Replaces the TPU kernel bp_osd_tpu/ops/pallas_bp.py:_bp_kernel (K1): the
// whole min-sum / product-sum iteration loop for a batch of syndromes, with
// skip rows born converged, resume from a v2c message state at it0 + 1, and
// emit of that state after each sample's last iteration.  The plain torch
// version is bp_osd_tpu_torch/decoder/bp.py:bp_decode_plain; this kernel is
// bit-identical to it for min-sum.
//
// What bounds it on an H100.  The necessary work is ~9 operations an edge
// per sample-iteration (E = m * wr = 1344 edges on the [[400,16,6]]
// flagship), mostly integer, and the device-memory traffic is the inputs and
// outputs once per sample: the bound is a sixth of the measured time or
// less (PERF.md).  A launch that fills the card runs out of instruction
// throughput: each slot of a check costs a load of the total, the
// subtraction, the hard-decision parity, the sign, the magnitude, the
// two-minimum update and the c2v write, and each edge of the variable sum a
// gather and the four-lane select, for every sample-iteration.  A launch of
// fewer rows than the card holds teams (the resumed stages of a long
// decode: ~120 rows of 7,504 dependent iterations on the gross code's
// space-time matrix) runs out of latency instead: a row's iteration is a
// chain of dependent shared-memory loads between two barriers, and an SM
// with one row has only that row's warps to hide them.
//
// bp_flood_plan picks one of two plans from the batch, the card's SM count
// and the graph alone:
//   * the throughput plan, wherever B reaches the SMs times the resident
//     teams an SM: one persistent block per SM loads the Tanner tables
//     (chk_var rows and their c2v rows padded to a multiple of 4 slots, read
//     and written 16 bytes at a time; var_edge rows with each entry's c2v
//     index and lane; the per-check degree from the host) into shared memory
//     once, and its teams (one warp, or a few warps with a named barrier
//     each) decode one sample at a time; a team that finishes takes the next
//     row from a global counter (atomicAdd).  team_warps_of sizes the team
//     to the code alone, once a graph: the most resident teams per unit of
//     per-thread work between barriers (3 warps, 2 checks and ~4 variables a
//     thread, 10 teams an SM at the flagship);
//   * the latency plan, below that, for min-sum graphs of m <= 1024, n <= 3
//     * 32 * ceil(m / 32), rows <= 8 and columns <= 4, where k = ceil(B /
//     SMs) is 1 or 2: bp_flood_team_kernel_latency, a block an SM of the
//     whole-row team (32 * ceil(m / 32) threads, a check and three
//     variables a thread: 960 on the space-time matrix) that holds one row,
//     or two in the B - SMs blocks of a launch of more rows than SMs, the
//     same threads serving both.  Each thread keeps its check row (the
//     shared byte offsets of its totals), its degree and each row's message
//     and syndrome bit in registers for the whole launch, and shared memory
//     holds the variable rows once and, a row, only what threads exchange:
//     c2v, warp-tiled so a warp's stores are contiguous, and the totals.
//     Every shared address is one register plus a constant or the row's
//     region (checks and variables past m and n are pads), so the loop keeps
//     to the 64 registers a thread that 1024 threads allow (with two rows,
//     ptxas parks two values of the emit in local memory, outside the
//     loop).
// In both, check-side state lives in registers: the thread that owns a
// check keeps its compressed min-sum message (the two scaled minima, the
// first-minimum slot and the output sign bits); only c2v (E floats) and the
// totals (n floats) go through shared memory.  Two barriers an iteration:
// the check update of iteration t + 1 reads tot_t and c2v_t, takes the
// syndrome parity of iteration t on the way, and writes c2v_{t+1}; the first
// barrier ORs the parity failures; a sample that stops at t emits tot_t and
// v2c_t (c2v_t rebuilt from its registers) and the speculative c2v_{t+1} is
// dropped; otherwise the variable sums follow and the second barrier closes
// the iteration.  A check row of 4 or 8 padded slots is updated unrolled and
// without branches (a pad reads a total of 1.0f and enters the minimum as
// the 1e30 cap in the team kernel, +inf in the latency kernel: neither
// changes anything).  Product-sum runs in the throughput plan's teams with
// c2v double-buffered in shared memory by iteration parity (its messages do
// not compress).
//
// Arithmetic contract (what makes min-sum bit-identical to the plain torch
// version and, at the flagship shape, to the JAX XLA path):
//   * a variable's incoming messages are summed in four lanes: the message
//     on flat edge e = check * wr + slot goes to lane e % 4, each lane adds
//     in ascending e, and the lanes combine as (p0 + p1) + (p2 + p3); then
//     total = llr0 + sum and v2c = total - c2v;
//   * built with --fmad=false and explicit _rn intrinsics, so no product is
//     contracted into an FMA;
//   * adaptive alpha_t = 1 - ldexpf(1, -t) (exact), fixed alpha as given;
//   * sign test x < 0.0f (-0.0 counts as non-negative); exclusive minimum of
//     the magnitude bits, seeded with the 1e30 cap (row weight 1 gets it),
//     the first minimum taken over ascending slots;
//   * hard = total <= 0, then the syndrome check; a sample freezes at its
//     first convergence and otherwise runs exactly max_iter iterations.
//
// Tables: chk_var [m * wr] (pad = n) and var_edge [n * wc] (pad = m * wr),
// both int32 and ascending within a row, as TannerGraph lays them out, and
// deg [m], the count of chk_var < n of each check, from the host.
//
// Placement.  The team kernel runs every code whose whole per-sample state
// in the first design (bp_flood_smem_bytes: tables, syndrome, v2c, c2v,
// totals, prior) fits a block, up to lift 140 of the bench protograph, and
// whose tables and one team fit too (product-sum stops earlier).  Above it
// (the dense [[10000,420]] lifted product needs 662,400 bytes)
// bp_flood_global_kernel keeps the first design: one block per sample, the
// tables read from device memory through the read-only cache and the state
// in this block's slice of a scratch buffer, bp_flood_scratch_words per
// sample, which stays in L2 for the few hundred samples a launch takes.  The arithmetic is the same, so both are
// bit-identical to the plain version.  A min-sum launch of any size on such a
// graph takes the wide plan instead (wide_shape: rows <= 8 slots, columns <=
// 4, m <= 4096, n <= 8192): bp_flood_wide_kernel, min(B, SMs) persistent
// blocks of 1024 threads, one row at a time each, the next from a counter,
// the latency kernel's iteration with a few checks and up to 8 variables a
// thread, its tables with 16-bit entries (loaded once a block) and the
// row's totals, priors and compressed check messages (16 bytes a check,
// where c2v takes 4 a slot) in shared memory: 200,480 bytes on the two-gross
// code's 2736 x 8064 space-time matrix, whose first-design state needs
// 434,880.  The device-memory kernel keeps product-sum and the graphs
// outside that shape.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "bp_check.cuh"

namespace {

constexpr int kThreads = 256;       // device-memory placement: threads a block
constexpr int kSmemLimit = 232448;  // shared memory a block may use on Hopper
constexpr int kMaxWarpTeams = 15;   // named barriers 1..15, one per multi-warp team
constexpr int kMaxChecksPerThread = 8;

// ---------------------------------------------------------------------------
// Device-memory placement: one block per sample (the first design).

__global__ void __launch_bounds__(kThreads)
bp_flood_global_kernel(const uint8_t* __restrict__ synd, const float* __restrict__ llr0,
                       long long llr0_stride, const uint8_t* __restrict__ skip,
                       const float* __restrict__ v2c_in, const int32_t* __restrict__ s_cv,
                       const int32_t* __restrict__ s_ve, uint8_t* __restrict__ hard,
                       float* __restrict__ llr, uint8_t* __restrict__ conv,
                       int32_t* __restrict__ iters, float* __restrict__ v2c_out,
                       int32_t* scratch, unsigned long long* row_iters, int m, int n, int wr,
                       int wc, int max_iter, int it0, int product_sum, float alpha_fixed) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int E = m * wr;

  int32_t* s_syn = scratch + (size_t)b * (m + 2 * (size_t)E + 2 * (size_t)n);
  float* s_v2c = reinterpret_cast<float*>(s_syn + m);  // [E]
  float* s_c2v = s_v2c + E;              // [E]
  float* s_tot = s_c2v + E;              // [n]
  float* s_l0 = s_tot + n;               // [n]

  for (int c = tid; c < m; c += nt) s_syn[c] = synd[(size_t)b * m + c] & 1;
  for (int v = tid; v < n; v += nt) s_l0[v] = llr0[(size_t)b * llr0_stride + v];
  __syncthreads();
  for (int e = tid; e < E; e += nt) {
    const int v = s_cv[e];
    float x = 0.0f;
    if (v < n) x = v2c_in ? v2c_in[(size_t)b * E + e] : s_l0[v];
    s_v2c[e] = x;
  }
  __syncthreads();

  if (skip && skip[b]) {  // born converged: hard 0, llr the prior
    for (int v = tid; v < n; v += nt) {
      hard[(size_t)b * n + v] = 0;
      llr[(size_t)b * n + v] = s_l0[v];
    }
    if (v2c_out)
      for (int e = tid; e < E; e += nt) v2c_out[(size_t)b * E + e] = s_v2c[e];
    if (tid == 0) {
      conv[b] = 1;
      iters[b] = it0;
    }
    return;
  }

  const uint32_t big_bits = __float_as_uint(kBig);
  for (int it = it0 + 1;; ++it) {
    // ---- check update: one thread per check, v2c -> c2v ----
    const float alpha = alpha_at(it, alpha_fixed);
    for (int c = tid; c < m; c += nt) {
      const int base = c * wr;
      int cnt = 0;
      while (cnt < wr && s_cv[base + cnt] < n) ++cnt;
      if (!product_sum) {
        int parity = s_syn[c];
        uint32_t m1 = big_bits, m2 = big_bits;
        int i1 = -1;
        for (int s = 0; s < cnt; ++s) {
          const float x = s_v2c[base + s];
          parity ^= (x < 0.0f);
          const uint32_t mag = __float_as_uint(x) & 0x7fffffffu;
          if (mag < m1) {
            m2 = m1;
            m1 = mag;
            i1 = s;
          } else if (mag < m2) {
            m2 = mag;
          }
        }
        for (int s = 0; s < cnt; ++s) {
          const float x = s_v2c[base + s];
          const float val = __fmul_rn(__uint_as_float(s == i1 ? m2 : m1), alpha);
          s_c2v[base + s] = (parity ^ (x < 0.0f)) ? -val : val;
        }
      } else {
        const float sgn = s_syn[c] ? -1.0f : 1.0f;
        float fwd = 1.0f;
        for (int s = 0; s < cnt; ++s) {
          s_c2v[base + s] = fwd;
          fwd = __fmul_rn(fwd, tanhf(__fmul_rn(0.5f, s_v2c[base + s])));
        }
        float bwd = 1.0f;
        for (int s = cnt - 1; s >= 0; --s) {
          float x = __fmul_rn(__fmul_rn(sgn, s_c2v[base + s]), bwd);
          x = fminf(fmaxf(x, -kTanhClip), kTanhClip);
          s_c2v[base + s] = __fmul_rn(2.0f, atanhf(x));
          bwd = __fmul_rn(bwd, tanhf(__fmul_rn(0.5f, s_v2c[base + s])));
        }
      }
    }
    __syncthreads();

    // ---- variable sum: one thread per variable, four lanes ----
    for (int v = tid; v < n; v += nt) {
      float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = 0; j < wc; ++j) {
        const int e = s_ve[v * wc + j];
        if (e >= E) break;
        p[e & 3] = __fadd_rn(p[e & 3], s_c2v[e]);
      }
      s_tot[v] = __fadd_rn(s_l0[v], __fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])));
    }
    __syncthreads();

    // ---- v2c update + syndrome check: one thread per check ----
    int fail = 0;
    for (int c = tid; c < m; c += nt) {
      const int base = c * wr;
      int parity = s_syn[c];
      for (int s = 0; s < wr; ++s) {
        const int v = s_cv[base + s];
        if (v >= n) break;
        const float t = s_tot[v];
        s_v2c[base + s] = __fsub_rn(t, s_c2v[base + s]);
        parity ^= (t <= 0.0f);
      }
      fail |= parity;
    }
    const int any_fail = __syncthreads_or(fail);

    if (!any_fail || it >= max_iter) {
      for (int v = tid; v < n; v += nt) {
        const float t = s_tot[v];
        hard[(size_t)b * n + v] = (t <= 0.0f);
        llr[(size_t)b * n + v] = t;
      }
      if (v2c_out)
        for (int e = tid; e < E; e += nt) v2c_out[(size_t)b * E + e] = s_v2c[e];
      if (tid == 0) {
        conv[b] = !any_fail;
        iters[b] = it;
        if (row_iters) atomicAdd(row_iters, (unsigned long long)(it - it0));
      }
      return;
    }
  }
}

// ---------------------------------------------------------------------------
// Shared-memory placement: persistent blocks of sample teams.

// One team's synchronisation: __syncwarp for a one-warp team, else the named
// barrier `id` over the team's `nthreads` (both order shared memory).
struct Team {
  int id;
  int nthreads;

  __device__ __forceinline__ void sync() const {
    if (nthreads == 32) {
      __syncwarp();
    } else {
      asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
    }
  }

  // Barrier that returns whether `pred` held on any thread of the team.
  __device__ __forceinline__ int any(int pred) const {
    if (nthreads == 32) {
      __syncwarp();
      return __any_sync(0xffffffffu, pred);
    }
    int r;
    asm volatile(
        "{\n\t.reg .pred p, q;\n\t"
        "setp.ne.s32 p, %1, 0;\n\t"
        "barrier.red.or.pred q, %2, %3, p;\n\t"
        "selp.s32 %0, 1, 0, q;\n\t}"
        : "=r"(r)
        : "r"(pred), "r"(id), "r"(nthreads)
        : "memory");
    return r;
  }
};

// The four-lane sum of one variable's messages: lane e % 4, ascending e.
struct LaneSum {
  float p0, p1, p2, p3;

  // a pad (lane 3, x = 0.0f) adds +0.0f to p3, which leaves it unchanged:
  // a lane sum that starts at +0.0f never becomes -0.0f
  __device__ __forceinline__ void add(int k, float x) {
    if (k == 0) p0 = __fadd_rn(p0, x);
    if (k == 1) p1 = __fadd_rn(p1, x);
    if (k == 2) p2 = __fadd_rn(p2, x);
    if (k == 3) p3 = __fadd_rn(p3, x);
  }

  __device__ __forceinline__ void add4(const int4 e4, const float* c2v) {
    const int ent[4] = {e4.x, e4.y, e4.z, e4.w};
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = ent[j] >= 0 ? c2v[ent[j] >> 2] : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) add(ent[j] & 3, x[j]);
  }

  __device__ __forceinline__ float total(float l0) const {
    return __fadd_rn(l0, __fadd_rn(__fadd_rn(p0, p1), __fadd_rn(p2, p3)));
  }
};

// Totals of iteration it: tot[v] = llr0[v] + the four-lane sum of c2v; a
// variable's table row (wcp entries, a multiple of 4) is read 16 bytes at a
// time.
__device__ __forceinline__ void variable_sums(const int32_t* s_ve, const float* c2v,
                                              const float* __restrict__ l0, float* tot,
                                              int n, int wcp, int tid, int nthreads) {
  for (int v = tid; v < n; v += nthreads) {
    const int4* row = reinterpret_cast<const int4*>(s_ve + v * wcp);
    LaneSum a{0.0f, 0.0f, 0.0f, 0.0f};
    for (int g = 0; g < wcp / 4; ++g) a.add4(row[g], c2v);
    tot[v] = a.total(__ldg(l0 + v));
  }
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// The min-sum check update of one check of a row of exactly kS slots (4 or
// 8), unrolled and without branches: a pad slot (s >= dc) reads tot[n] =
// 1.0f, which leaves the hard-decision parity alone, and enters the minimum
// as the 1e30 cap, which changes neither minimum, the first-minimum slot
// nor the signs.  cv and c2v point at the check's rows.
template <int kS>
__device__ __forceinline__ void check_slots(const int32_t* cv, const float* c2v, const float* tot,
                                            int dc, int& hp, MinSumAcc& acc) {
  int v[kS];
  float cc[kS];
#pragma unroll
  for (int g = 0; g < kS / 4; ++g) {
    const int4 v4 = reinterpret_cast<const int4*>(cv)[g];
    const float4 c4 = reinterpret_cast<const float4*>(c2v)[g];  // c2v_it, own write
    v[4 * g] = v4.x, v[4 * g + 1] = v4.y, v[4 * g + 2] = v4.z, v[4 * g + 3] = v4.w;
    cc[4 * g] = c4.x, cc[4 * g + 1] = c4.y, cc[4 * g + 2] = c4.z, cc[4 * g + 3] = c4.w;
  }
  float tt[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) tt[s] = tot[v[s]];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    hp ^= tt[s] <= 0.0f;
    acc.add(s < dc ? __fsub_rn(tt[s], cc[s]) : kBig, s);
  }
}

// Writes a check's c2v row from its message, 16 bytes at a time (pad slots
// get values nothing reads): all kS slots when kS > 0, else the groups that
// hold the dc slots.
template <int kS>
__device__ __forceinline__ void write_slots(const MinSumMsg& q, float* row, int dc = 0) {
  const int groups = kS ? kS / 4 : (dc + 3) / 4;
#pragma unroll
  for (int g = 0; g < groups; ++g)
    reinterpret_cast<float4*>(row)[g] = make_float4(
        ms_value(q, 4 * g), ms_value(q, 4 * g + 1), ms_value(q, 4 * g + 2), ms_value(q, 4 * g + 3));
}

// kCPT: checks a thread owns (check c = tid + k * team_threads, k < kCPT).
// Shared memory, in 4-byte words, every part a multiple of 16 bytes:
//   tables: chk_var [m][wrp] (pad n), var_edge entries [n][wcp] ((c * wrp +
//   s) << 2 | e % 4, pad -1), deg [m], with wrp and wcp wr and wc rounded up
//   to a multiple of 4;
//   per team: c2v [m][wrp] (twice for product-sum), tot [n + 1] (tot[n] =
//   1.0f, the target of pad slots), two row slots.
template <int kCPT, bool kProd>
__global__ void bp_flood_team_kernel(
    const uint8_t* __restrict__ synd, const float* __restrict__ llr0, long long llr0_stride,
    const uint8_t* __restrict__ skip, const float* __restrict__ v2c_in,
    const int32_t* __restrict__ chk_var, const int32_t* __restrict__ var_edge,
    const int32_t* __restrict__ deg, uint8_t* __restrict__ hard, float* __restrict__ llr,
    uint8_t* __restrict__ conv, int32_t* __restrict__ iters, float* __restrict__ v2c_out,
    int32_t* __restrict__ counter, unsigned long long* __restrict__ row_iters, int B, int m,
    int n, int wr, int wc, int max_iter, int it0, int team_threads, float alpha_fixed) {
  extern __shared__ int4 smem_team[];
  const int E = m * wr;
  const int wrp = round4(wr), wcp = round4(wc);
  int32_t* s_cv = reinterpret_cast<int32_t*>(smem_team);  // [m][wrp]
  int32_t* s_ve = s_cv + m * wrp;                            // [n][wcp]
  int32_t* s_deg = s_ve + n * wcp;                           // [m]
  for (int i = threadIdx.x; i < m * wrp; i += blockDim.x) {
    const int c = i / wrp, s = i - c * wrp;
    s_cv[i] = s < wr ? chk_var[c * wr + s] : n;
  }
  for (int i = threadIdx.x; i < n * wcp; i += blockDim.x) {
    const int v = i / wcp, j = i - v * wcp;
    const int e = j < wc ? var_edge[v * wc + j] : E;
    int ent = -1;
    if (e < E) {
      const int c = e / wr;
      ent = ((c * wrp + e - c * wr) << 2) | (e & 3);
    }
    s_ve[i] = ent;
  }
  for (int c = threadIdx.x; c < m; c += blockDim.x) s_deg[c] = deg[c];
  __syncthreads();

  const int team = threadIdx.x / team_threads;
  const int tid = threadIdx.x - team * team_threads;
  const Team tm{team + 1, team_threads};
  const int c2v_words = m * wrp;
  const int team_words = (kProd ? 2 : 1) * c2v_words + round4(n + 3);
  float* s_c2v0 = reinterpret_cast<float*>(s_cv + round4(m * wrp + n * wcp + m)) +
                  (size_t)team * team_words;
  float* s_c2v1 = kProd ? s_c2v0 + c2v_words : s_c2v0;  // c2v of iteration it in buffer it & 1
  float* s_tot = s_c2v0 + (kProd ? 2 : 1) * c2v_words;    // [n + 1]
  int32_t* s_row = reinterpret_cast<int32_t*>(s_tot + n + 1);  // [2] by fetch parity
  if (tid == 0) s_tot[n] = 1.0f;  // target of pad slots: not a hard 1

  for (int fetch = 0;; ++fetch) {
    int row;
    if (team_threads == 32) {
      __syncwarp();
      int r = 0;
      if (tid == 0) r = atomicAdd(counter, 1);
      row = __shfl_sync(0xffffffffu, r, 0);
    } else {
      if (tid == 0) s_row[fetch & 1] = atomicAdd(counter, 1);
      tm.sync();
      row = s_row[fetch & 1];
    }
    if (row >= B) return;

    const float* l0 = llr0 + (size_t)row * llr0_stride;
    const float* vin = v2c_in ? v2c_in + (size_t)row * E : nullptr;
    float* vout = v2c_out ? v2c_out + (size_t)row * E : nullptr;
    uint32_t syn = 0u;  // bit k: syndrome of check tid + k * team_threads
#pragma unroll
    for (int k = 0; k < kCPT; ++k) {
      const int c = tid + k * team_threads;
      if (c < m) syn |= (uint32_t)(synd[(size_t)row * m + c] & 1) << k;
    }
    // v2c of (check c, slot s) before the first iteration
    auto v2c_start = [&](int c, int s) {
      const int v = s_cv[c * wrp + s];
      return v < n ? (vin ? vin[c * wr + s] : __ldg(l0 + v)) : 0.0f;
    };

    if (skip && skip[row]) {  // born converged: hard 0, llr the prior
      for (int v = tid; v < n; v += team_threads) {
        hard[(size_t)row * n + v] = 0;
        llr[(size_t)row * n + v] = __ldg(l0 + v);
      }
      if (vout)
        for (int c = tid; c < m; c += team_threads)
          for (int s = 0; s < wr; ++s) vout[c * wr + s] = v2c_start(c, s);
      if (tid == 0) {
        conv[row] = 1;
        iters[row] = it0;
      }
      continue;
    }

    // ---- iteration it0 + 1: c2v from the starting v2c, then the totals ----
    MinSumMsg msg[kProd ? 1 : kCPT];
    {
      const float alpha = alpha_at(it0 + 1, alpha_fixed);
      float* out = ((it0 + 1) & 1) ? s_c2v1 : s_c2v0;
#pragma unroll
      for (int k = 0; k < kCPT; ++k) {
        const int c = tid + k * team_threads;
        if (c >= m) continue;
        const int dc = s_deg[c];
        if constexpr (kProd) {
          ps_check([&](int s) { return v2c_start(c, s); }, out + c * wrp, dc, (syn >> k) & 1);
        } else {
          MinSumAcc acc;
          acc.init();
          for (int s = 0; s < dc; ++s) acc.add(v2c_start(c, s), s);
          msg[k] = acc.finish(alpha, dc, (syn >> k) & 1);
          write_slots<0>(msg[k], out + c * wrp, dc);
        }
      }
    }
    tm.sync();
    variable_sums(s_ve, ((it0 + 1) & 1) ? s_c2v1 : s_c2v0, l0, s_tot, n, wcp, tid,
                  team_threads);
    tm.sync();

    for (int it = it0 + 1;; ++it) {
      // ---- check update of it + 1 from tot_it, with the parity of it ----
      const bool more = it < max_iter;
      const float alpha = alpha_at(it + 1, alpha_fixed);
      const float* prev = (it & 1) ? s_c2v1 : s_c2v0;  // c2v_it
      float* out = (it & 1) ? s_c2v0 : s_c2v1;         // c2v_{it+1} (min-sum: the same)
      int fail = 0;
      MinSumMsg next[kProd ? 1 : kCPT];
#pragma unroll
      for (int k = 0; k < kCPT; ++k) {
        const int c = tid + k * team_threads;
        if (c >= m) continue;
        const int dc = s_deg[c];
        const int sb = (syn >> k) & 1;
        const int32_t* cv = s_cv + c * wrp;  // the check's rows
        const float* cp = prev + c * wrp;
        float* co = out + c * wrp;
        int hp = sb;
        if constexpr (kProd) {
          for (int s = 0; s < dc; ++s) hp ^= s_tot[cv[s]] <= 0.0f;
          if (more) ps_check([&](int s) { return __fsub_rn(s_tot[cv[s]], cp[s]); }, co, dc, sb);
        } else {
          MinSumAcc acc;
          acc.init();
          if (wrp == 8) {
            check_slots<8>(cv, cp, s_tot, dc, hp, acc);
          } else if (wrp == 4) {
            check_slots<4>(cv, cp, s_tot, dc, hp, acc);
          } else {
            for (int g = 0; 4 * g < dc; ++g) {  // four slots a step, 16-byte reads
              const int4 v4 = reinterpret_cast<const int4*>(cv)[g];
              const float4 c4 = reinterpret_cast<const float4*>(cp)[g];  // own write
              const float tt[4] = {s_tot[v4.x], s_tot[v4.y], s_tot[v4.z], s_tot[v4.w]};
              const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (4 * g + j >= dc) continue;
                hp ^= tt[j] <= 0.0f;
                acc.add(__fsub_rn(tt[j], cc[j]), 4 * g + j);
              }
            }
          }
          next[k] = acc.finish(alpha, dc, sb);
          if (more) {
            if (wrp == 8) write_slots<8>(next[k], co);
            else if (wrp == 4) write_slots<4>(next[k], co);
            else write_slots<0>(next[k], co, dc);
          }
        }
        fail |= hp;
      }
      const int any_fail = tm.any(fail);

      if (!any_fail || !more) {  // emit tot_it and v2c_it
        for (int v = tid; v < n; v += team_threads) {
          const float t = s_tot[v];
          hard[(size_t)row * n + v] = (t <= 0.0f);
          llr[(size_t)row * n + v] = t;
        }
        if (vout) {
#pragma unroll
          for (int k = 0; k < kCPT; ++k) {
            const int c = tid + k * team_threads;
            if (c >= m) continue;
            const int dc = s_deg[c];
            for (int s = 0; s < wr; ++s) {
              float x = 0.0f;
              if (s < dc) {
                const int i = c * wrp + s;
                float c2v;
                if constexpr (kProd) c2v = prev[i];
                else c2v = ms_value(msg[k], s);
                x = __fsub_rn(s_tot[s_cv[i]], c2v);
              }
              vout[c * wr + s] = x;
            }
          }
        }
        if (tid == 0) {
          conv[row] = !any_fail;
          iters[row] = it;
          if (row_iters) atomicAdd(row_iters, (unsigned long long)(it - it0));
        }
        break;
      }
      if constexpr (!kProd) {
#pragma unroll
        for (int k = 0; k < kCPT; ++k) msg[k] = next[k];
      }
      variable_sums(s_ve, out, l0, s_tot, n, wcp, tid, team_threads);
      tm.sync();
    }
  }
}

using TeamKernel = void (*)(const uint8_t*, const float*, long long, const uint8_t*,
                            const float*, const int32_t*, const int32_t*, const int32_t*,
                            uint8_t*, float*, uint8_t*, int32_t*, float*, int32_t*,
                            unsigned long long*, int, int, int, int, int, int, int, int, float);

TeamKernel team_kernel(int cpt, int product_sum) {
  if (cpt <= 1) return product_sum ? bp_flood_team_kernel<1, true> : bp_flood_team_kernel<1, false>;
  if (cpt <= 2) return product_sum ? bp_flood_team_kernel<2, true> : bp_flood_team_kernel<2, false>;
  if (cpt <= 4) return product_sum ? bp_flood_team_kernel<4, true> : bp_flood_team_kernel<4, false>;
  return product_sum ? bp_flood_team_kernel<8, true> : bp_flood_team_kernel<8, false>;
}

// ---------------------------------------------------------------------------
// Latency plan: a block an SM, its check rows in registers.

constexpr int kLatVPT = 3;      // variables a thread
constexpr int kLatMaxRows = 2;  // rows a block

// Shared memory of a latency-kernel block of T threads and kR rows, rows of
// kS slots, in bytes: the variable rows [T * kLatVPT] (an int4 each), then
// a region a row: the totals [T * kLatVPT + 2] (the last two are the check
// pads' +inf and the variable pads' +0.0f), c2v warp-tiled [T / 32][kS][32]
// (the word of check c, slot s at (c / 32 * kS + s) * 32 + c % 32) and, for
// kR > 1, the row's priors [T * kLatVPT]; every part a multiple of 16
// bytes.  Checks past m and variables past n are pads that no real one
// reads.
__host__ __device__ inline int latency_c2v0(int T) { return 4 * round4(T * kLatVPT + 2); }
__host__ __device__ inline int latency_prior0(int T, int kS) {
  return latency_c2v0(T) + 4 * kS * T;
}
__host__ __device__ inline int latency_region(int T, int kR, int kS) {
  return latency_prior0(T, kS) + (kR > 1 ? 4 * T * kLatVPT : 0);
}
__host__ __device__ inline int latency_smem(int T, int kR, int kS) {
  return 16 * T * kLatVPT + kR * latency_region(T, kR, kS);
}

// Rows b, b + gridDim.x, ... (at most kR, below B) in block b of T threads,
// columns of at most kW (3 or 4) edges.  Thread t owns check t and
// variables t, t + T, t + 2T of every row, pads past m and n included, so
// the iteration tests no bound, a warp's loads and stores of the variable
// rows and totals are contiguous, and each shared address is a register
// plus a constant or the row's region.  It keeps in registers, for the
// whole launch, its check's chk_var row as byte offsets of the totals in a
// row's region (pad: the +inf at T * 3, so the hard-decision parity skips
// it and its v2c enters the minimum above the 1e30 cap, which changes
// nothing) and its degree; a row's syndrome bit and compressed min-sum
// message; with one row, its variables' priors (with two, they are in each
// row's region).  Shared memory (latency_smem) holds the variable rows
// once, an int4 a variable, each entry its c2v word's byte offset in a
// region with the lane e % 4 in the low two bits (pad: the +0.0f after the
// +inf, in lane 3, which adds nothing to a lane sum that is never -0.0f),
// then each row's totals and c2v, warp-tiled so a warp's stores of one
// slot are contiguous.  The iteration is the team kernel's, with block
// barriers; a row that stops keeps its totals and message untouched until
// every row of the block has stopped, and the emit follows.  The first
// iteration, a skip row and the emit read chk_var from device memory.
template <int kS, int kR, int kW>
__global__ void __launch_bounds__(1024, 1) bp_flood_team_kernel_latency(
    const uint8_t* __restrict__ synd, const float* __restrict__ llr0, long long llr0_stride,
    const uint8_t* __restrict__ skip, const float* __restrict__ v2c_in,
    const int32_t* __restrict__ chk_var, const int32_t* __restrict__ var_edge,
    const int32_t* __restrict__ deg, uint8_t* __restrict__ hard, float* __restrict__ llr,
    uint8_t* __restrict__ conv, int32_t* __restrict__ iters, float* __restrict__ v2c_out,
    unsigned long long* __restrict__ row_iters, int B, int m, int n, int wr, int wc,
    int max_iter, int it0, float alpha_fixed) {
  constexpr int kV = kLatVPT;
  extern __shared__ int4 smem_lat[];
  __shared__ unsigned s_fail[2];  // the rows' parity failures by iteration parity (kR > 1)
  __shared__ int s_stop[kR];      // the iteration each row stopped at
  const int E = m * wr;
  const int T = blockDim.x, tid = threadIdx.x;
  const int pad = T * kV;  // the pads' total
  char* base = reinterpret_cast<char*>(smem_lat);
  int4* s_ve = reinterpret_cast<int4*>(base);  // [pad]
  const int c2v0 = latency_c2v0(T);
  char* reg0 = base + 16 * pad;  // the first row's region
  const int region = latency_region(T, kR, kS);
  const int prior0 = latency_prior0(T, kS);
  auto tot_of = [&](int r) { return reinterpret_cast<float*>(reg0 + r * region); };
  auto at = [&](int r, int off) -> float {
    return *reinterpret_cast<const float*>(reg0 + r * region + off);
  };
  auto c2v_off = [&](int c, int s) { return c2v0 + 4 * (((c >> 5) * kS + s) * 32 + (c & 31)); };

  int rows[kR];
  int nrows = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    rows[r] = blockIdx.x + r * gridDim.x;
    if (rows[r] < B) nrows = r + 1;
  }
  if (tid == 0) {
    for (int r = 0; r < kR; ++r) {
      tot_of(r)[pad] = __int_as_float(0x7f800000);  // +inf
      tot_of(r)[pad + 1] = 0.0f;
    }
    s_fail[0] = s_fail[1] = 0u;
  }
  auto l0_of = [&](int r) { return llr0 + (size_t)rows[r] * llr0_stride; };

  const int c = tid;
  const bool own_c = c < m;
  const int dc = own_c ? deg[c] : 0;
  int cv[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int v = own_c && s < wr ? chk_var[c * wr + s] : n;
    cv[s] = 4 * (v < n ? v : pad);
  }
  unsigned syn = 0u;  // bit r: the syndrome of check c in row r
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (own_c && r < nrows) syn |= (unsigned)(synd[(size_t)rows[r] * m + c] & 1) << r;
  float l0r[kR == 1 ? kV : 1];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int v = tid + j * T;
    const bool own = v < n;
    if constexpr (kR == 1) {
      l0r[j] = own ? __ldg(l0_of(0) + v) : 0.0f;
    } else {
      for (int r = 0; r < nrows; ++r)
        *reinterpret_cast<float*>(reg0 + r * region + prior0 + 4 * v) =
            own ? __ldg(l0_of(r) + v) : 0.0f;
    }
    int ent[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = own && q < wc ? var_edge[v * wc + q] : E;
      const int ce = e / wr;
      ent[q] = e < E ? c2v_off(ce, e - ce * wr) | (e & 3) : (4 * (pad + 1)) | 3;
    }
    s_ve[v] = make_int4(ent[0], ent[1], ent[2], ent[3]);
  }
  // v2c of (check cc, slot s) of row r before the first iteration
  auto v2c_start = [&](int r, int cc, int s) {
    const int v = chk_var[cc * wr + s];
    return v < n ? (v2c_in ? v2c_in[(size_t)rows[r] * E + cc * wr + s] : __ldg(l0_of(r) + v))
                 : 0.0f;
  };

  unsigned live = 0u;  // bit r: row r still iterates
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= nrows) continue;
    if (!(skip && skip[rows[r]])) {
      live |= 1u << r;
      continue;
    }
    const size_t row = rows[r];  // born converged: hard 0, llr the prior
    for (int v = tid; v < n; v += T) {
      hard[row * n + v] = 0;
      llr[row * n + v] = __ldg(l0_of(r) + v);
    }
    if (v2c_out)
      for (int cc = tid; cc < m; cc += T)
        for (int s = 0; s < wr; ++s) v2c_out[row * E + cc * wr + s] = v2c_start(r, cc, s);
    if (tid == 0) {
      conv[row] = 1;
      iters[row] = it0;
    }
  }
  if (!live) return;  // the same in every thread

  auto variable_sums = [&]() {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = tid + j * T;
      const int4 e4 = s_ve[v];
      const int ent[4] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (!(live >> r & 1)) continue;
        float x[4];
#pragma unroll
        for (int q = 0; q < kW; ++q) x[q] = at(r, ent[q] & ~3);
        LaneSum a{0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int q = 0; q < kW; ++q) a.add(ent[q] & 3, x[q]);
        float prior;
        if constexpr (kR == 1) prior = l0r[j];
        else prior = at(r, prior0 + 4 * v);
        tot_of(r)[v] = a.total(prior);
      }
    }
  };
  // c2v of check c's kS slots in row r (pads too: nothing reads them), 128
  // bytes apart
  auto write_c2v = [&](int r, const MinSumMsg& q) {
    float* p = reinterpret_cast<float*>(reg0 + r * region + c2v_off(c, 0));
#pragma unroll
    for (int s = 0; s < kS; ++s) p[32 * s] = ms_value(q, s);
  };

  // ---- iteration it0 + 1: c2v from the starting v2c, then the totals ----
  MinSumMsg msg[kR];
  {
    const float alpha = alpha_at(it0 + 1, alpha_fixed);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (!(live >> r & 1)) continue;
      MinSumAcc acc;
      acc.init();
      for (int s = 0; s < dc; ++s) acc.add(v2c_start(r, c, s), s);
      msg[r] = acc.finish(alpha, dc, syn >> r & 1);
      write_c2v(r, msg[r]);
    }
  }
  __syncthreads();
  variable_sums();
  __syncthreads();

  unsigned ok = 0u;  // bit r: row r converged
  // alpha_at(t) = 1 - 2^-t by halving 2^-t each iteration: exact, as ldexpf
  // (2^-150 rounds to 0 as ldexpf(1, -150) does)
  float two_t = ldexpf(1.0f, -(it0 + 2));
  for (int it = it0 + 1;; ++it) {
    // ---- check update of it + 1 from tot_it, with the parity of it ----
    const bool more = it < max_iter;
    const float alpha = alpha_fixed == 0.0f ? __fsub_rn(1.0f, two_t) : alpha_fixed;
    two_t = __fmul_rn(two_t, 0.5f);
    unsigned fail = 0u;
    MinSumMsg next[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (!(live >> r & 1)) continue;
      float tt[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) tt[s] = at(r, cv[s]);
      int hp = syn >> r & 1;
      MinSumAcc acc;
      acc.init();
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        hp ^= tt[s] <= 0.0f;
        acc.add(__fsub_rn(tt[s], ms_value(msg[r], s)), s);  // a pad: +inf
      }
      fail |= (unsigned)hp << r;
      next[r] = acc.finish(alpha, dc, syn >> r & 1);
      if (more) write_c2v(r, next[r]);
      if (r + 1 < kR) __syncwarp();  // one row's loads in flight
    }
    unsigned any_fail;
    if constexpr (kR == 1) {
      any_fail = __syncthreads_or(fail) ? 1u : 0u;
    } else {  // the rows' failures ORed by warp, then across the block
      const unsigned w = __reduce_or_sync(0xffffffffu, fail);
      if ((tid & 31) == 0 && w) atomicOr(&s_fail[it & 1], w);
      __syncthreads();
      any_fail = s_fail[it & 1];
      if (tid == 0) s_fail[(it + 1) & 1] = 0u;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (!(live >> r & 1)) continue;
      if (!(any_fail >> r & 1) || !more) {  // row r stops at it: tot_it and msg stay
        live &= ~(1u << r);
        if (tid == 0) s_stop[r] = it;
        if (!(any_fail >> r & 1)) ok |= 1u << r;
      } else {
        msg[r] = next[r];
      }
    }
    if (!live) break;
    variable_sums();
    __syncthreads();
  }

  // ---- emit each row's tot and v2c at its stop (c2v from the message) ----
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= nrows || (skip && skip[rows[r]])) continue;
    const size_t row = rows[r];
    const float* tot = tot_of(r);
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int v = tid + j * T;
      if (v < n) {
        hard[row * n + v] = (tot[v] <= 0.0f);
        llr[row * n + v] = tot[v];
      }
    }
    if (v2c_out && own_c)
      for (int s = 0; s < wr; ++s)
        v2c_out[row * E + c * wr + s] =
            s < dc ? __fsub_rn(tot[chk_var[c * wr + s]], ms_value(msg[r], s)) : 0.0f;
    if (tid == 0) {
      conv[row] = ok >> r & 1;
      iters[row] = s_stop[r];
      if (row_iters) atomicAdd(row_iters, (unsigned long long)(s_stop[r] - it0));
    }
  }
}

using LatencyKernel = void (*)(const uint8_t*, const float*, long long, const uint8_t*,
                               const float*, const int32_t*, const int32_t*, const int32_t*,
                               uint8_t*, float*, uint8_t*, int32_t*, float*,
                               unsigned long long*, int, int, int, int, int, int, int, float);

// The instance for kS = wr rounded up to 4 or 8, kR rows a block and kW =
// wc rounded up to 3 or 4.
LatencyKernel latency_kernel(int wr, int rows, int wc) {
  static const LatencyKernel kernels[8] = {
      bp_flood_team_kernel_latency<4, 1, 3>, bp_flood_team_kernel_latency<4, 1, 4>,
      bp_flood_team_kernel_latency<4, 2, 3>, bp_flood_team_kernel_latency<4, 2, 4>,
      bp_flood_team_kernel_latency<8, 1, 3>, bp_flood_team_kernel_latency<8, 1, 4>,
      bp_flood_team_kernel_latency<8, 2, 3>, bp_flood_team_kernel_latency<8, 2, 4>};
  return kernels[(wr > 4) * 4 + (rows > 1) * 2 + (wc > 3)];
}

// ---------------------------------------------------------------------------
// Wide plan: a block an SM for a row whose tables and one team do not fit.

constexpr int kWideThreads = 1024;  // threads of a wide-kernel block
constexpr int kWideMaxCPT = 4;      // checks a thread
constexpr int kWideMaxVPT = 8;      // variables a thread
constexpr int kWideSlots = 8;       // slots of a check's table row

// Shared memory of a wide-kernel block, in bytes, every part a multiple of
// 16: the check rows cv [m][8] uint16 (each slot the index of its total,
// pad n), the variable columns ve [wc][n] uint16 (entry q of variable v at
// q * n + v: its edge's check c and slot s as c * 8 + s, pad m * 8), the
// totals [n + 1] (tot[n] = +inf, the check pads' target), the priors [n],
// and the compressed messages [m + 1] (an int4 a check: m1a, m2a, sign
// and first-minimum bits, a pad; check m the variable pads' +0.0).
__host__ __device__ inline int round16(int bytes) { return (bytes + 15) & ~15; }
__host__ __device__ inline int wide_ve0(int m) { return 16 * m; }
__host__ __device__ inline int wide_tot0(int m, int n, int wc) {
  return wide_ve0(m) + round16(2 * wc * n);
}
__host__ __device__ inline int wide_prior0(int m, int n, int wc) {
  return wide_tot0(m, n, wc) + round16(4 * (n + 1));
}
__host__ __device__ inline int wide_msg0(int m, int n, int wc) {
  return wide_prior0(m, n, wc) + round16(4 * n);
}
__host__ __device__ inline int wide_smem(int m, int n, int wc) {
  return wide_msg0(m, n, wc) + 16 * (m + 1);
}

// Persistent blocks of kWideThreads threads, min(B, SMs) of them: block b
// decodes row b first, then the rows a global counter hands out (gridDim.x
// + atomicAdd) as it finishes one, until they run out, so a block that
// meets a short row takes the next at once and a launch of at most SMs rows
// (counter null) is one row a block.  The tables with 16-bit entries are loaded into shared
// memory once a block, and so are the priors when they are broadcast
// (llr0_stride 0); a row sets up only its syndrome bits, its priors if it
// has its own, its totals and its messages.  Thread t owns checks t + k * T
// (k < kC) and variables t, t + T, ...  It keeps in registers its checks'
// degrees, syndrome bits and compressed messages; shared memory (wide_smem)
// holds the tables and the row's totals, priors and messages, so a
// variable rebuilds each c2v it sums from its check's message (ms_value): a
// message is 16 bytes a check where c2v would be 4 a slot.  A check's new
// message goes to shared memory as it is made, and comes back into the
// thread's registers after the barrier if the row goes on, so the old one
// stays for the emit and only one is held a check.  The iteration is the
// latency kernel's, with block barriers; the lane of an edge is its flat
// index (c * wr + s) % 4, each lane summed in ascending edge order.  A
// check pad slot reads the +inf total, as in the latency kernel; a variable
// pad entry names check m's message, +0.0, which leaves any lane sum alone
// (a sum from +0.0 is never -0.0).
template <int kC>
__global__ void __launch_bounds__(kWideThreads, 1) bp_flood_wide_kernel(
    const uint8_t* __restrict__ synd, const float* __restrict__ llr0, long long llr0_stride,
    const uint8_t* __restrict__ skip, const float* __restrict__ v2c_in,
    const int32_t* __restrict__ chk_var, const int32_t* __restrict__ var_edge,
    const int32_t* __restrict__ deg, uint8_t* __restrict__ hard, float* __restrict__ llr,
    uint8_t* __restrict__ conv, int32_t* __restrict__ iters, float* __restrict__ v2c_out,
    int32_t* __restrict__ counter, unsigned long long* __restrict__ row_iters,
    unsigned long long* __restrict__ wide_iters, int B, int m, int n, int wr, int wc,
    int max_iter, int it0, float alpha_fixed) {
  extern __shared__ int4 smem_wide[];
  __shared__ int s_next[2];  // the block's next row, by fetch parity
  char* base = reinterpret_cast<char*>(smem_wide);
  uint16_t* s_cv = reinterpret_cast<uint16_t*>(base);                      // [m][8]
  uint16_t* s_ve = reinterpret_cast<uint16_t*>(base + wide_ve0(m));        // [wc][n]
  float* s_tot = reinterpret_cast<float*>(base + wide_tot0(m, n, wc));     // [n + 1]
  float* s_l0 = reinterpret_cast<float*>(base + wide_prior0(m, n, wc));    // [n]
  int4* s_msg = reinterpret_cast<int4*>(base + wide_msg0(m, n, wc));       // [m + 1]
  const int T = blockDim.x, tid = threadIdx.x;
  const int E = m * wr;

  // ---- once a block: the tables, the pads, the degrees, a broadcast prior ----
  for (int i = tid; i < m * kWideSlots; i += T) {
    const int c = i / kWideSlots, s = i - c * kWideSlots;
    const int v = s < wr ? chk_var[c * wr + s] : n;
    s_cv[i] = (uint16_t)(v < n ? v : n);
  }
  for (int i = tid; i < wc * n; i += T) {
    const int q = i / n, v = i - q * n;
    const int e = var_edge[v * wc + q];
    const int c = e / wr;
    s_ve[i] = (uint16_t)(e < E ? c * kWideSlots + e - c * wr : m * kWideSlots);
  }
  if (llr0_stride == 0)
    for (int v = tid; v < n; v += T) s_l0[v] = __ldg(llr0 + v);
  if (tid == 0) {
    s_tot[n] = __int_as_float(0x7f800000);  // +inf
    s_msg[m] = make_int4(0, 0, 0, 0);
  }
  int dc[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const int c = tid + k * T;
    dc[k] = c < m ? deg[c] : 0;
  }

  auto store = [&](int c, const MinSumMsg& q) {
    s_msg[c] = make_int4(__float_as_int(q.m1a), __float_as_int(q.m2a), (int)q.sg, 0);
  };
  auto load = [&](int c) {
    const int4 w = s_msg[c];
    return MinSumMsg{__int_as_float(w.x), __int_as_float(w.y), (uint32_t)w.z};
  };
  auto variable_sums = [&]() {
#pragma unroll 2
    for (int v = tid; v < n; v += T) {
      LaneSum a{0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= wc) continue;
        const int ent = s_ve[q * n + v];
        const int c = ent >> 3, s = ent & 7;
        a.add((c * wr + s) & 3, ms_value(load(c), s));
      }
      s_tot[v] = a.total(s_l0[v]);
    }
  };

  // One row, from its syndrome to its emit; every thread of the block runs it.
  auto decode_row = [&](size_t row) {
    const float* l0 = llr0 + row * llr0_stride;
    if (skip && skip[row]) {  // born converged: hard 0, llr the prior
      for (int v = tid; v < n; v += T) {
        hard[row * n + v] = 0;
        llr[row * n + v] = __ldg(l0 + v);
      }
      if (v2c_out)
        for (int e = tid; e < E; e += T) {
          const int v = chk_var[e];
          v2c_out[row * E + e] = v < n ? (v2c_in ? v2c_in[row * E + e] : __ldg(l0 + v)) : 0.0f;
        }
      if (tid == 0) {
        conv[row] = 1;
        iters[row] = it0;
      }
      return;
    }
    if (llr0_stride != 0)
      for (int v = tid; v < n; v += T) s_l0[v] = __ldg(l0 + v);
    unsigned syn = 0u;  // bit k: the syndrome of check tid + k * T
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const int c = tid + k * T;
      if (c < m) syn |= (unsigned)(synd[row * m + c] & 1) << k;
    }

    // ---- iteration it0 + 1: c2v from the starting v2c, then the totals ----
    MinSumMsg msg[kC];
    {
      const float alpha = alpha_at(it0 + 1, alpha_fixed);
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int c = tid + k * T;
        if (c >= m) continue;
        MinSumAcc acc;
        acc.init();
        for (int s = 0; s < dc[k]; ++s) {
          const int v = chk_var[c * wr + s];
          acc.add(v2c_in ? v2c_in[row * E + c * wr + s] : __ldg(l0 + v), s);
        }
        msg[k] = acc.finish(alpha, dc[k], syn >> k & 1);
        store(c, msg[k]);
      }
    }
    __syncthreads();
    variable_sums();
    __syncthreads();

    int stop, fail_at_stop;
    // alpha_at(t) = 1 - 2^-t by halving 2^-t each iteration, as the latency kernel
    float two_t = ldexpf(1.0f, -(it0 + 2));
    for (int it = it0 + 1;; ++it) {
      // ---- check update of it + 1 from tot_it, with the parity of it ----
      const bool more = it < max_iter;
      const float alpha = alpha_fixed == 0.0f ? __fsub_rn(1.0f, two_t) : alpha_fixed;
      two_t = __fmul_rn(two_t, 0.5f);
      int fail = 0;
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int c = tid + k * T;
        if (c >= m) continue;
        const int4 row4 = reinterpret_cast<const int4*>(s_cv)[c];
        const uint32_t w[4] = {(uint32_t)row4.x, (uint32_t)row4.y, (uint32_t)row4.z,
                               (uint32_t)row4.w};
        float tt[kWideSlots];
#pragma unroll
        for (int s = 0; s < kWideSlots; ++s)
          tt[s] = s_tot[(w[s >> 1] >> (16 * (s & 1))) & 0xffffu];
        int hp = syn >> k & 1;
        MinSumAcc acc;
        acc.init();
#pragma unroll
        for (int s = 0; s < kWideSlots; ++s) {
          hp ^= tt[s] <= 0.0f;
          acc.add(__fsub_rn(tt[s], ms_value(msg[k], s)), s);  // a pad: +inf
        }
        fail |= hp;
        if (more) store(c, acc.finish(alpha, dc[k], syn >> k & 1));  // the one of it + 1
      }
      const int any_fail = __syncthreads_or(fail);
      if (!any_fail || !more) {  // stop at it: tot_it and msg stay
        stop = it;
        fail_at_stop = any_fail;
        break;
      }
#pragma unroll
      for (int k = 0; k < kC; ++k)
        if (tid + k * T < m) msg[k] = load(tid + k * T);
      variable_sums();
      __syncthreads();
    }

    // ---- emit tot and v2c at the stop (c2v from the message) ----
    for (int v = tid; v < n; v += T) {
      const float t = s_tot[v];
      hard[row * n + v] = (t <= 0.0f);
      llr[row * n + v] = t;
    }
    if (v2c_out) {
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int c = tid + k * T;
        if (c >= m) continue;
        for (int s = 0; s < wr; ++s)
          v2c_out[row * E + c * wr + s] =
              s < dc[k] ? __fsub_rn(s_tot[s_cv[c * kWideSlots + s]], ms_value(msg[k], s))
                        : 0.0f;
      }
    }
    if (tid == 0) {
      conv[row] = !fail_at_stop;
      iters[row] = stop;
      if (row_iters) atomicAdd(row_iters, (unsigned long long)(stop - it0));
      if (wide_iters) atomicAdd(wide_iters, (unsigned long long)(stop - it0));
    }
  };

  // The next row is fetched once a row has ended, so it goes to the block
  // that is free first (a fetch as the row starts would tie it to a block
  // still busy with a long row), and read after a barrier, which also keeps
  // the row's emit off the next row's totals.  It is kept in the slot of
  // its fetch's parity, so the fetch after row k + 1 cannot overwrite the
  // slot a thread has yet to read after row k.
  int row = blockIdx.x;
  for (int fetch = 0; row < B; ++fetch) {
    decode_row((size_t)row);
    if (tid == 0) s_next[fetch & 1] = counter ? (int)gridDim.x + atomicAdd(counter, 1) : B;
    __syncthreads();
    row = s_next[fetch & 1];
  }
}

using WideKernel = void (*)(const uint8_t*, const float*, long long, const uint8_t*,
                            const float*, const int32_t*, const int32_t*, const int32_t*,
                            uint8_t*, float*, uint8_t*, int32_t*, float*, int32_t*,
                            unsigned long long*, unsigned long long*, int, int, int, int, int,
                            int, int, float);

WideKernel wide_kernel(int cpt) {
  static const WideKernel kernels[kWideMaxCPT] = {
      bp_flood_wide_kernel<1>, bp_flood_wide_kernel<2>, bp_flood_wide_kernel<3>,
      bp_flood_wide_kernel<4>};
  return kernels[cpt - 1];
}


}  // namespace

// Shared memory of one sample's whole state in the first design (tables,
// syndrome, v2c, c2v, totals, prior): the boundary of the shared-memory
// placement (ops/cuda_bp.py:k1_fits).
extern "C" size_t bp_flood_smem_bytes(int m, int n, int wr, int wc) {
  const size_t E = (size_t)m * wr;
  return 4 * (E + (size_t)n * wc + m + 2 * E + 2 * (size_t)n);
}

// Team kernel: shared memory of the tables a block loads once, and of one
// sample team's state (c2v, once or twice, totals, two row slots).
extern "C" size_t bp_flood_table_bytes(int m, int n, int wr, int wc) {
  return 4 * (size_t)round4(m * round4(wr) + n * round4(wc) + m);
}
extern "C" size_t bp_flood_team_bytes(int m, int n, int wr, int product_sum) {
  return 4 * ((product_sum ? 2 : 1) * (size_t)m * round4(wr) + round4(n + 3));
}

// Scratch words of one sample in the device-memory placement.
extern "C" size_t bp_flood_scratch_words(int m, int n, int wr) {
  return (size_t)m + 2 * (size_t)m * wr + 2 * (size_t)n;
}

namespace {

// Guards the per-card caches below (team_attributes, team_warps_of):
// shards on several cards plan from several threads.  bp_flood_plan holds
// it for the whole plan.
std::mutex plan_mu;

// Attributes of a team-kernel instance on card `dev`, read once a card; its
// dynamic shared memory limit is raised to the block maximum on first use
// there (the runtime keeps that limit per card).  The caller holds plan_mu
// and has `dev` current.
cudaError_t team_attributes(int dev, int cpt, int product_sum, cudaFuncAttributes* attr) {
  struct Entry {
    int dev, product_sum, key;
    cudaFuncAttributes attr;
  };
  static std::vector<Entry> cache;
  const int key = cpt <= 1 ? 1 : cpt <= 2 ? 2 : cpt <= 4 ? 4 : 8;
  for (const Entry& e : cache) {
    if (e.dev == dev && e.product_sum == product_sum && e.key == key) {
      *attr = e.attr;
      return cudaSuccess;
    }
  }
  TeamKernel kernel = team_kernel(key, product_sum);
  Entry e{dev, product_sum, key, {}};
  cudaError_t err = cudaFuncGetAttributes(&e.attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return err;
  cache.push_back(e);
  *attr = e.attr;
  return cudaSuccess;
}

// Teams of `warps` warps: out = {team threads, teams a block, blocks an SM,
// dynamic shared memory, registers}, with at most `cap` teams a block, on
// card `dev`.  The caller holds plan_mu.
cudaError_t team_shape(int dev, int warps, int m, int n, int wr, int wc, int product_sum,
                       long long cap, int* out) {
  const int T = 32 * warps;
  const int cpt = (m + T - 1) / T;
  if (T > 1024 || cpt > kMaxChecksPerThread) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = team_attributes(dev, cpt, product_sum, &attr);
  if (err != cudaSuccess) return err;
  const long long tables = (long long)bp_flood_table_bytes(m, n, wr, wc);
  const long long team = (long long)bp_flood_team_bytes(m, n, wr, product_sum);
  long long teams = (kSmemLimit - tables - (long long)attr.sharedSizeBytes) / team;
  if (teams > attr.maxThreadsPerBlock / T) teams = attr.maxThreadsPerBlock / T;
  if (T > 32 && teams > kMaxWarpTeams) teams = kMaxWarpTeams;
  if (teams > cap) teams = cap;
  if (teams < 1) return cudaErrorInvalidValue;
  const int smem = (int)(tables + teams * team);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, team_kernel(cpt, product_sum),
                                                      (int)teams * T, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  out[0] = T;
  out[1] = (int)teams;
  out[2] = per_sm;
  out[3] = smem;
  out[4] = attr.numRegs;
  return cudaSuccess;
}

// The warps of a team for this graph, chosen on first use and kept.  A
// team's iteration costs about the work of its busiest thread, path =
// ceil(m/T) * wr + ceil(n/T) * wc slot and edge updates between its two
// barriers.  Among teams of 1 to 8 warps that keep a thread at <= 8 checks,
// the one of most resident teams per path (the most sample-iterations an SM
// runs at a time).  The team size ignores the batch size; the plan does not
// (bp_flood_plan takes launches that under-fill the card to the latency
// kernel, min-sum only), so at small batches the team kernel's build runs in
// the product-sum, wide-row and forced-team (_TEAM_WARPS) checks.  Kept per
// card; the caller holds plan_mu.
cudaError_t team_warps_of(int dev, int m, int n, int wr, int wc, int product_sum, int* warps) {
  struct Choice {
    int key[6];
    int warps;
  };
  static std::vector<Choice> chosen;
  const int key[6] = {dev, m, n, wr, wc, product_sum};
  for (const Choice& c : chosen) {
    if (std::equal(key, key + 6, c.key)) {
      *warps = c.warps;
      return cudaSuccess;
    }
  }
  const int lo = (m + 32 * kMaxChecksPerThread - 1) / (32 * kMaxChecksPerThread);
  const int hi_all = (m + 31) / 32;
  const int hi = hi_all < lo + 7 ? hi_all : lo + 7;
  int best = 0;
  double best_rate = -1.0;
  for (int w = lo; w <= hi; ++w) {
    int shape[5];
    if (team_shape(dev, w, m, n, wr, wc, product_sum, LLONG_MAX, shape) != cudaSuccess) continue;
    const int T = 32 * w;
    const long long path = (long long)((m + T - 1) / T) * wr + (long long)((n + T - 1) / T) * wc;
    const double rate = (double)shape[1] * shape[2] / (double)path;
    if (rate > best_rate) {
      best_rate = rate;
      best = w;
    }
  }
  if (!best) return cudaErrorInvalidValue;
  Choice c{{dev, m, n, wr, wc, product_sum}, best};
  chosen.push_back(c);
  *warps = best;
  return cudaSuccess;
}

// The latency plan for B rows, k = ceil(B / SMs) of them in the busiest
// SM's block: out = {block threads, blocks an SM, dynamic shared memory,
// registers}.  The block is the whole-row team of 32 * ceil(m / 32)
// threads, a check a thread, for k <= 2 rows; the kernel takes m <= 1024,
// n <= 3 * threads, rows of <= 8 slots and columns of <= 4, and a block an
// SM (the occupancy query).  cudaErrorNotSupported where any of it fails.
// The caller holds plan_mu and has `dev` current.
cudaError_t latency_shape(int dev, long long k, int m, int n, int wr, int wc, int* out) {
  const int T = 32 * ((m + 31) / 32);
  if (wr > 8 || wc > 4 || T > 1024 || n > kLatVPT * T || k > kLatMaxRows)
    return cudaErrorNotSupported;
  LatencyKernel kernel = latency_kernel(wr, (int)k, wc);
  struct Entry {
    int dev;
    LatencyKernel kernel;
    cudaFuncAttributes attr;
  };
  static std::vector<Entry> cache;  // attributes a card, the shared memory limit raised
  const Entry* hit = nullptr;
  for (const Entry& e : cache)
    if (e.dev == dev && e.kernel == kernel) hit = &e;
  if (!hit) {
    Entry e{dev, kernel, {}};
    cudaError_t err = cudaFuncGetAttributes(&e.attr, kernel);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit - (int)e.attr.sharedSizeBytes);
    if (err != cudaSuccess) return err;
    cache.push_back(e);
    hit = &cache.back();
  }
  const int smem = latency_smem(T, (int)k, wr > 4 ? 8 : 4);
  if (smem + (int)hit->attr.sharedSizeBytes > kSmemLimit) return cudaErrorNotSupported;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorNotSupported;
  out[0] = T;
  out[1] = per_sm;
  out[2] = smem;
  out[3] = hit->attr.numRegs;
  return cudaSuccess;
}

// Whether the team kernel takes the graph, as ops/cuda_bp.py:k1_fits decides
// it: one sample's whole state in the first design fits a block, the row
// weight is at most 27, the smallest team (team_shape's rule: the fewest
// warps that keep a thread at <= 8 checks) has at most 1024 threads, and the
// tables and one team fit a block.
bool team_graph(int m, int n, int wr, int wc, int product_sum) {
  const int warps = (m + 32 * kMaxChecksPerThread - 1) / (32 * kMaxChecksPerThread);
  const size_t tables = 4 * (size_t)round4(m * round4(wr) + n * round4(wc) + m);
  const size_t team = 4 * ((product_sum ? 2 : 1) * (size_t)m * round4(wr) + round4(n + 3));
  const size_t E = (size_t)m * wr;
  const size_t first = 4 * (E + (size_t)n * wc + m + 2 * E + 2 * (size_t)n);
  return first <= (size_t)kSmemLimit && wr <= kMaxRowWeight && 32 * warps <= 1024 &&
         tables + team <= (size_t)kSmemLimit;
}

// The wide plan: out = {block threads, blocks an SM, dynamic shared memory,
// registers}.  The kernel takes rows of <= 8 slots, columns of <= 4, m <= 4
// * 1024 and n <= 8 * 1024 (its checks and variables a thread), 16-bit table
// entries (n + 1 and 8 * (m + 1) at most 65536), and wide_smem within a
// block, at any batch (its blocks are persistent).  cudaErrorNotSupported
// where any of it fails.  The caller holds plan_mu and has `dev` current.
cudaError_t wide_shape(int dev, int m, int n, int wr, int wc, int* out) {
  const int T = kWideThreads;
  const int cpt = (m + T - 1) / T;
  if (wr > kWideSlots || wc > 4 || cpt > kWideMaxCPT || n > kWideMaxVPT * T ||
      n + 1 > 65536 || 8 * (m + 1) > 65536)
    return cudaErrorNotSupported;
  WideKernel kernel = wide_kernel(cpt);
  struct Entry {
    int dev;
    WideKernel kernel;
    cudaFuncAttributes attr;
  };
  static std::vector<Entry> cache;  // attributes a card, the shared memory limit raised
  const Entry* hit = nullptr;
  for (const Entry& e : cache)
    if (e.dev == dev && e.kernel == kernel) hit = &e;
  if (!hit) {
    Entry e{dev, kernel, {}};
    cudaError_t err = cudaFuncGetAttributes(&e.attr, kernel);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit - (int)e.attr.sharedSizeBytes);
    if (err != cudaSuccess) return err;
    cache.push_back(e);
    hit = &cache.back();
  }
  const int smem = wide_smem(m, n, wc);
  if (smem + (int)hit->attr.sharedSizeBytes > kSmemLimit) return cudaErrorNotSupported;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorNotSupported;
  out[0] = T;
  out[1] = per_sm;
  out[2] = smem;
  out[3] = hit->attr.numRegs;
  return cudaSuccess;
}

}  // namespace

// K1's launch for B rows: out = {team threads, teams a block, blocks an SM,
// grid, dynamic shared memory bytes, registers a thread, plan: 0 throughput,
// 1 latency, 2 wide}.  For graphs the team kernel takes (team_graph), two
// plans, from B, the card's SM count and the graph alone:
//   * throughput (out[6] = 0): the team kernel with the team of
//     team_warps_of, wherever the launch fills the card, B at or above SMs
//     times the resident teams an SM; below it where the latency plan does
//     not take the launch, fewer teams a block (about B / SMs), so the rows
//     spread over the SMs;
//   * latency (out[6] = 1), below that for min-sum, where latency_shape
//     takes the graph at k = ceil(B / SMs) (1 or 2): the latency kernel,
//     min(B, SMs) blocks of k rows at most (out[1]), rows b and b + SMs in
//     block b, so B - SMs blocks hold two rows and the rest one.
// For min-sum graphs the team kernel does not take, the wide plan (out[6] =
// 2) where wide_shape takes the graph: the wide kernel, min(B, SMs)
// persistent blocks of one row at a time (out[3]), rows past the grid handed
// out by a counter.
// team_warps > 0 forces the throughput plan with teams of that many warps.
// Returns 0, or cudaErrorInvalidValue for a graph the team kernel does not
// take (row weight above 27, more than 1024 threads a team, or a team that
// does not fit a block) and no wide plan takes, or the CUDA error of a query.
// Plans for the current card.
extern "C" int bp_flood_plan(int B, int m, int n, int wr, int wc, int product_sum,
                             int team_warps, int* out) {
  if (wr > kMaxRowWeight || m <= 0 || n <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(plan_mu);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)B + sms - 1) / sms;  // rows an SM when spread evenly
  const bool forced = team_warps > 0;
  if (!forced && !product_sum && !team_graph(m, n, wr, wc, product_sum)) {
    int wide[4];
    err = wide_shape(dev, m, n, wr, wc, wide);
    if (err == cudaErrorNotSupported) return (int)cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
    out[0] = wide[0];
    out[1] = 1;
    out[2] = wide[1];
    out[3] = B < sms ? B : sms;
    out[4] = wide[2];
    out[5] = wide[3];
    out[6] = 2;
    return 0;
  }
  if (!forced) {
    err = team_warps_of(dev, m, n, wr, wc, product_sum, &team_warps);
    if (err != cudaSuccess) return (int)err;
  }
  int shape[5];
  err = team_shape(dev, team_warps, m, n, wr, wc, product_sum, LLONG_MAX, shape);
  if (err != cudaSuccess) return (int)err;
  if (!forced && !product_sum && B < (long long)sms * shape[1] * shape[2]) {
    int lat[4];
    err = latency_shape(dev, need, m, n, wr, wc, lat);
    if (err == cudaSuccess) {
      out[0] = lat[0];
      out[1] = (int)need;
      out[2] = lat[1];
      out[3] = B < sms ? B : sms;
      out[4] = lat[2];
      out[5] = lat[3];
      out[6] = 1;
      return 0;
    }
    if (err != cudaErrorNotSupported) return (int)err;
  }
  if (need < shape[1]) {  // fewer rows an SM than a block's teams: spread them
    err = team_shape(dev, team_warps, m, n, wr, wc, product_sum, need, shape);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = ((long long)B + shape[1] - 1) / shape[1];
  const long long resident = (long long)sms * shape[2];
  out[0] = shape[0];
  out[1] = shape[1];
  out[2] = shape[2];
  out[3] = (int)(blocks < resident ? blocks : resident);
  out[4] = shape[3];
  out[5] = shape[4];
  out[6] = 0;
  return 0;
}

// Launches K1 on `stream`.  With `scratch` (B * bp_flood_scratch_words
// int32) the first design runs one block per sample with the state there;
// else bp_flood_plan's plan, the team kernel (with `counter`, one int32 set
// to 0 by the caller), the latency kernel or the wide kernel (with
// `counter` where its grid is below B), with `deg` [m] int32.  A non-null `row_iters` (one uint64) gets each row's
// iterations past it0 added, one atomic a row as it finishes; null costs
// nothing; `wide_iters` the same, in the wide plan only.  A non-null
// `plan_out` (7 int32) gets the plan (all 0 for the device-memory
// placement).  Returns cudaGetLastError() of the launch, or the error of
// bp_flood_plan.
extern "C" int bp_flood_launch(const void* synd, const void* llr0, long long llr0_stride,
                               const void* skip, const void* v2c_in, const void* chk_var,
                               const void* var_edge, const void* deg, void* hard, void* llr,
                               void* conv, void* iters, void* v2c_out, void* scratch,
                               void* counter, void* row_iters, void* wide_iters, int B, int m,
                               int n, int wr, int wc, int max_iter, int it0, int product_sum,
                               float alpha_fixed, int team_warps, void* stream, int* plan_out) {
  if (scratch) {
    if (plan_out) std::fill(plan_out, plan_out + 7, 0);
    bp_flood_global_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)synd, (const float*)llr0, llr0_stride, (const uint8_t*)skip,
        (const float*)v2c_in, (const int32_t*)chk_var, (const int32_t*)var_edge,
        (uint8_t*)hard, (float*)llr, (uint8_t*)conv, (int32_t*)iters, (float*)v2c_out,
        (int32_t*)scratch, (unsigned long long*)row_iters, m, n, wr, wc, max_iter, it0,
        product_sum, alpha_fixed);
    return (int)cudaGetLastError();
  }
  int plan[7];
  const int err = bp_flood_plan(B, m, n, wr, wc, product_sum, team_warps, plan);
  if (err != 0) return err;
  if (plan_out) std::copy(plan, plan + 7, plan_out);
  const int T = plan[0];
  if (plan[6] == 2) {
    if (plan[3] < B && !counter) return (int)cudaErrorInvalidValue;
    wide_kernel((m + T - 1) / T)<<<plan[3], T, plan[4], (cudaStream_t)stream>>>(
        (const uint8_t*)synd, (const float*)llr0, llr0_stride, (const uint8_t*)skip,
        (const float*)v2c_in, (const int32_t*)chk_var, (const int32_t*)var_edge,
        (const int32_t*)deg, (uint8_t*)hard, (float*)llr, (uint8_t*)conv, (int32_t*)iters,
        (float*)v2c_out, plan[3] < B ? (int32_t*)counter : nullptr,
        (unsigned long long*)row_iters, (unsigned long long*)wide_iters, B, m, n, wr, wc,
        max_iter, it0, alpha_fixed);
    return (int)cudaGetLastError();
  }
  if (plan[6]) {
    latency_kernel(wr, plan[1], wc)<<<plan[3], T, plan[4], (cudaStream_t)stream>>>(
        (const uint8_t*)synd, (const float*)llr0, llr0_stride, (const uint8_t*)skip,
        (const float*)v2c_in, (const int32_t*)chk_var, (const int32_t*)var_edge,
        (const int32_t*)deg, (uint8_t*)hard, (float*)llr, (uint8_t*)conv, (int32_t*)iters,
        (float*)v2c_out, (unsigned long long*)row_iters, B, m, n, wr, wc, max_iter, it0,
        alpha_fixed);
    return (int)cudaGetLastError();
  }
  team_kernel((m + T - 1) / T, product_sum)<<<plan[3], plan[1] * T, plan[4],
                                              (cudaStream_t)stream>>>(
      (const uint8_t*)synd, (const float*)llr0, llr0_stride, (const uint8_t*)skip,
      (const float*)v2c_in, (const int32_t*)chk_var, (const int32_t*)var_edge,
      (const int32_t*)deg, (uint8_t*)hard, (float*)llr, (uint8_t*)conv, (int32_t*)iters,
      (float*)v2c_out, (int32_t*)counter, (unsigned long long*)row_iters, B, m, n, wr, wc,
      max_iter, it0, T, alpha_fixed);
  return (int)cudaGetLastError();
}
