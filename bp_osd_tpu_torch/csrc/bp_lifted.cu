// bp_lifted.cu -- shift-routed BP for protograph-lifted codes (K6): the whole
// decode of a batch in one launch.
//
// Replaces no Pallas kernel.  The JAX package runs this decode as the XLA
// jax.lax.while_loop of bp_osd_tpu/decoder/lifted_bp.py:173-212, one device
// program with the convergence test in its cond, so the host never sees an
// iteration.  The plain torch version,
// bp_osd_tpu_torch/decoder/lifted_bp.py:_bp_rows, is a Python loop of about
// twenty launches and one host read an iteration; this kernel computes
// exactly what it computes, bit for bit.
//
// What bounds it on an H100.  The work is about ten integer and three float
// operations an edge each row-iteration (E = m * wr = 33,600 edges on the
// [[10000,420]] code at lift 400), all on state that a block keeps in shared
// memory; device memory carries the syndromes, the prior and the outputs
// once a row.  An iteration is a check pass and a variable pass over the
// whole row with a barrier after each, so a row is as fast as its threads'
// instruction streams, and a batch waits for its slowest rows, which run
// all max_iter iterations.
//
// The first design kept the row's E messages and n totals in shared memory
// (174,400 bytes at lift 400, so one 1024-thread row an SM) and made three
// passes and three barriers an iteration: the check update (v2c -> c2v), the
// variable sum, and a third pass that rewrote v2c = total - c2v and took the
// parity.  On an H100 80GB HBM3 at 700 W it took 4.19-4.43 ms on 512
// lift-400 rows at p = 0.028 (18,301 row-iterations), 0.67-0.80 ms at
// p = 0.005, and 20-21 us an iteration for a lone row.  This design:
//   * K1's two-barrier order.  The check update of iteration t + 1 reads
//     the totals tot_t of its slots, takes the parity of hard_t = tot_t <= 0
//     on the way, forms v2c_t = tot_t - c2v_t from the check's own
//     compressed message q_t, and writes q_{t+1} in place.  The first
//     barrier ORs the parity failures: a row that passed at t (or reached
//     max_iter) emits tot_t and drops q_{t+1}; otherwise the variable pass
//     sums c2v_{t+1} and the second barrier closes the iteration.  The third
//     pass and its E-float v2c write are gone;
//   * min-sum state is q, three words a check (the two scaled minima and
//     the sign word with the first-minimum slot, bp_check.cuh's MinSumMsg),
//     kept as three arrays m1a[m], m2a[m], sg[m], and tot[n]: 97,600 bytes
//     at lift 400, so two rows fit an SM;
//   * a launch plan sized from the graph alone (ops/cuda_lifted_bp.py:
//     k6_threads): threads a row from 128, 256, 512 or 1024 and the rows an
//     SM that the occupancy query allows, the same for every batch size.  At
//     lift 400 it takes one 1024-thread row an SM: two 512-thread rows fit,
//     but ran every batch slower;
//   * nothing a thread's ownership fixes is redone in the loops: a thread
//     owns checks c = tid + k T and variables v = tid + k T, stepped by
//     (T / L, T mod L) without a division; its syndrome bits sit in one
//     64-bit register loaded once a row.  The tables hold byte offsets into
//     the row's state: each slot as the offset of its total at l = 0 and
//     4 (L - e), each edge as the offset of its check's sign word at l' = 0,
//     4 e and s, so a route is a compare, a select and an add straight into
//     the load's address (element indices and runtime array bases cost five
//     more instructions a slot).  The slot loop of a graph whose block rows
//     all have the same weight, 4 to 8 (the bench protograph's 7), is
//     unrolled without guards (a guard costs a branch and its convergence
//     barrier, four issue slots a slot); other graphs of row weight <= 8
//     unroll to 8 with guards, and the edge loop of depth <= 4 (the bench
//     protograph's 3 and 4) is unrolled with guards, pads never added.  The
//     prior is read through the read-only cache where a variable's total is
//     formed: kept in registers (8-24 a thread) it spilled the kernel at its
//     64-register cap and every team size ran slower.
// Persistent blocks take rows from a counter (atomicAdd), so an SM whose row
// converged takes the next while the slow rows run.  Product-sum keeps its
// E c2v floats (the tanh rule's messages do not compress) in the same
// two-barrier order, a check reading its slots into registers before it
// writes its row.  A code whose state does not fit a block (min-sum above
// lift 942 of the bench protograph) keeps it in a device-memory slice of
// each block, the same words in the same order.
//
// On the same card this design takes 2.22-2.26 ms on the p = 0.028 batch
// (about 12% of K6's bound), 0.40-0.43 ms at p = 0.005 and 10.8-10.9 us an
// iteration for a lone row (k6_timing.py).  What bounds it now is
// instruction issue: nearly all of a row-iteration's issue slots go to the
// per-slot and per-edge work (the route, the two-minimum update, the
// message's select and sign, the loads), and one 1024-thread row leaves
// each SM scheduler eight warps to hide the shared-memory latency with.
//
// Arithmetic contract (bit-identical to _bp_rows; built with --fmad=false):
//   * iteration 1 reads v2c_0 = llr0 routed to the slots and takes no parity;
//   * the check rules of bp_check.cuh (min-sum with alpha_t, or the tanh
//     rule), K1's own, and ms_value(q, s) rebuilds exactly the float c2v;
//   * a variable adds its incoming c2v from +0.0 in (I, s) order (pads
//     skipped: a sum that starts at +0.0 is never -0.0, so adding a pad's
//     +0.0 would change nothing), then total = llr0 + sum, and v2c = total -
//     c2v is formed where the next check update reads it;
//   * a row converges when every check's parity of hard equals its
//     syndrome; it freezes there (hard, llr, iterations = it, converged),
//     and at it == max_iter every remaining row is written with
//     converged = ok.
//
// Tables (int32, from LiftedGraph): slots [mp][wr][2] = (J, e), J = -1 on
// the pad slots after a block row's edges; blocks [np][depth][3] =
// (I, s, e), I = -1 on the pads after a variable block's edges.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bp_check.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemLimit = 232448;  // shared memory a block may use on Hopper
constexpr int kMaxChecksPerThread = 64;  // syndrome bits in one 64-bit register
constexpr int kSmallSlots = 8;  // unrolled slot loop: row weight <= 8
constexpr int kSmallDepth = 4;  // unrolled edge loop: column depth <= 4

// Shared-memory words of the tables: the edges [np][depth] as int4, the
// slots [mp][wr] as int2, the degree of each block row and each variable
// block, and the row slot.
__host__ __device__ inline long long table_words(int mp, int np_, int wr, int depth) {
  return 4LL * np_ * depth + 2LL * mp * wr + mp + np_ + 1;
}

// One row's state: q (3 words a check) and the totals for min-sum, the
// c2v floats [m][wr] and the totals for product-sum.
__host__ __device__ inline long long state_words(int mp, int np_, int L, int wr,
                                                 int product_sum) {
  const long long m = (long long)mp * L;
  return (product_sum ? m * wr : 3 * m) + (long long)np_ * L;
}

// A thread's position in the lifted order: block and 4 l (byte units, as
// the tables hold their offsets); next() moves it on by the block size
// T = tq L + tr.
struct Pos {
  int blk, l4;
  __device__ __forceinline__ void next(int tq, int tr4, int L4) {
    l4 += tr4;
    blk += tq;
    if (l4 >= L4) {
      l4 -= L4;
      ++blk;
    }
  }
};

// kSlots: 0 runs the generic slot and edge loops; otherwise the slot loop is
// unrolled to kSlots (every block row has exactly kSlots slots when kFull,
// else at most kSlots, guarded) and the edge loop to kSmallDepth, guarded.
template <bool kProd, bool kDevice, int kSlots, bool kFull>
__global__ void __launch_bounds__(kMaxThreads)
bp_lifted_kernel(const uint8_t* __restrict__ synd, const float* __restrict__ llr0,
                 long long llr0_stride, const int32_t* __restrict__ slots,
                 const int32_t* __restrict__ blocks, uint8_t* __restrict__ hard,
                 float* __restrict__ llr, uint8_t* __restrict__ conv,
                 int32_t* __restrict__ iters, float* scratch, int32_t* __restrict__ counter,
                 int B, int mp, int np_, int L, int wr, int depth, int max_iter,
                 float alpha_fixed) {
  static_assert(!kProd || kSlots == 0, "product-sum runs the generic loops");
  extern __shared__ int4 smem_lifted[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int m = mp * L, n = np_ * L;
  int4* s_blk = smem_lifted;                                        // [np][depth]
  int2* s_slot = reinterpret_cast<int2*>(s_blk + np_ * depth);      // [mp][wr]
  int32_t* s_deg = reinterpret_cast<int32_t*>(s_slot + mp * wr);    // [mp]
  int32_t* s_vdeg = s_deg + mp;                                     // [np]
  // the fetched row: one slot, since every thread reads it before the
  // barrier after the row's first check update, and tid 0 writes the next
  // only after the row's last barrier
  int32_t* s_row = s_vdeg + np_;
  // The row's state, addressed in bytes from `base`: min-sum q = (m1a, m2a,
  // sg) [m] each, product-sum c2v [m][wr]; then tot [n].
  char* base;
  int state_off;
  if constexpr (kDevice) {
    base = reinterpret_cast<char*>(scratch + (size_t)blockIdx.x *
                                                 (size_t)state_words(mp, np_, L, wr, kProd));
    state_off = 0;
  } else {
    base = reinterpret_cast<char*>(smem_lifted);
    state_off = 4 * (int)table_words(mp, np_, wr, depth);
  }
  const int m1_off = state_off, m2_off = state_off + 4 * m, sg_off = state_off + 8 * m;
  const int tot_off = state_off + (kProd ? 4 * m * wr : 12 * m);
  auto at_f = [&](int off) -> float& { return *reinterpret_cast<float*>(base + off); };
  auto at_u = [&](int off) -> uint32_t& { return *reinterpret_cast<uint32_t*>(base + off); };

  // Tables in byte offsets from `base`.  Slot s of block row I: (the total
  // of variable J L + e, 4 (L - e)), so slot s of check (I, l) reads the
  // total at .x + 4 l, less 4 L where l >= L - e.  Edge d of variable block
  // J: (min-sum: the sign word of check I L - e; product-sum: its c2v of
  // slot s, 4 e, s, I), so the edge of variable (J, l') is check
  // (I, (l' - e) mod L): .x + 4 l' (times wr for product-sum), plus 4 L
  // where l' < e.
  const int L4 = 4 * L;
  for (int i = tid; i < np_ * depth; i += T) {
    const int I = blocks[3 * i], s = blocks[3 * i + 1], e = blocks[3 * i + 2];
    const int x = kProd ? state_off + 4 * (wr * (I * L - e) + s) : sg_off + 4 * (I * L - e);
    s_blk[i] = make_int4(x, 4 * e, s, I);
  }
  for (int i = tid; i < mp * wr; i += T) {
    const int J = slots[2 * i], e = slots[2 * i + 1];
    s_slot[i] = make_int2(tot_off + 4 * (J * L + e), 4 * (L - e));
  }
  for (int I = tid; I < mp; I += T) {
    int d = 0;
    while (d < wr && slots[2 * (I * wr + d)] >= 0) ++d;
    s_deg[I] = d;
  }
  for (int J = tid; J < np_; J += T) {
    int d = 0;
    while (d < depth && blocks[3 * (J * depth + d)] >= 0) ++d;
    s_vdeg[J] = d;
  }
  __syncthreads();

  // the thread's first check (I, l) and first variable (J, l') are both
  // (tid / L, tid mod L); each next one is T further on
  const int tq = T / L, tr4 = 4 * (T - (T / L) * L);
  const Pos first{tid / L, 4 * (tid - (tid / L) * L)};
  const int d1 = m1_off - sg_off, d2 = m2_off - sg_off;  // a check's minima from its sign word

  // c2v of the edge ed of a variable at 4 l' (min-sum: from the check's q,
  // reading one of its minima)
  auto edge_c2v = [&](int4 ed, int lv4) {
    const int wrap = lv4 < ed.y ? L4 : 0;
    if constexpr (kProd) {
      return at_f(ed.x + (lv4 + wrap) * wr);
    } else {
      const int off = ed.x + lv4 + wrap;
      const uint32_t w = at_u(off);
      const float mag = at_f(off + ((int)(w >> kMaxRowWeight) == ed.z ? d2 : d1));
      return __uint_as_float(__float_as_uint(mag) ^ (((w >> ed.z) & 1u) << 31));
    }
  };

  // the sum of a variable's incoming c2v, from +0.0 in (I, s) order
  auto var_sum = [&](Pos p) {
    const int4* ed = s_blk + p.blk * depth;
    const int dv = s_vdeg[p.blk];
    float acc = 0.0f;
    if constexpr (kSlots > 0) {
#pragma unroll
      for (int d = 0; d < kSmallDepth; ++d)
        if (d < dv) acc = __fadd_rn(acc, edge_c2v(ed[d], p.l4));
    } else {
      for (int d = 0; d < dv; ++d) acc = __fadd_rn(acc, edge_c2v(ed[d], p.l4));
    }
    return acc;
  };

  for (;;) {
    if (tid == 0) *s_row = atomicAdd(counter, 1);
    __syncthreads();
    const int row = *s_row;
    if (row >= B) return;
    const float* l0 = llr0 + (size_t)row * llr0_stride;
    const uint8_t* sy = synd + (size_t)row * m;
    uint64_t syn = 0;  // bit k: the syndrome of check tid + k T
    for (int c = tid, k = 0; c < m; c += T, ++k) syn |= (uint64_t)(__ldg(sy + c) & 1) << k;

    // The check update of iteration it + 1 (it = 0: from v2c_0 = llr0, no
    // parity) over the thread's checks; returns the parity failures of
    // iteration it.  q_{it+1} (c2v_{it+1}) is written only when `more`.
    auto check_pass = [&](auto start, int it, bool more) {
      constexpr bool kStart = decltype(start)::value;
      const float alpha = alpha_at(it + 1, alpha_fixed);
      Pos p = first;
      uint64_t sb_bits = syn;
      int fail = 0;
      for (int c = tid; c < m; c += T, p.next(tq, tr4, L4), sb_bits >>= 1) {
        const int sb = (int)(sb_bits & 1u);
        const int dc = s_deg[p.blk];
        const int2* sl = s_slot + p.blk * wr;
        const int c4 = 4 * c;
        int hp = sb;
        // v2c_it of slot s, taking the parity of hard_it on the way
        auto v2c = [&](int s, float own) {
          const int2 je = sl[s];
          const int off = je.x + p.l4 - (p.l4 >= je.y ? L4 : 0);
          if constexpr (kStart) {
            return __ldg(l0 + ((off - tot_off) >> 2));
          } else {
            const float t = at_f(off);
            hp ^= t <= 0.0f;
            return __fsub_rn(t, own);
          }
        };
        if constexpr (kProd) {
          float* row_c = &at_f(state_off + c4 * wr);
          float x[kMaxRowWeight];  // ps_check writes the row while it reads v2c
          for (int s = 0; s < dc; ++s) x[s] = v2c(s, kStart ? 0.0f : row_c[s]);
          if (more) ps_check([&](int s) { return x[s]; }, row_c, dc, sb);
        } else {
          MinSumMsg q{0.0f, 0.0f, 0u};
          if constexpr (!kStart) q = MinSumMsg{at_f(m1_off + c4), at_f(m2_off + c4),
                                               at_u(sg_off + c4)};
          MinSumAcc acc;
          acc.init();
          if constexpr (kSlots > 0) {
#pragma unroll
            for (int s = 0; s < kSlots; ++s)
              if (kFull || s < dc) acc.add(v2c(s, kStart ? 0.0f : ms_value(q, s)), s);
          } else {
            for (int s = 0; s < dc; ++s) acc.add(v2c(s, kStart ? 0.0f : ms_value(q, s)), s);
          }
          if (more) {
            const MinSumMsg nq = acc.finish(alpha, kFull ? kSlots : dc, sb);
            at_f(m1_off + c4) = nq.m1a;
            at_f(m2_off + c4) = nq.m2a;
            at_u(sg_off + c4) = nq.sg;
          }
        }
        fail |= hp;
      }
      return fail;
    };

    // The totals of the c2v just written: tot = llr0 + the variable sum.
    auto var_pass = [&]() {
      Pos p = first;
      for (int v = tid; v < n; v += T, p.next(tq, tr4, L4))
        at_f(tot_off + 4 * v) = __fadd_rn(__ldg(l0 + v), var_sum(p));
    };

    check_pass(std::true_type{}, 0, true);
    __syncthreads();
    var_pass();
    __syncthreads();
    for (int it = 1;; ++it) {
      const bool more = it < max_iter;
      const int any_fail = __syncthreads_or(check_pass(std::false_type{}, it, more));
      if (!any_fail || !more) {  // emit tot_it; q_{it+1} is dropped
        for (int v = tid; v < n; v += T) {
          const float t = at_f(tot_off + 4 * v);
          hard[(size_t)row * n + v] = (t <= 0.0f);
          llr[(size_t)row * n + v] = t;
        }
        if (tid == 0) {
          conv[row] = !any_fail;
          iters[row] = it;
        }
        break;
      }
      var_pass();
      __syncthreads();
    }
  }
}

using LiftedKernel = void (*)(const uint8_t*, const float*, long long, const int32_t*,
                              const int32_t*, uint8_t*, float*, uint8_t*, int32_t*, float*,
                              int32_t*, int, int, int, int, int, int, int, float);

template <bool kDevice>
LiftedKernel min_sum_kernel(int wr, int depth, int full_rows) {
  if (wr > kSmallSlots || depth > kSmallDepth) return bp_lifted_kernel<false, kDevice, 0, false>;
  if (full_rows) {
    switch (wr) {
      case 4: return bp_lifted_kernel<false, kDevice, 4, true>;
      case 5: return bp_lifted_kernel<false, kDevice, 5, true>;
      case 6: return bp_lifted_kernel<false, kDevice, 6, true>;
      case 7: return bp_lifted_kernel<false, kDevice, 7, true>;
      case 8: return bp_lifted_kernel<false, kDevice, 8, true>;
      default: break;
    }
  }
  return bp_lifted_kernel<false, kDevice, kSmallSlots, false>;
}

// The instance for a graph: min-sum unrolls the slot loop of row weight
// <= 8 (exactly, without guards, when every block row is full and its
// weight is 4 to 8) and the edge loop of depth <= 4; product-sum runs the
// generic loops.
LiftedKernel lifted_kernel(int product_sum, int device_route, int wr, int depth,
                           int full_rows) {
  if (product_sum)
    return device_route ? bp_lifted_kernel<true, true, 0, false>
                        : bp_lifted_kernel<true, false, 0, false>;
  return device_route ? min_sum_kernel<true>(wr, depth, full_rows)
                      : min_sum_kernel<false>(wr, depth, full_rows);
}

// A shape the kernel takes with `threads` threads a row.
bool valid(int mp, int np_, int L, int wr, int depth, int threads) {
  return wr <= kMaxRowWeight && mp > 0 && np_ > 0 && L > 0 && depth > 0 && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0 &&
         ((long long)mp * L + threads - 1) / threads <= kMaxChecksPerThread;
}

}  // namespace

// Dynamic shared memory of one block: the tables, and on the shared route
// (device_route = 0) the row's state.
extern "C" size_t bp_lifted_smem_bytes(int mp, int np_, int L, int wr, int depth,
                                       int product_sum, int device_route) {
  const long long state = device_route ? 0 : state_words(mp, np_, L, wr, product_sum);
  return (size_t)(4 * (table_words(mp, np_, wr, depth) + state));
}

// K6 with `threads` threads a row on the current card: out = {rows an SM
// (resident blocks, 0 if none fits), SMs, registers a thread, dynamic shared
// memory bytes, local memory bytes a thread}.
// Also raises this instance's dynamic shared-memory limit on the card to the
// block maximum, which bp_lifted_launch relies on.  Returns 0,
// cudaErrorInvalidValue for a shape the kernel does not take (row weight
// above 27, more than 64 checks a thread, a team that is not whole warps up
// to 1024, or tables and state above a block's shared memory), or the CUDA
// error of a query.
extern "C" int bp_lifted_plan(int mp, int np_, int L, int wr, int depth, int product_sum,
                              int device_route, int full_rows, int threads, int* out) {
  if (!valid(mp, np_, L, wr, depth, threads)) return (int)cudaErrorInvalidValue;
  const size_t smem = bp_lifted_smem_bytes(mp, np_, L, wr, depth, product_sum, device_route);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  LiftedKernel kernel = lifted_kernel(product_sum, device_route, wr, depth, full_rows);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = attr.numRegs;
  out[3] = (int)smem;
  out[4] = (int)attr.localSizeBytes;
  return 0;
}

// Launches K6 for rows 0 .. B - 1 on `stream` with `grid` persistent blocks
// of `threads` threads; `counter` is one int32 set to 0 by the caller.  With
// `scratch` (grid * state words) each block keeps its row's state there,
// else in shared memory.  bp_lifted_plan has run on this card for this
// shape and `threads`.  Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int bp_lifted_launch(const void* synd, const void* llr0, long long llr0_stride,
                                const void* slots, const void* blocks, void* hard, void* llr,
                                void* conv, void* iters, void* scratch, void* counter, int B,
                                int grid, int threads, int mp, int np_, int L, int wr,
                                int depth, int full_rows, int max_iter, int product_sum,
                                float alpha_fixed, void* stream) {
  if (!valid(mp, np_, L, wr, depth, threads) || grid < 1 || B < 1 || max_iter < 1)
    return (int)cudaErrorInvalidValue;
  const int device_route = scratch != nullptr;
  const size_t smem = bp_lifted_smem_bytes(mp, np_, L, wr, depth, product_sum, device_route);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  LiftedKernel kernel = lifted_kernel(product_sum, device_route, wr, depth, full_rows);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)synd, (const float*)llr0, llr0_stride, (const int32_t*)slots,
      (const int32_t*)blocks, (uint8_t*)hard, (float*)llr, (uint8_t*)conv, (int32_t*)iters,
      (float*)scratch, (int32_t*)counter, B, mp, np_, L, wr, depth, max_iter, alpha_fixed);
  return (int)cudaGetLastError();
}
