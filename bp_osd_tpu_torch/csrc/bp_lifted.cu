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
// What bounds it on an H100.  A row's state is its E = m * wr messages and
// its n totals: 174,400 bytes on the [[10000,420]] code (lift 400), which
// fits one block's shared memory and leaves no room for a second row, so an
// SM decodes one row at a time.  Device memory carries only the syndromes,
// the prior and the outputs, once a row.  What the card runs out of is
// instruction issue: about ten operations an edge each row-iteration (slot
// reads, the minimum or the tanh rule, the variable sum, the v2c subtract,
// the parity), with three block barriers an iteration; and a batch waits for
// its slowest row, which runs all max_iter iterations on one SM.
//
// Design:
//   * persistent blocks of 1024 threads, as many as are resident (one an SM
//     on the shared route), take rows from a counter (atomicAdd), so an SM
//     whose row converged takes the next one while the slow rows run;
//   * routing comes from the protograph, never from [m * wr] index tables:
//     the slot table gives slot s of check block row I as (J, e), so check
//     (I, l) reads variable (J, (l + e) mod L); the edge list of variable
//     block J gives its edges' (I, s, e) in the order the plain version adds
//     them (I outer, s inner), so variable (J, l') adds the message of check
//     (I, (l' - e) mod L) slot s.  The tables (a few hundred words) sit in
//     shared memory;
//   * one message buffer, updated in place: the check update turns v2c into
//     c2v (a thread owns whole checks), the variable update turns c2v back
//     into v2c; the third barrier of an iteration also ORs the parity
//     failures, and a row stops at its first convergence or at max_iter;
//   * a code whose state does not fit a block (lift 1000: 436,000 bytes)
//     keeps it in a device-memory slice of each block (the device-memory
//     route), with the same arithmetic; its tables stay in shared memory.
//
// Arithmetic contract (bit-identical to _bp_rows; built with --fmad=false):
//   * v2c starts as llr0 routed to the edges;
//   * the check rules of bp_check.cuh (min-sum with alpha_t, or the tanh
//     rule), K1's own;
//   * a variable adds its incoming c2v from +0.0 in (I, s) order, then
//     total = llr0 + sum, v2c = total - c2v and hard = total <= 0;
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

#include "bp_check.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kSmemLimit = 232448;  // shared memory a block may use on Hopper

// Shared-memory words of the tables: slots, blocks, the degree of each block
// row and the row slot.
__host__ __device__ inline long long table_words(int mp, int np_, int wr, int depth) {
  return 2LL * mp * wr + 3LL * np_ * depth + mp + 1;
}

template <bool kProd>
__global__ void __launch_bounds__(kThreads)
bp_lifted_kernel(const uint8_t* __restrict__ synd, const float* __restrict__ llr0,
                 long long llr0_stride, const int32_t* __restrict__ slots,
                 const int32_t* __restrict__ blocks, uint8_t* __restrict__ hard,
                 float* __restrict__ llr, uint8_t* __restrict__ conv,
                 int32_t* __restrict__ iters, float* scratch, int32_t* __restrict__ counter,
                 int B, int mp, int np_, int L, int wr, int depth, int max_iter,
                 float alpha_fixed) {
  extern __shared__ int32_t smem_lifted[];
  const int m = mp * L, n = np_ * L;
  const int E = m * wr;
  const int tid = threadIdx.x;
  int32_t* s_slot = smem_lifted;             // [mp * wr][2]
  int32_t* s_blk = s_slot + 2 * mp * wr;     // [np_ * depth][3]
  int32_t* s_deg = s_blk + 3 * np_ * depth;  // [mp]
  // the fetched row: one slot, since every thread reads it before the
  // barrier after the v2c start, and tid 0 writes the next only after the
  // last barrier of the row
  int32_t* s_row = s_deg + mp;
  float* msg = scratch ? scratch + (size_t)blockIdx.x * ((size_t)E + n)
                       : reinterpret_cast<float*>(s_row + 1);  // [m][wr]
  float* tot = msg + E;                                         // [n]

  for (int i = tid; i < 2 * mp * wr; i += kThreads) s_slot[i] = slots[i];
  for (int i = tid; i < 3 * np_ * depth; i += kThreads) s_blk[i] = blocks[i];
  for (int I = tid; I < mp; I += kThreads) {
    int d = 0;
    while (d < wr && slots[2 * (I * wr + d)] >= 0) ++d;
    s_deg[I] = d;
  }
  __syncthreads();

  // the variable of check (I, l)'s slot s
  auto var_of = [&](int I, int l, int s) {
    const int32_t* je = s_slot + 2 * (I * wr + s);
    int lv = l + je[1];
    if (lv >= L) lv -= L;
    return je[0] * L + lv;
  };

  for (;;) {
    if (tid == 0) *s_row = atomicAdd(counter, 1);
    __syncthreads();
    const int row = *s_row;
    if (row >= B) return;
    const float* l0 = llr0 + (size_t)row * llr0_stride;
    const uint8_t* sy = synd + (size_t)row * m;

    for (int c = tid; c < m; c += kThreads) {  // v2c before iteration 1
      const int I = c / L, l = c - I * L;
      for (int s = 0; s < s_deg[I]; ++s) msg[(size_t)c * wr + s] = __ldg(l0 + var_of(I, l, s));
    }
    __syncthreads();

    for (int it = 1;; ++it) {
      // ---- check update: v2c -> c2v, a thread a check ----
      const float alpha = alpha_at(it, alpha_fixed);
      for (int c = tid; c < m; c += kThreads) {
        const int dc = s_deg[c / L];
        const int sb = __ldg(sy + c) & 1;
        float* row_msg = msg + (size_t)c * wr;
        if constexpr (kProd) {
          float x[kMaxRowWeight];  // ps_check writes the row while it reads v2c
          for (int s = 0; s < dc; ++s) x[s] = row_msg[s];
          ps_check([&](int s) { return x[s]; }, row_msg, dc, sb);
        } else {
          MinSumAcc acc;
          acc.init();
          for (int s = 0; s < dc; ++s) acc.add(row_msg[s], s);
          const MinSumMsg q = acc.finish(alpha, dc, sb);
          for (int s = 0; s < dc; ++s) row_msg[s] = ms_value(q, s);
        }
      }
      __syncthreads();

      // ---- variable sum: from +0.0 in (I, s) order, a thread a variable ----
      for (int v = tid; v < n; v += kThreads) {
        const int J = v / L, lv = v - J * L;
        const int32_t* ed = s_blk + 3 * J * depth;
        float acc = 0.0f;
        for (int d = 0; d < depth && ed[0] >= 0; ++d, ed += 3) {
          int l = lv - ed[2];
          if (l < 0) l += L;
          acc = __fadd_rn(acc, msg[(size_t)(ed[0] * L + l) * wr + ed[1]]);
        }
        tot[v] = __fadd_rn(__ldg(l0 + v), acc);
      }
      __syncthreads();

      // ---- v2c update and syndrome check: c2v -> v2c, a thread a check ----
      int fail = 0;
      for (int c = tid; c < m; c += kThreads) {
        const int I = c / L, l = c - I * L;
        const int dc = s_deg[I];
        int parity = __ldg(sy + c) & 1;
        float* row_msg = msg + (size_t)c * wr;
        for (int s = 0; s < dc; ++s) {
          const float t = tot[var_of(I, l, s)];
          parity ^= (t <= 0.0f);
          row_msg[s] = __fsub_rn(t, row_msg[s]);
        }
        fail |= parity;
      }
      const int any_fail = __syncthreads_or(fail);

      if (!any_fail || it >= max_iter) {
        for (int v = tid; v < n; v += kThreads) {
          const float t = tot[v];
          hard[(size_t)row * n + v] = (t <= 0.0f);
          llr[(size_t)row * n + v] = t;
        }
        if (tid == 0) {
          conv[row] = !any_fail;
          iters[row] = it;
        }
        break;
      }
    }
  }
}

using LiftedKernel = void (*)(const uint8_t*, const float*, long long, const int32_t*,
                              const int32_t*, uint8_t*, float*, uint8_t*, int32_t*, float*,
                              int32_t*, int, int, int, int, int, int, int, float);

LiftedKernel lifted_kernel(int product_sum) {
  return product_sum ? bp_lifted_kernel<true> : bp_lifted_kernel<false>;
}

}  // namespace

// Dynamic shared memory of one block: the tables, and on the shared route
// (device_route = 0) the row's messages [m][wr] and totals [n].
extern "C" size_t bp_lifted_smem_bytes(int mp, int np_, int L, int wr, int depth,
                                       int device_route) {
  const long long state = device_route ? 0 : (long long)mp * L * wr + (long long)np_ * L;
  return (size_t)(4 * (table_words(mp, np_, wr, depth) + state));
}

// The launch on the current card: out = {blocks an SM, SMs, registers a
// thread, dynamic shared memory bytes}.  Also raises the kernel's dynamic
// shared-memory limit on this card to the block maximum, which
// bp_lifted_launch relies on.  Returns 0, cudaErrorInvalidValue for a
// graph the kernel does not take (row weight above 27, or tables and state
// above a block's shared memory), or the CUDA error of a query.
extern "C" int bp_lifted_plan(int mp, int np_, int L, int wr, int depth, int product_sum,
                              int device_route, int* out) {
  if (wr > kMaxRowWeight || mp <= 0 || np_ <= 0 || L <= 0 || depth <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bp_lifted_smem_bytes(mp, np_, L, wr, depth, device_route);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  LiftedKernel kernel = lifted_kernel(product_sum);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  out[0] = per_sm;
  out[1] = sms;
  out[2] = attr.numRegs;
  out[3] = (int)smem;
  return 0;
}

// Launches K6 for rows 0 .. B - 1 on `stream` with `grid` persistent blocks;
// `counter` is one int32 set to 0 by the caller.  With `scratch` (grid *
// (m * wr + n) floats) each block keeps its row's state there, else in
// shared memory.  bp_lifted_plan has run on this card.  Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for a shape the
// kernel does not take.
extern "C" int bp_lifted_launch(const void* synd, const void* llr0, long long llr0_stride,
                                const void* slots, const void* blocks, void* hard, void* llr,
                                void* conv, void* iters, void* scratch, void* counter, int B,
                                int grid, int mp, int np_, int L, int wr, int depth,
                                int max_iter, int product_sum, float alpha_fixed,
                                void* stream) {
  if (wr > kMaxRowWeight || grid < 1 || B < 1 || max_iter < 1 || depth < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bp_lifted_smem_bytes(mp, np_, L, wr, depth, scratch != nullptr);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  LiftedKernel kernel = lifted_kernel(product_sum);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)synd, (const float*)llr0, llr0_stride, (const int32_t*)slots,
      (const int32_t*)blocks, (uint8_t*)hard, (float*)llr, (uint8_t*)conv, (int32_t*)iters,
      (float*)scratch, (int32_t*)counter, B, mp, np_, L, wr, depth, max_iter, alpha_fixed);
  return (int)cudaGetLastError();
}
