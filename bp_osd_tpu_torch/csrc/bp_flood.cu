// bp_flood.cu -- flooding belief propagation, one thread block per sample.
//
// Replaces the TPU kernel bp_osd_tpu/ops/pallas_bp.py:_bp_kernel (K1): the
// whole min-sum / product-sum iteration loop for a batch of syndromes, with
// skip rows born converged, resume from a v2c message state at it0 + 1, and
// emit of that state after each sample's last iteration.  The plain torch
// version is bp_osd_tpu_torch/decoder/bp.py:bp_decode_plain; this kernel is
// bit-identical to it for min-sum.
//
// What bounds it on an H100: latency, not bytes or flops.  Per iteration a
// sample touches ~3 * E + 2 * n words of state (E = m * wr = 1344 edges on
// the [[400,16,6]] flagship), all of it in shared memory, and the three
// phases (check update, variable sum, v2c update + syndrome check) are
// separated by block barriers; the device-memory traffic is the inputs and
// outputs once per sample.  The TPU kernel ran a block of 128 samples in
// lock step and could only leave the loop when all of them had converged;
// here every sample is its own block and leaves at its own convergence, so
// a converged sample costs nothing more and the card is filled by running
// many small blocks (~27 KB of shared memory each at the flagship) at once.
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
//     the magnitude bits, seeded with the 1e30 cap (row weight 1 gets it);
//   * hard = total <= 0, then the syndrome check; a sample freezes at its
//     first convergence and otherwise runs exactly max_iter iterations.
//
// Tables: chk_var [m * wr] (pad = n) and var_edge [n * wc] (pad = m * wr),
// both int32 and ascending within a row, as TannerGraph lays them out.
//
// Placement.  A block keeps the tables and its sample's state (syndrome,
// v2c, c2v, totals, prior) in shared memory when bp_flood_smem_bytes fits a
// block (232,448 bytes on Hopper: up to lift 140 of the bench protograph).
// Above that (the dense [[10000,420]] lifted product needs 662,400 bytes)
// the same code runs with kGlobal: the tables are read from device memory
// through the read-only cache and the state lives in this block's slice of
// a scratch buffer, bp_flood_scratch_words per sample, which stays in L2 for
// the few hundred samples a launch takes.  The arithmetic is the same, so
// both placements are bit-identical to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kTanhClip = 1.0f - 1e-7f;
constexpr int kThreads = 256;

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
bp_flood_kernel(const uint8_t* __restrict__ synd, const float* __restrict__ llr0,
                long long llr0_stride, const uint8_t* __restrict__ skip,
                const float* __restrict__ v2c_in, const int32_t* __restrict__ chk_var,
                const int32_t* __restrict__ var_edge, uint8_t* __restrict__ hard,
                float* __restrict__ llr, uint8_t* __restrict__ conv,
                int32_t* __restrict__ iters, float* __restrict__ v2c_out, int32_t* scratch,
                int m, int n, int wr, int wc, int max_iter, int it0, int product_sum,
                float alpha_fixed) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int E = m * wr;

  extern __shared__ int32_t smem[];
  const int32_t* s_cv;  // [E]
  const int32_t* s_ve;  // [n * wc]
  int32_t* s_syn;       // [m], then the float state below
  if constexpr (kGlobal) {
    s_cv = chk_var;
    s_ve = var_edge;
    s_syn = scratch + (size_t)b * (m + 2 * (size_t)E + 2 * (size_t)n);
  } else {
    int32_t* cv = smem;
    int32_t* ve = cv + E;
    for (int i = tid; i < E; i += nt) cv[i] = chk_var[i];
    for (int i = tid; i < n * wc; i += nt) ve[i] = var_edge[i];
    s_cv = cv;
    s_ve = ve;
    s_syn = ve + n * wc;
  }
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
    const float alpha =
        alpha_fixed == 0.0f ? __fsub_rn(1.0f, ldexpf(1.0f, -it)) : alpha_fixed;
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
      }
      return;
    }
  }
}

}  // namespace

// Shared memory of one block in the shared-memory placement.
extern "C" size_t bp_flood_smem_bytes(int m, int n, int wr, int wc) {
  const size_t E = (size_t)m * wr;
  return 4 * (E + (size_t)n * wc + m + 2 * E + 2 * (size_t)n);
}

// Scratch words of one sample in the device-memory placement.
extern "C" size_t bp_flood_scratch_words(int m, int n, int wr) {
  return (size_t)m + 2 * (size_t)m * wr + 2 * (size_t)n;
}

// Launches B blocks on `stream`; with `scratch` (B * bp_flood_scratch_words
// int32) the state lives there, else in shared memory.  Returns
// cudaGetLastError() of the launch.
extern "C" int bp_flood_launch(const void* synd, const void* llr0, long long llr0_stride,
                               const void* skip, const void* v2c_in, const void* chk_var,
                               const void* var_edge, void* hard, void* llr, void* conv,
                               void* iters, void* v2c_out, void* scratch, int B, int m,
                               int n, int wr, int wc, int max_iter, int it0,
                               int product_sum, float alpha_fixed, void* stream) {
  const size_t smem = scratch ? 0 : bp_flood_smem_bytes(m, n, wr, wc);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bp_flood_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  auto kernel = scratch ? bp_flood_kernel<true> : bp_flood_kernel<false>;
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)synd, (const float*)llr0, llr0_stride, (const uint8_t*)skip,
      (const float*)v2c_in, (const int32_t*)chk_var, (const int32_t*)var_edge,
      (uint8_t*)hard, (float*)llr, (uint8_t*)conv, (int32_t*)iters, (float*)v2c_out,
      (int32_t*)scratch, m, n, wr, wc, max_iter, it0, product_sum, alpha_fixed);
  return (int)cudaGetLastError();
}
