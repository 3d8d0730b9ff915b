// bp_check.cuh -- the check-node rules of the BP kernels, shared by K1
// (bp_flood.cu) and K6 (bp_lifted.cu), so both round exactly as the plain
// torch check updates of bp_osd_tpu_torch/decoder/bp.py do:
//   * adaptive alpha_t = 1 - ldexpf(1, -t) (exact), a fixed alpha as given;
//   * min-sum: sign test x < 0.0f (-0.0 counts as non-negative), the
//     exclusive minimum of the magnitude bits seeded with the 1e30 cap (row
//     weight 1 gets it), the first minimum taken over ascending slots, then
//     one multiply by alpha;
//   * product-sum: tanhf(0.5 x), forward products from slot 0 and backward
//     products from the last slot, (sign * fwd) * bwd clamped to
//     +-(1 - 1e-7), then 2 atanhf.
// Both sources are built with --fmad=false, and every product here is an
// explicit _rn intrinsic.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kTanhClip = 1.0f - 1e-7f;
constexpr int kMaxRowWeight = 27;  // sign bits 0..26, first-minimum slot in 27..31

__device__ __forceinline__ float alpha_at(int it, float alpha_fixed) {
  return alpha_fixed == 0.0f ? __fsub_rn(1.0f, ldexpf(1.0f, -it)) : alpha_fixed;
}

// A check's min-sum message, compressed: c2v of slot s is +-(s == i1 ? m2a :
// m1a), negative where bit s of `sg` is set; i1 sits in bits 27..31.
struct MinSumMsg {
  float m1a, m2a;
  uint32_t sg;
};

__device__ __forceinline__ float ms_value(const MinSumMsg& q, int s) {
  const float mag = (int)(q.sg >> kMaxRowWeight) == s ? q.m2a : q.m1a;
  return __uint_as_float(__float_as_uint(mag) ^ (((q.sg >> s) & 1u) << 31));  // +-mag
}

// Running exclusive-minimum state of one check over its v2c inputs.  The
// update m2 = min(m2, max(m1, mag)), m1 = min(m1, mag), with i1 moving only
// on a strictly smaller magnitude, is the first design's if/else chain.
struct MinSumAcc {
  uint32_t m1, m2, neg;
  int i1;

  __device__ __forceinline__ void init() {
    m1 = m2 = __float_as_uint(kBig);
    neg = 0u;
    i1 = 31;
  }

  __device__ __forceinline__ void add(float x, int s) {
    if (x < 0.0f) neg |= 1u << s;
    const uint32_t mag = __float_as_uint(x) & 0x7fffffffu;
    i1 = mag < m1 ? s : i1;
    m2 = min(m2, max(m1, mag));
    m1 = min(m1, mag);
  }

  __device__ __forceinline__ MinSumMsg finish(float alpha, int deg, int syn) const {
    const uint32_t all = deg >= 32 ? 0xffffffffu : ((1u << deg) - 1u);
    const int parity = syn ^ (__popc(neg) & 1);
    return {__fmul_rn(__uint_as_float(m1), alpha), __fmul_rn(__uint_as_float(m2), alpha),
            (neg ^ (parity ? all : 0u)) | ((uint32_t)i1 << kMaxRowWeight)};
  }
};

// Product-sum c2v of one check from v2c = xin(s), written to row[s].
template <typename In>
__device__ __forceinline__ void ps_check(const In& xin, float* row, int deg, int syn) {
  const float sgn = syn ? -1.0f : 1.0f;
  float fwd = 1.0f;
  for (int s = 0; s < deg; ++s) {
    row[s] = fwd;
    fwd = __fmul_rn(fwd, tanhf(__fmul_rn(0.5f, xin(s))));
  }
  float bwd = 1.0f;
  for (int s = deg - 1; s >= 0; --s) {
    float x = __fmul_rn(__fmul_rn(sgn, row[s]), bwd);
    x = fminf(fmaxf(x, -kTanhClip), kTanhClip);
    row[s] = __fmul_rn(2.0f, atanhf(x));
    bwd = __fmul_rn(bwd, tanhf(__fmul_rn(0.5f, xin(s))));
  }
}

}  // namespace
