// MEGA's geometric position bias, device code shared by the position-bias
// kernels (position_bias.cu) and the fused set-attention kernel
// (mega_attention.cu), as the Pallas kernels share bias_tile
// (vrdone_tpu/ops/pallas/position_bias.py:49).
//
// The bias of query box n and key box m in group g is
//   log(relu(b[g] + wt[g] . f(n, m) + A[g, n] . B[:, m]) + 1e-6)
// where f(n, m) holds the 32 sinusoid features of the pair's dx and dy (the
// first half of the 64-dim position embedding) and A . B is the separable dw,
// dh half, folded into per-box factors by the bias_factors kernel
// (position_bias.cu, pe_setup's fold). Only f needs transcendentals per
// pair: two logf and sixteen sincosf, computed once per pair for all groups.
// The angles reach several hundred radians (log-ratios up to about 7 times
// a rate of 100), so this uses sincosf with its full range reduction; the
// build has no --use_fast_math, whose __sinf/__cosf lose the low bits there.

#pragma once

#include <math.h>

namespace mega_bias {

constexpr int kFreqs = 8;       // embed_dim 64 / 8 sinusoid rates
constexpr int kPairFeat = 32;   // dx, dy: sin and cos of each rate
constexpr int kSepDim = 32;     // dw, dh: the folded A . B half

// the fp32 rates 100 / 1000^(k/8), passed by value with the launch
struct Freqs {
  float c[kFreqs];
};

// One axis of the pair's log-space offset: dx from the query's and the
// key's centres along x and the query's width, dy likewise along y.
__device__ __forceinline__ float log_offset(float q_centre, float q_size,
                                            float k_centre) {
  return logf(fabsf((q_centre - k_centre) / q_size) + 1e-3f);
}

// The bias from its two contractions: acc = b + wt_g . f and sep = A_g . B.
__device__ __forceinline__ float finish(float acc, float sep) {
  return logf(fmaxf(acc + sep, 0.f) + 1e-6f);
}

// Rate i of fr for an i that differs between lanes, without indexing the
// parameter struct dynamically (which would copy it to local memory).
__device__ __forceinline__ float rate(const Freqs& fr, int i) {
  float c = fr.c[0];
#pragma unroll
  for (int k = 1; k < kFreqs; ++k)
    if (i == k) c = fr.c[k];
  return c;
}

// --- pe_setup's fold (vrdone_tpu/ops/pallas/position_bias.py:108) --------
// Each in fp32 with the plain version's roundings (no fused multiply-add):
// the angle log(size) * c, then sin and cos of it.

// sin and cos of rate c times the log of a box's extent along one axis
// (x1 = r[axis], x2 = r[axis + 2], the +1 convention)
__device__ __forceinline__ void size_sincos(const float* r, int axis, float c,
                                            float* s, float* co) {
  const float size = __fadd_rn(__fsub_rn(r[axis + 2], r[axis]), 1.f);
  sincosf(__fmul_rn(logf(size), c), s, co);
}

// One entry of a query's folded factors from its size's sin s and cos c at
// one rate and the group's weights ws (of the sin feature) and wc (of the
// cos feature): [ws s + wc c] for the first 8 of an axis, [wc s - ws c] for
// the second 8.
__device__ __forceinline__ float fold(float s, float c, float ws, float wc,
                                      bool second) {
  return second ? __fsub_rn(__fmul_rn(s, wc), __fmul_rn(c, ws))
                : __fadd_rn(__fmul_rn(s, ws), __fmul_rn(c, wc));
}

}  // namespace mega_bias
