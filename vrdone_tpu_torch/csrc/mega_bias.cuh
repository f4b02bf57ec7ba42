// MEGA's geometric position bias, device code shared by the position-bias
// kernel (position_bias.cu) and the fused set-attention kernel
// (mega_attention.cu), as the Pallas kernels share bias_tile
// (vrdone_tpu/ops/pallas/position_bias.py:49).
//
// The bias of query box n and key box m in group g is
//   log(relu(b[g] + wt[g] . f(n, m) + A[g, n] . B[:, m]) + 1e-6)
// where f(n, m) holds the 32 sinusoid features of the pair's dx and dy (the
// first half of the 64-dim position embedding) and A . B is the separable dw,
// dh half, folded by pe_setup on the host (ops/position_bias.py) into
// per-box factors. Only f needs transcendentals per pair: two logf and
// sixteen sincosf, computed once per pair for all groups. The angles reach
// several hundred radians (log-ratios up to about 7 times a rate of 100), so
// this uses sincosf with its full range reduction; the build has no
// --use_fast_math, whose __sinf/__cosf lose the low bits there.

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

// an xyxy box as centre and size, widths and heights with the +1 convention
struct Box {
  float cx, cy, w, h;
};

__device__ __forceinline__ Box load_box(const float* r) {
  const float x1 = r[0], y1 = r[1], x2 = r[2], y2 = r[3];
  return {0.5f * (x1 + x2), 0.5f * (y1 + y2), x2 - x1 + 1.f, y2 - y1 + 1.f};
}

// One axis of the pair's log-space offset: dx from the query's and the
// key's centres along x and the query's width, dy likewise along y.
__device__ __forceinline__ float log_offset(float q_centre, float q_size,
                                            float k_centre) {
  return logf(fabsf((q_centre - k_centre) / q_size) + 1e-3f);
}

// The pair's features in the embedding's order: f[16 j + i] = sin(pos_j c_i)
// and f[16 j + 8 + i] = cos(pos_j c_i), with pos_0 = dx and pos_1 = dy.
__device__ __forceinline__ void pair_features(const Box& q, const Box& k,
                                              const Freqs& fr,
                                              float f[kPairFeat]) {
  const float dx = log_offset(q.cx, q.w, k.cx);
  const float dy = log_offset(q.cy, q.h, k.cy);
#pragma unroll
  for (int i = 0; i < kFreqs; ++i) {
    sincosf(dx * fr.c[i], &f[i], &f[kFreqs + i]);
    sincosf(dy * fr.c[i], &f[2 * kFreqs + i], &f[3 * kFreqs + i]);
  }
}

// The bias from its two contractions: acc = b + wt_g . f and sep = A_g . B.
__device__ __forceinline__ float finish(float acc, float sep) {
  return logf(fmaxf(acc + sep, 0.f) + 1e-6f);
}

// One group's bias of the pair: wt_g and a_g are that group's 32 weights of
// f and 32 query factors, bk the key's 32 factors.
__device__ __forceinline__ float group_bias(const float* wt_g, const float* a_g,
                                            const float f[kPairFeat],
                                            const float bk[kSepDim], float b) {
  float acc = b;
#pragma unroll
  for (int j = 0; j < kPairFeat; ++j) acc = fmaf(wt_g[j], f[j], acc);
  float sep = 0.f;
#pragma unroll
  for (int j = 0; j < kSepDim; ++j) sep = fmaf(a_g[j], bk[j], sep);
  return finish(acc, sep);
}

}  // namespace mega_bias
