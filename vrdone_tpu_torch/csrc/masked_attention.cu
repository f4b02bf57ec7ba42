// Key-masked full attention forward for Hopper (sm_90a), fp32.
//
// Replaces the TPU path vrdone_tpu/ops/masked.py::_full_attention_flash, which
// called the Pallas library kernel
// jax.experimental.pallas.ops.tpu.flash_attention with kv segment ids
// (dispatched by full_attention_auto). Semantics are those of the dense
// oracle vrdone_tpu/ops/masked.py::full_attention: scores scaled by
// 1/sqrt(d), an invalid key gets zero probability and its value never enters
// the sum, and every query row is computed (callers mask by the query mask
// afterwards). A row with no valid key is written as 0, where the dense form
// would give NaN; the eval path never makes such a row.
//
// What bounds it on this card: with fp32 inputs and TF32 off there are no
// tensor cores to use, so at the eval shapes (d = 64 or 128, Tq = Tk = 96 up
// to 768) the 4*Tq*Tk*d flops per (batch, head) run on the fp32 pipes and
// the kernel is arithmetic-bound, with shared-memory bandwidth the next
// limit. The design: a block owns kRows query rows of one (batch, head) and
// walks the keys in tiles of 32, staging each key/value tile in shared
// memory once for all kRows rows. One warp serves one query row and one lane
// one key of the tile, so a score is a dot product in one lane (no shuffle
// per key), with the query row broadcast from shared memory and the key
// rows stored at a stride of d+1 floats so the 32 lanes hit 32 banks. The
// softmax is online across tiles (running max and sum in registers), and
// for P.V each lane owns d/32 output channels. Tiles with no valid key are
// skipped.
//
// Layout: q and out are (B, Tq, H*d), k and v (B, Tk, H*d), contiguous, heads
// split head-major along the channels as the JAX package's _split_heads lays
// them out. mask is (B, Tk) bool (one byte each). Takes any Tq and Tk and
// 1 <= d <= 256; the Python wrapper rejects anything else before the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kRows = 16;   // query rows per block, one warp each
constexpr int kTile = 32;   // keys per tile, one lane each
constexpr int kMaxD = 256;  // head dim bound (kMaxD / 32 floats a lane)

__global__ void __launch_bounds__(kRows * 32)
masked_attention_fwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const unsigned char* __restrict__ mask,
                            float* __restrict__ out,
                            int Tq, int Tk, int H, int D, float scale) {
  extern __shared__ float smem[];
  const int kstride = D + 1;
  float* ks = smem;                    // kTile x (D + 1)
  float* vs = ks + kTile * kstride;    // kTile x D
  float* qs = vs + kTile * D;          // kRows x D, pre-scaled

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int i0 = blockIdx.y * kRows;
  const int C = H * D;
  const size_t qbase = (size_t)b * Tq * C + (size_t)h * D;
  const size_t kbase = (size_t)b * Tk * C + (size_t)h * D;
  const unsigned char* mrow = mask + (size_t)b * Tk;

  for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int i = i0 + r;
    qs[idx] = i < Tq ? q[qbase + (size_t)i * C + c] * scale : 0.f;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = i0 + warp;
  const bool active = i < Tq;  // the same in every lane of the warp

  float m = -INFINITY;  // running max of the valid scores
  float l = 0.f;        // running sum of exp(score - m)
  float acc[kMaxD / 32];
#pragma unroll
  for (int t = 0; t < kMaxD / 32; ++t) acc[t] = 0.f;

  for (int j0 = 0; j0 < Tk; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
      const int r = idx / D;
      const int c = idx - r * D;
      const int j = j0 + r;
      float kv = 0.f, vv = 0.f;
      if (j < Tk) {
        const size_t off = kbase + (size_t)j * C + c;
        kv = k[off];
        vv = v[off];
      }
      ks[r * kstride + c] = kv;
      vs[r * D + c] = vv;
    }
    __syncthreads();
    if (!active) continue;

    const int j = j0 + lane;
    const bool valid = j < Tk && mrow[j];
    float s = -INFINITY;
    if (valid) {
      const float* qrow = qs + warp * D;
      const float* krow = ks + lane * kstride;
      float dot = 0.f;
      for (int c = 0; c < D; ++c) dot = fmaf(qrow[c], krow[c], dot);
      s = dot;
    }
    float tmax = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    if (tmax == -INFINITY) continue;  // no valid key in this tile

    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // 0 while m is still -inf
    const float p = valid ? expf(s - m_new) : 0.f;
    float psum = p;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int t = 0; t < kMaxD / 32; ++t) acc[t] *= alpha;
    const int n_keys = min(kTile, Tk - j0);
    for (int n = 0; n < n_keys; ++n) {
      const float pn = __shfl_sync(0xffffffffu, p, n);
      if (pn == 0.f) continue;  // invalid key; pn is the same in every lane
      const float* vrow = vs + n * D;
#pragma unroll
      for (int t = 0; t < kMaxD / 32; ++t) {
        const int c = lane + 32 * t;
        if (c < D) acc[t] = fmaf(pn, vrow[c], acc[t]);
      }
    }
  }

  if (!active) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  float* orow = out + qbase + (size_t)i * C;
#pragma unroll
  for (int t = 0; t < kMaxD / 32; ++t) {
    const int c = lane + 32 * t;
    if (c < D) orow[c] = acc[t] * inv;
  }
}

}  // namespace

// `scale` is 1/sqrt(D), rounded to fp32 by the caller as the JAX package
// rounds it. Returns the CUDA error code of the launch (0 on success). Does
// not synchronise; runs on `stream`.
extern "C" int masked_attention_forward(const float* q, const float* k,
                                        const float* v,
                                        const unsigned char* mask,
                                        float* out, int B, int Tq, int Tk,
                                        int H, int D, float scale,
                                        void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kTile * (D + 1) +
                                       (size_t)kTile * D + (size_t)kRows * D);
  cudaError_t err = cudaFuncSetAttribute(
      masked_attention_fwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  masked_attention_fwd_kernel<<<grid, kRows * 32, smem,
                                (cudaStream_t)stream>>>(
      q, k, v, mask, out, Tq, Tk, H, D, scale);
  return (int)cudaGetLastError();
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* masked_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
