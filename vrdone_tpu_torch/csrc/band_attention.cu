// Banded (sliding-window) attention forward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel vrdone_tpu/ops/pallas/band_attention.py::_band_kernel
// (forward, no relative-position bias), reached through _head_forward and
// band_attention_pallas. Semantics are those of the dense oracle
// vrdone_tpu/ops/masked.py::band_attention: query i attends keys j with
// |i - j| <= w, scores scaled by 1/sqrt(d), an in-band key that is masked
// invalid gets an additive -1e4 (not -inf), keys outside the band or the
// sequence are excluded, and a row whose query is invalid is written as 0.
//
// What bounds it on this card: at the eval shapes (d = 128, w = 3, T <= 768)
// each query row does (2w+1)*d*4 flops against 3*d*4 bytes of q, k and v, so
// the kernel is bound by device-memory traffic, not arithmetic. The design
// therefore reads each q, k and v element from device memory about once:
// a block owns kRows consecutive query rows of one (batch, head) and stages
// the key/value slab [i0 - w, i0 + kRows + w) in shared memory, so the halo
// costs 2w/kRows extra reads. Inside the block one warp serves one query row
// and one lane one key of its band (2w+1 <= 31 keys), which puts the whole
// softmax in registers with two warp reductions and needs no online
// rescaling. The key slab is stored with a row stride of d+1 floats, so the
// 32 lanes reading 32 different keys hit 32 different banks.
//
// Layout: q, k, v and out are (B, T, H*d) contiguous with heads split
// head-major along the channels (channels [h*d, (h+1)*d) are head h), as the
// JAX package's _split_heads lays them out, so no transpose is needed
// around the call. mask is (B, T) bool (one byte each). Takes any T (no
// padding), 1 <= d <= 256 and 0 <= w <= 15; the Python wrapper rejects
// anything else before the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kRows = 16;         // query rows per block, one warp each
constexpr int kMaxD = 256;        // head dim bound (kMaxD / 32 floats a lane)
constexpr int kMaxW = 15;         // 2w + 1 <= 31: one lane per key
constexpr float kNegBig = -1e4f;  // additive mask of an invalid in-band key

__global__ void __launch_bounds__(kRows * 32)
band_attention_fwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const unsigned char* __restrict__ mask,
                          float* __restrict__ out,
                          int T, int H, int D, int w, float scale) {
  extern __shared__ float smem[];
  const int slab = kRows + 2 * w;
  const int kstride = D + 1;
  float* ks = smem;                    // slab x (D + 1)
  float* vs = ks + slab * kstride;     // slab x D
  float* qs = vs + slab * D;           // kRows x D, pre-scaled

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int i0 = blockIdx.y * kRows;
  const int j0 = i0 - w;               // sequence index of slab row 0
  const int C = H * D;
  const size_t base = (size_t)b * T * C + (size_t)h * D;
  const unsigned char* mrow = mask + (size_t)b * T;

  for (int idx = threadIdx.x; idx < slab * D; idx += blockDim.x) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int j = j0 + r;
    float kv = 0.f, vv = 0.f;
    if (j >= 0 && j < T) {
      const size_t off = base + (size_t)j * C + c;
      kv = k[off];
      vv = v[off];
    }
    ks[r * kstride + c] = kv;
    vs[r * D + c] = vv;
  }
  for (int idx = threadIdx.x; idx < kRows * D; idx += blockDim.x) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int i = i0 + r;
    qs[idx] = i < T ? q[base + (size_t)i * C + c] * scale : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = i0 + warp;
  if (i >= T) return;  // whole warp leaves together: no later barrier

  // lane l scores key j = i - w + l, which sits at slab row warp + l
  const int j = i - w + lane;
  float s = -INFINITY;
  if (lane <= 2 * w && j >= 0 && j < T) {
    const float* qrow = qs + warp * D;
    const float* krow = ks + (warp + lane) * kstride;
    float dot = 0.f;
    for (int c = 0; c < D; ++c) dot = fmaf(qrow[c], krow[c], dot);
    s = dot + (mrow[j] ? 0.f : kNegBig);
  }
  // the query's own key (lane w) is always in the sequence, so m is finite
  float m = s;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float p = s == -INFINITY ? 0.f : expf(s - m);
  float l = p;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);

  float acc[kMaxD / 32];
#pragma unroll
  for (int t = 0; t < kMaxD / 32; ++t) acc[t] = 0.f;
  for (int n = 0; n <= 2 * w; ++n) {
    const float pn = __shfl_sync(0xffffffffu, p, n);
    if (pn == 0.f) continue;  // pn is the same in every lane
    const float* vrow = vs + (warp + n) * D;
#pragma unroll
    for (int t = 0; t < kMaxD / 32; ++t) {
      const int c = lane + 32 * t;
      if (c < D) acc[t] = fmaf(pn, vrow[c], acc[t]);
    }
  }
  const float keep = mrow[i] ? 1.f / l : 0.f;
  float* orow = out + base + (size_t)i * C;
#pragma unroll
  for (int t = 0; t < kMaxD / 32; ++t) {
    const int c = lane + 32 * t;
    if (c < D) orow[c] = acc[t] * keep;
  }
}

}  // namespace

// `scale` is 1/sqrt(D), rounded to fp32 by the caller as the JAX package
// rounds it. Returns the CUDA error code of the launch (0 on success). Does
// not synchronise; runs on `stream`.
extern "C" int band_attention_forward(const float* q, const float* k,
                                      const float* v,
                                      const unsigned char* mask, float* out,
                                      int B, int T, int H, int D, int w,
                                      float scale, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1 || D > kMaxD || w < 0 || w > kMaxW)
    return (int)cudaErrorInvalidValue;
  const int slab = kRows + 2 * w;
  const size_t smem =
      sizeof(float) * ((size_t)slab * (D + 1) + (size_t)slab * D +
                       (size_t)kRows * D);
  cudaError_t err = cudaFuncSetAttribute(
      band_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  band_attention_fwd_kernel<<<grid, kRows * 32, smem,
                              (cudaStream_t)stream>>>(
      q, k, v, mask, out, T, H, D, w, scale);
  return (int)cudaGetLastError();
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* band_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
