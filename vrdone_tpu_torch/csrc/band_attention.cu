// Banded (sliding-window) attention for Hopper (sm_90a), fp32: the forward
// with its per-row log-sum-exp, the forward with a relative-position bias,
// and the two backward kernels.
//
// Replaces the TPU kernels of vrdone_tpu/ops/pallas/band_attention.py:
//   * band_attention_fwd_kernel  <- _band_kernel (forward, no relative-
//     position bias), reached through _head_forward; with a non-null `lse`
//     it also writes lse = m + log(l) per query row, as _head_forward does;
//   * band_attention_pe_fwd_kernel <- _band_kernel(with_pe=True), reached
//     through band_attention_pallas(rel_pe=...) and masked._band_pallas_pe:
//     the same forward with rel_pe[h, clip(j - i + w, 0, window_size - 1)]
//     added to each in-band score before the key mask. The Pallas kernel
//     adds host-built (H, 3, block, block) bias tiles; here lane l of a
//     band already scores key i - w + l, so its bias is the one table
//     entry rel_pe[h, min(l, window_size - 1)], read into a register. The
//     clamp matters for an even window_size, where 2w + 1 > window_size.
//     both forwards share one templated body, so K1's code is unchanged.
//     The JAX package pairs this forward with the dense backward, and so
//     does the port (no backward kernel);
//   * band_attention_dq_kernel   <- _dq_kernel (dQ), launched by
//     _band_core_bwd;
//   * band_attention_dkv_kernel  <- _dkv_kernel (dK, dV), launched by
//     _band_core_bwd.
// Semantics are those of the dense oracle vrdone_tpu/ops/masked.py::
// band_attention: query i attends keys j with |i - j| <= w, scores scaled by
// 1/sqrt(d), an in-band key that is masked invalid gets an additive -1e4
// (not -inf), keys outside the band or the sequence are excluded, and a row
// whose query is invalid is written as 0. In the backward such a row has
// dQ = 0 and no share in dK or dV, whatever upstream gradient it is given,
// because its output does not depend on any input.
//
// Backward math, with P = exp(S - lse) rebuilt from the saved lse and
// Dr = rowsum(dO * O) computed by the caller:
//   dS = P * (dO . V^T - Dr),  dQ = scale * dS . K,
//   dK = scale * dS^T . Q,     dV = P^T . dO.
//
// What bounds them on this card: at the slice's shapes (d = 128, w = 3,
// T <= 768) each query row does a few times (2w+1)*d*2 flops against a
// handful of d-float rows, so all three kernels are bound by device-memory
// traffic, not arithmetic. The design reads each input element from device
// memory about once: a block owns kRows consecutive rows of one
// (batch, head) and stages the neighbouring slab of kRows + 2w rows that its
// bands reach in shared memory, so the halo costs 2w/kRows extra reads.
// One warp serves one owned row and one lane one partner of its band
// (2w+1 <= 31), which keeps every softmax row in registers (two warp
// reductions, no online rescaling) and lets each lane compute its score as a
// dot product on its own. Slab rows that lanes read in parallel are stored
// at a stride of d+1 floats, so 32 lanes reading 32 rows hit 32 banks. The
// backward recomputes each score with the same fmaf chain as the forward, so
// P agrees with the lse it is divided by. K4 at the streaming shapes
// (d = 64, w = 4, T = 768) is bound by bytes in the same way; its table adds
// one cached 4-byte load a lane.
//   * dq: a block owns kRows query rows and stages keys and values
//     [i0 - w, i0 + kRows + w); lane l of warp r rebuilds P and dS of key
//     i - w + l, then the warp sums dS . K over its band with lanes over the
//     channels.
//   * dkv: the mirror image. A block owns kRows key rows and stages queries,
//     upstream gradients, lse and Dr of rows [j0 - w, j0 + kRows + w);
//     lane l of warp r takes query j - w + l of key j's band.
//
// Layout: q, k, v, out, dout, dq, dk, dv are (B, T, H*d) contiguous with
// heads split head-major along the channels (channels [h*d, (h+1)*d) are
// head h), as the JAX package's _split_heads lays them out, so no transpose
// is needed around the calls. mask is (B, T) bool (one byte each); lse and
// Dr are (B, H, T) fp32; rel_pe is (H, window_size) fp32. Takes any T (no padding), 1 <= d <= 256 and
// 0 <= w <= 15; the Python wrapper rejects anything else before the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kRows = 16;         // owned rows per block, one warp each
constexpr int kMaxD = 256;        // head dim bound (kMaxD / 32 floats a lane)
constexpr int kMaxW = 15;         // 2w + 1 <= 31: one lane per band partner
constexpr int kChan = kMaxD / 32; // channels a lane owns in a row sum
constexpr float kNegBig = -1e4f;  // additive mask of an invalid in-band key

__device__ __forceinline__ float dot_row(const float* a, const float* b,
                                         int D) {
  float dot = 0.f;
  for (int c = 0; c < D; ++c) dot = fmaf(a[c], b[c], dot);
  return dot;
}

// Stage rows [r0, r0 + rows) of one head of a (B, T, H*d) stream at `dst`
// with row stride `stride`, zero outside [0, T), each value times `mul`.
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           size_t base, int r0, int rows,
                                           int T, int C, int D, int stride,
                                           float mul) {
  for (int idx = threadIdx.x; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int t = r0 + r;
    dst[r * stride + c] =
        (t >= 0 && t < T) ? src[base + (size_t)t * C + c] * mul : 0.f;
  }
}

// The forward body. With kPE, lane l adds rel_pe[h, min(l, npe - 1)]
// ((H, npe) table) to its score, between the scaled dot product and the
// key mask, the order of the dense form's additions.
template <bool kPE>
__device__ __forceinline__ void band_forward_body(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const unsigned char* __restrict__ mask,
    const float* __restrict__ rel_pe, float* __restrict__ out,
    float* __restrict__ lse, int T, int H, int D, int w, int npe,
    float scale) {
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
  const int C = H * D;
  const size_t base = (size_t)b * T * C + (size_t)h * D;
  const unsigned char* mrow = mask + (size_t)b * T;

  stage_rows(ks, k, base, i0 - w, slab, T, C, D, kstride, 1.f);
  stage_rows(vs, v, base, i0 - w, slab, T, C, D, D, 1.f);
  stage_rows(qs, q, base, i0, kRows, T, C, D, D, scale);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = i0 + warp;
  if (i >= T) return;  // whole warp leaves together: no later barrier

  // lane l scores key j = i - w + l, which sits at slab row warp + l
  const int j = i - w + lane;
  float s = -INFINITY;
  if (lane <= 2 * w && j >= 0 && j < T) {
    s = dot_row(qs + warp * D, ks + (warp + lane) * kstride, D);
    if (kPE) s += __ldg(rel_pe + h * npe + min(lane, npe - 1));
    s += mrow[j] ? 0.f : kNegBig;
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

  float acc[kChan];
#pragma unroll
  for (int t = 0; t < kChan; ++t) acc[t] = 0.f;
  for (int n = 0; n <= 2 * w; ++n) {
    const float pn = __shfl_sync(0xffffffffu, p, n);
    if (pn == 0.f) continue;  // pn is the same in every lane
    const float* vrow = vs + (warp + n) * D;
#pragma unroll
    for (int t = 0; t < kChan; ++t) {
      const int c = lane + 32 * t;
      if (c < D) acc[t] = fmaf(pn, vrow[c], acc[t]);
    }
  }
  const float keep = mrow[i] ? 1.f / l : 0.f;
  float* orow = out + base + (size_t)i * C;
#pragma unroll
  for (int t = 0; t < kChan; ++t) {
    const int c = lane + 32 * t;
    if (c < D) orow[c] = acc[t] * keep;
  }
  if (lse != nullptr && lane == 0) lse[(size_t)bh * T + i] = m + logf(l);
}

__global__ void __launch_bounds__(kRows * 32)
band_attention_fwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const unsigned char* __restrict__ mask,
                          float* __restrict__ out, float* __restrict__ lse,
                          int T, int H, int D, int w, float scale) {
  band_forward_body<false>(q, k, v, mask, nullptr, out, lse, T, H, D, w, 1,
                           scale);
}

__global__ void __launch_bounds__(kRows * 32)
band_attention_pe_fwd_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const unsigned char* __restrict__ mask,
                             const float* __restrict__ rel_pe,
                             float* __restrict__ out, int T, int H, int D,
                             int w, int npe, float scale) {
  band_forward_body<true>(q, k, v, mask, rel_pe, out, nullptr, T, H, D, w,
                          npe, scale);
}

__global__ void __launch_bounds__(kRows * 32)
band_attention_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const unsigned char* __restrict__ mask,
                         const float* __restrict__ lse,
                         const float* __restrict__ dr,
                         const float* __restrict__ dout,
                         float* __restrict__ dq,
                         int T, int H, int D, int w, float scale) {
  extern __shared__ float smem[];
  const int slab = kRows + 2 * w;
  const int stride = D + 1;
  float* ks = smem;                    // slab x (D + 1)
  float* vs = ks + slab * stride;      // slab x (D + 1)
  float* qs = vs + slab * stride;      // kRows x D, pre-scaled
  float* dos = qs + kRows * D;         // kRows x D

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int i0 = blockIdx.y * kRows;
  const int C = H * D;
  const size_t base = (size_t)b * T * C + (size_t)h * D;
  const unsigned char* mrow = mask + (size_t)b * T;

  stage_rows(ks, k, base, i0 - w, slab, T, C, D, stride, 1.f);
  stage_rows(vs, v, base, i0 - w, slab, T, C, D, stride, 1.f);
  stage_rows(qs, q, base, i0, kRows, T, C, D, D, scale);
  stage_rows(dos, dout, base, i0, kRows, T, C, D, D, 1.f);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = i0 + warp;
  if (i >= T) return;  // whole warp leaves together: no later barrier

  float* dqrow = dq + base + (size_t)i * C;
  if (!mrow[i]) {  // an invalid query row's output is constant 0
    for (int c = lane; c < D; c += 32) dqrow[c] = 0.f;
    return;
  }
  const int j = i - w + lane;
  float ds = 0.f;
  if (lane <= 2 * w && j >= 0 && j < T) {
    const float s = dot_row(qs + warp * D, ks + (warp + lane) * stride, D) +
                    (mrow[j] ? 0.f : kNegBig);
    const float p = expf(s - lse[(size_t)bh * T + i]);
    const float dp = dot_row(dos + warp * D, vs + (warp + lane) * stride, D);
    ds = p * (dp - dr[(size_t)bh * T + i]);
  }
  float acc[kChan];
#pragma unroll
  for (int t = 0; t < kChan; ++t) acc[t] = 0.f;
  for (int n = 0; n <= 2 * w; ++n) {
    const float dn = __shfl_sync(0xffffffffu, ds, n);
    const float* krow = ks + (warp + n) * stride;
#pragma unroll
    for (int t = 0; t < kChan; ++t) {
      const int c = lane + 32 * t;
      if (c < D) acc[t] = fmaf(dn, krow[c], acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kChan; ++t) {
    const int c = lane + 32 * t;
    if (c < D) dqrow[c] = acc[t] * scale;
  }
}

__global__ void __launch_bounds__(kRows * 32)
band_attention_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ lse,
                          const float* __restrict__ dr,
                          const float* __restrict__ dout,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int T, int H, int D, int w, float scale) {
  extern __shared__ float smem[];
  const int slab = kRows + 2 * w;
  const int stride = D + 1;
  float* qs = smem;                    // slab x (D + 1), pre-scaled
  float* dos = qs + slab * stride;     // slab x (D + 1)
  float* ks = dos + slab * stride;     // kRows x D
  float* vs = ks + kRows * D;          // kRows x D
  float* ls = vs + kRows * D;          // slab: lse of the slab's queries
  float* drs = ls + slab;              // slab: Dr of the slab's queries

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int j0 = blockIdx.y * kRows;
  const int C = H * D;
  const size_t base = (size_t)b * T * C + (size_t)h * D;
  const unsigned char* mrow = mask + (size_t)b * T;

  stage_rows(qs, q, base, j0 - w, slab, T, C, D, stride, scale);
  stage_rows(dos, dout, base, j0 - w, slab, T, C, D, stride, 1.f);
  stage_rows(ks, k, base, j0, kRows, T, C, D, D, 1.f);
  stage_rows(vs, v, base, j0, kRows, T, C, D, D, 1.f);
  for (int r = threadIdx.x; r < slab; r += blockDim.x) {
    const int t = j0 - w + r;
    const bool in = t >= 0 && t < T;
    ls[r] = in ? lse[(size_t)bh * T + t] : 0.f;
    drs[r] = in ? dr[(size_t)bh * T + t] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = j0 + warp;
  if (j >= T) return;  // whole warp leaves together: no later barrier

  // lane l takes query i = j - w + l, at slab row warp + l; an invalid
  // query row has no share in dK or dV
  const int i = j - w + lane;
  float p = 0.f, ds = 0.f;
  if (lane <= 2 * w && i >= 0 && i < T && mrow[i]) {
    const int r = warp + lane;
    const float s = dot_row(qs + r * stride, ks + warp * D, D) +
                    (mrow[j] ? 0.f : kNegBig);
    p = expf(s - ls[r]);
    const float dp = dot_row(dos + r * stride, vs + warp * D, D);
    ds = p * (dp - drs[r]);
  }
  float acck[kChan], accv[kChan];
#pragma unroll
  for (int t = 0; t < kChan; ++t) acck[t] = accv[t] = 0.f;
  for (int n = 0; n <= 2 * w; ++n) {
    const float pn = __shfl_sync(0xffffffffu, p, n);
    const float dn = __shfl_sync(0xffffffffu, ds, n);
    const float* qrow = qs + (warp + n) * stride;
    const float* dorow = dos + (warp + n) * stride;
#pragma unroll
    for (int t = 0; t < kChan; ++t) {
      const int c = lane + 32 * t;
      if (c < D) {
        acck[t] = fmaf(dn, qrow[c], acck[t]);  // q is staged times scale
        accv[t] = fmaf(pn, dorow[c], accv[t]);
      }
    }
  }
  float* dkrow = dk + base + (size_t)j * C;
  float* dvrow = dv + base + (size_t)j * C;
#pragma unroll
  for (int t = 0; t < kChan; ++t) {
    const int c = lane + 32 * t;
    if (c < D) {
      dkrow[c] = acck[t];
      dvrow[c] = accv[t];
    }
  }
}

bool bad_shape(int B, int T, int H, int D, int w) {
  return B < 1 || T < 1 || H < 1 || D < 1 || D > kMaxD || w < 0 ||
         w > kMaxW;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// `scale` is 1/sqrt(D), rounded to fp32 by the caller as the JAX package
// rounds it. Each launch function returns the CUDA error code of its launch
// (0 on success), does not synchronise, and runs on `stream`.

// Forward. `lse` may be null (the eval path); otherwise it receives the
// (B, H, T) log-sum-exp of every row's scores.
extern "C" int band_attention_forward(const float* q, const float* k,
                                      const float* v,
                                      const unsigned char* mask, float* out,
                                      float* lse, int B, int T, int H, int D,
                                      int w, float scale, void* stream) {
  if (bad_shape(B, T, H, D, w)) return (int)cudaErrorInvalidValue;
  const int slab = kRows + 2 * w;
  const size_t smem =
      sizeof(float) * ((size_t)slab * (D + 1) + (size_t)slab * D +
                       (size_t)kRows * D);
  cudaError_t err = allow_smem(band_attention_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  band_attention_fwd_kernel<<<grid, kRows * 32, smem,
                              (cudaStream_t)stream>>>(
      q, k, v, mask, out, lse, T, H, D, w, scale);
  return (int)cudaGetLastError();
}

// Forward with the relative-position bias `rel_pe`, (H, window_size) fp32
// (K4). No lse: its backward recomputes the dense form.
extern "C" int band_attention_pe_forward(const float* q, const float* k,
                                         const float* v,
                                         const unsigned char* mask,
                                         const float* rel_pe, float* out,
                                         int B, int T, int H, int D, int w,
                                         int window_size, float scale,
                                         void* stream) {
  if (bad_shape(B, T, H, D, w) || window_size < 1)
    return (int)cudaErrorInvalidValue;
  const int slab = kRows + 2 * w;
  const size_t smem =
      sizeof(float) * ((size_t)slab * (D + 1) + (size_t)slab * D +
                       (size_t)kRows * D);
  cudaError_t err = allow_smem(band_attention_pe_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  band_attention_pe_fwd_kernel<<<grid, kRows * 32, smem,
                                 (cudaStream_t)stream>>>(
      q, k, v, mask, rel_pe, out, T, H, D, w, window_size, scale);
  return (int)cudaGetLastError();
}

// dQ from the forward's inputs, its lse, Dr = rowsum(dout * out) and dout.
extern "C" int band_attention_backward_dq(
    const float* q, const float* k, const float* v,
    const unsigned char* mask, const float* lse, const float* dr,
    const float* dout, float* dq, int B, int T, int H, int D, int w,
    float scale, void* stream) {
  if (bad_shape(B, T, H, D, w)) return (int)cudaErrorInvalidValue;
  const int slab = kRows + 2 * w;
  const size_t smem =
      sizeof(float) * (2 * (size_t)slab * (D + 1) + 2 * (size_t)kRows * D);
  cudaError_t err = allow_smem(band_attention_dq_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  band_attention_dq_kernel<<<grid, kRows * 32, smem,
                             (cudaStream_t)stream>>>(
      q, k, v, mask, lse, dr, dout, dq, T, H, D, w, scale);
  return (int)cudaGetLastError();
}

// dK and dV from the same inputs as band_attention_backward_dq.
extern "C" int band_attention_backward_dkv(
    const float* q, const float* k, const float* v,
    const unsigned char* mask, const float* lse, const float* dr,
    const float* dout, float* dk, float* dv, int B, int T, int H, int D,
    int w, float scale, void* stream) {
  if (bad_shape(B, T, H, D, w)) return (int)cudaErrorInvalidValue;
  const int slab = kRows + 2 * w;
  const size_t smem =
      sizeof(float) * (2 * (size_t)slab * (D + 1) + 2 * (size_t)kRows * D +
                       2 * (size_t)slab);
  cudaError_t err = allow_smem(band_attention_dkv_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (T + kRows - 1) / kRows);
  band_attention_dkv_kernel<<<grid, kRows * 32, smem,
                              (cudaStream_t)stream>>>(
      q, k, v, mask, lse, dr, dout, dk, dv, T, H, D, w, scale);
  return (int)cudaGetLastError();
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* band_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
