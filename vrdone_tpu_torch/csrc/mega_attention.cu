// MEGA's fused grouped set-attention forward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel vrdone_tpu/ops/pallas/mega_attention.py::
// fused_mega_attention (pallas_call at 177, body _attn_kernel at 56). Per
// group g of G, query row n and key m:
//   s = (q[g, n] . k[g, m]) * scale + ub[g, m] (+ bias[g, n, m], local only)
// softmax over the valid keys m, then out[n, g*DGO:(g+1)*DGO] =
// sum_m p * vproj[g, m]. A row with no valid key is written as 0. The value
// projection vproj = V @ Wv_g, ub = (u . k^T) * scale and Wv's output bias
// stay outside, as in the JAX package. The bias is the position-bias
// kernel's (mega_bias.cuh), computed tile by tile and never stored.
//
// What bounds it on this card: at the detector's stage-0 shape (G = 16,
// N = 675 queries, M = 3750 keys, DG = DGO = 64) the scores and the P.V sum
// are 2 * 16 * 675 * 3750 * 64 fmaf (10.4 GFLOP) on the fp32 pipes, with
// the bias adding 1024 fmaf and 18 transcendentals per pair; its bytes in
// and out (q, k, vproj, rois, the output) are about 35 MB. It is bound by
// operations.
//
// The design:
// - A block owns kRows(DGO) query rows and ALL G groups, one warp per
//   group, and walks the keys in tiles of 32 itself (the sequential key
//   grid axis of the Pallas kernel becomes this loop; blocks run in no
//   order and share nothing).
// - The geometric bias is shared across the groups: for each key tile the
//   whole block first computes the (G, rows, 32) bias tile into shared
//   memory, one thread per (row, key) pair, so a pair's logf and sincosf
//   run once and serve all G groups (a block owning one group would run
//   them G = 16 times). The rows' separable factors and the weights are
//   staged once per block.
// - Scores: lane j of warp g takes key j of the tile and the block's rows,
//   reading its key row from device memory and the rows' queries from
//   shared memory as broadcasts. Online softmax per (g, row) in registers.
//   P.V: each lane owns DGO / 32 output channels of every row; the key's
//   probability comes by shuffle and its vproj row is read once,
//   coalesced, for all rows.
// - The all-invalid sentinel: invalid keys (and keys past M, which the
//   kernel masks itself; the inputs are not padded) score -inf, a tile
//   with no valid key is skipped before any exp, and the running max is
//   only ever taken over finite scores, so no exp(-inf - -inf) arises. A
//   row whose keys are all invalid keeps l = 0 and is written as exactly 0.
//
// Layout: q (G, N, DG), k (G, M, DG), vproj (G, M, DGO), ub (G, M), valid
// (M,) bool (one byte each), out (N, G * DGO); with the bias, q_rois (N, 4),
// k_rois (M, 4), A (G, N, 32), Bt (32, M), wt (G, 32), b (G,). All fp32
// and contiguous. G <= 16, DG and DGO <= 256; the Python wrapper checks
// them before the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "mega_bias.cuh"

namespace {

using mega_bias::Box;
using mega_bias::Freqs;
using mega_bias::kPairFeat;
using mega_bias::kSepDim;

constexpr int kTile = 32;       // keys per tile, one lane each
constexpr int kMaxGroups = 16;  // one warp each
constexpr int kMaxDim = 256;

struct Params {
  const float* q;
  const float* k;
  const float* vproj;
  const float* ub;
  const unsigned char* valid;
  const float* q_rois;  // null: no bias (the global flavour)
  const float* k_rois;
  const float* A;
  const float* Bt;
  const float* wt;
  const float* b;
  float* out;
  int N, M, G, DG, DGO;
  float scale;
  Freqs fr;
};

// kRows query rows per block and DPL = ceil(DGO / 32) output floats a lane
// per row: kRows * DPL <= 16 keeps the accumulators at 16 registers.
template <int kRows, int DPL>
__global__ void __launch_bounds__(kMaxGroups * 32)
mega_attention_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int G = p.G, DG = p.DG, DGO = p.DGO, N = p.N, M = p.M;
  const bool with_bias = p.q_rois != nullptr;
  float* q_s = smem;                          // G x kRows x DG
  float* bias_s = q_s + G * kRows * DG;       // G x kRows x kTile
  float* a_s = bias_s + G * kRows * kTile;    // G x kRows x 32
  float* bt_s = a_s + G * kRows * kSepDim;    // 32 x kTile
  float* wt_s = bt_s + kSepDim * kTile;       // G x 32
  float* b_s = wt_s + G * kPairFeat;          // G
  float* qbox_s = b_s + G;                    // kRows x 4

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int n0 = blockIdx.x * kRows;
  for (int idx = tid; idx < G * kRows * DG; idx += nthreads) {
    const int g = idx / (kRows * DG);
    const int r = (idx / DG) % kRows;
    const int c = idx % DG;
    const int n = n0 + r;
    q_s[idx] = n < N ? p.q[((size_t)g * N + n) * DG + c] : 0.f;
  }
  if (with_bias) {
    for (int idx = tid; idx < G * kRows * kSepDim; idx += nthreads) {
      const int g = idx / (kRows * kSepDim);
      const int r = (idx / kSepDim) % kRows;
      const int n = n0 + r;
      a_s[idx] = n < N ? p.A[((size_t)g * N + n) * kSepDim + idx % kSepDim]
                       : 0.f;
    }
    for (int idx = tid; idx < G * kPairFeat; idx += nthreads)
      wt_s[idx] = p.wt[idx];
    for (int idx = tid; idx < G; idx += nthreads) b_s[idx] = p.b[idx];
    for (int idx = tid; idx < kRows * 4; idx += nthreads) {
      const int n = n0 + idx / 4;
      qbox_s[idx] = n < N ? p.q_rois[(size_t)n * 4 + idx % 4] : 0.f;
    }
  }
  __syncthreads();

  const int g = tid >> 5;
  const int lane = tid & 31;
  const float* qg = q_s + g * kRows * DG;
  const float* kg = p.k + (size_t)g * M * DG;
  const float* vg = p.vproj + (size_t)g * M * DGO;
  // float4 loads of the key rows where the widths and the base allow them
  const bool vec4 = (DG & 3) == 0 && (reinterpret_cast<size_t>(p.k) & 15) == 0;

  float m_run[kRows], l_run[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;
  }

  for (int m0 = 0; m0 < M; m0 += kTile) {
    if (with_bias) {
      __syncthreads();  // the previous tile's bias is consumed
      for (int idx = tid; idx < kSepDim * kTile; idx += nthreads) {
        const int m = m0 + idx % kTile;
        bt_s[idx] = m < M ? p.Bt[(size_t)(idx / kTile) * M + m] : 0.f;
      }
      __syncthreads();
      // the (G, kRows, kTile) bias tile: each pair once, for every group
      for (int pr = tid; pr < kRows * kTile; pr += nthreads) {
        const int r = pr / kTile;
        const int t = pr % kTile;
        const int m = m0 + t;
        if (n0 + r >= N || m >= M) continue;
        const Box qb = mega_bias::load_box(qbox_s + 4 * r);
        const Box kb = mega_bias::load_box(p.k_rois + 4 * (size_t)m);
        float f[kPairFeat], bk[kSepDim];
        mega_bias::pair_features(qb, kb, p.fr, f);
#pragma unroll
        for (int j = 0; j < kSepDim; ++j) bk[j] = bt_s[j * kTile + t];
        for (int gg = 0; gg < G; ++gg)
          bias_s[(gg * kRows + r) * kTile + t] = mega_bias::group_bias(
              wt_s + gg * kPairFeat, a_s + (gg * kRows + r) * kSepDim, f, bk,
              b_s[gg]);
      }
      __syncthreads();
    }

    const int m = m0 + lane;
    const bool valid = m < M && p.valid[m];
    const unsigned vmask = __ballot_sync(0xffffffffu, valid);
    if (vmask == 0u) continue;  // the same in every warp: m0 is shared

    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    if (valid) {
      const float* krow = kg + (size_t)m * DG;
      if (vec4) {
        for (int c = 0; c < DG; c += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qg + r * DG + c);
            s[r] = fmaf(qv.x, kv.x, s[r]);
            s[r] = fmaf(qv.y, kv.y, s[r]);
            s[r] = fmaf(qv.z, kv.z, s[r]);
            s[r] = fmaf(qv.w, kv.w, s[r]);
          }
        }
      } else {
        for (int c = 0; c < DG; ++c) {
          const float kv = krow[c];
#pragma unroll
          for (int r = 0; r < kRows; ++r) s[r] = fmaf(qg[r * DG + c], kv, s[r]);
        }
      }
      const float u = p.ub[(size_t)g * M + m];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = s[r] * p.scale + u;
        if (with_bias) s[r] += bias_s[(g * kRows + r) * kTile + lane];
      }
    }

    // online softmax; every score below is finite or -inf (invalid), and
    // the tile holds at least one valid key, so each row's max is finite
    float pr_[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float tmax = valid ? s[r] : -INFINITY;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_new = fmaxf(m_run[r], tmax);
      const float alpha = expf(m_run[r] - m_new);  // 0 while m_run is -inf
      const float pv = valid ? expf(s[r] - m_new) : 0.f;
      float psum = pv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_run[r] = l_run[r] * alpha + psum;
      m_run[r] = m_new;
      pr_[r] = pv;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r][d] *= alpha;
    }

    const int n_keys = min(kTile, M - m0);
    for (int kk = 0; kk < n_keys; ++kk) {
      if (!((vmask >> kk) & 1u)) continue;  // warp-uniform
      const float* vrow = vg + (size_t)(m0 + kk) * DGO;
      float vv[DPL];
#pragma unroll
      for (int d = 0; d < DPL; ++d) {
        const int c = lane + 32 * d;
        vv[d] = c < DGO ? vrow[c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pk = __shfl_sync(0xffffffffu, pr_[r], kk);
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[r][d] = fmaf(pk, vv[d], acc[r][d]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int n = n0 + r;
    if (n >= N) break;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    float* orow = p.out + (size_t)n * G * DGO + (size_t)g * DGO;
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      const int c = lane + 32 * d;
      if (c < DGO) orow[c] = acc[r][d] * inv;
    }
  }
}

template <int kRows, int DPL>
int launch(const Params& p, cudaStream_t stream) {
  const size_t floats = (size_t)p.G * kRows * p.DG +
                        (size_t)p.G * kRows * kTile +
                        (size_t)p.G * kRows * kSepDim + kSepDim * kTile +
                        (size_t)p.G * kPairFeat + p.G + kRows * 4;
  const size_t smem = sizeof(float) * floats;
  cudaError_t err = cudaFuncSetAttribute(
      mega_attention_kernel<kRows, DPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + kRows - 1) / kRows);
  mega_attention_kernel<kRows, DPL><<<grid, 32 * p.G, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// With q_rois null the kernel adds no bias and reads none of k_rois, A, Bt,
// wt, b or freqs; else `freqs` points to the 8 fp32 rates on the host.
// `scale` is 1/sqrt(DG). Returns the CUDA error code of the launch (0 on
// success). Does not synchronise; runs on `stream`.
extern "C" int mega_attention_forward(
    const float* q, const float* k, const float* vproj, const float* ub,
    const unsigned char* valid, const float* q_rois, const float* k_rois,
    const float* A, const float* Bt, const float* wt, const float* b,
    float* out, int N, int M, int G, int DG, int DGO, float scale,
    const float* freqs, void* stream) {
  if (N < 1 || M < 0 || G < 1 || G > kMaxGroups || DG < 1 || DG > kMaxDim ||
      DGO < 1 || DGO > kMaxDim || (q_rois != nullptr && freqs == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, vproj, ub, valid, q_rois, k_rois, A, Bt, wt, b, out,
           N, M, G, DG, DGO, scale, {}};
  if (q_rois != nullptr)
    for (int i = 0; i < mega_bias::kFreqs; ++i) p.fr.c[i] = freqs[i];
  const cudaStream_t s = (cudaStream_t)stream;
  if (DGO <= 32) return launch<8, 1>(p, s);
  if (DGO <= 64) return launch<8, 2>(p, s);
  if (DGO <= 128) return launch<4, 4>(p, s);
  return launch<2, 8>(p, s);
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* mega_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
