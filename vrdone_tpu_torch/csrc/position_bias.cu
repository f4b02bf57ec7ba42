// MEGA's geometric position bias for Hopper (sm_90a), fp32: the (G, N, M)
// tensor log(relu(Wg . PE(q_rois[n], k_rois[m]) + b) + 1e-6).
//
// Replaces the TPU kernel vrdone_tpu/ops/pallas/position_bias.py::
// fused_position_bias (pallas_call at 177, body _bias_kernel at 95 and
// bias_tile at 49). It serves MEGAHead.attention's dense route with
// fused_pe_bias on; the fused set-attention kernel computes the same bias
// inside itself (mega_bias.cuh holds the device code of both).
//
// What bounds it on this card: each pair costs 2 logf and 16 sincosf, then
// G * 64 fmaf (32 features times the group's weights, 32 separable factors)
// and G logf, and writes G floats. At the detector's shape (G = 16, N = 675,
// M = 3750) that is 2.6e9 fmaf against 162 MB of output, so the fp32 pipes
// and the store rate are within a factor of two of each other; the
// transcendentals come next. The design: one thread per (n, m) pair writes
// all G outputs of that pair, so its transcendentals are computed once;
// neighbouring threads take neighbouring keys, so every store of a group row
// is coalesced. A block owns kRows query rows and kThreads keys: the rows'
// separable factors A[:, n, :] and the weights sit in shared memory, read
// as broadcasts; each thread keeps its key's 32 factors of B in registers
// across the rows.
//
// Layout: q_rois (N, 4), k_rois (M, 4) xyxy; A (G, N, 32); Bt (32, M);
// wt (G, 32) = Wg[:32].T; b (G,); out (G, N, M); all fp32, contiguous.
// The Python wrapper checks G <= 32 and the shapes before the launch.

#include <cuda_runtime.h>
#include <stddef.h>

#include "mega_bias.cuh"

namespace {

using mega_bias::Box;
using mega_bias::Freqs;
using mega_bias::kPairFeat;
using mega_bias::kSepDim;

constexpr int kThreads = 128;  // keys per block, one each
constexpr int kRows = 8;       // query rows per block
constexpr int kMaxGroups = 32;

__global__ void __launch_bounds__(kThreads)
position_bias_kernel(const float* __restrict__ q_rois,
                     const float* __restrict__ k_rois,
                     const float* __restrict__ A, const float* __restrict__ Bt,
                     const float* __restrict__ wt, const float* __restrict__ b,
                     float* __restrict__ out, int N, int M, int G, Freqs fr) {
  __shared__ float wt_s[kMaxGroups * kPairFeat];
  __shared__ float b_s[kMaxGroups];
  __shared__ float a_s[kMaxGroups * kRows * kSepDim];
  const int n0 = blockIdx.y * kRows;
  for (int idx = threadIdx.x; idx < G * kPairFeat; idx += kThreads)
    wt_s[idx] = wt[idx];
  for (int idx = threadIdx.x; idx < G; idx += kThreads) b_s[idx] = b[idx];
  for (int idx = threadIdx.x; idx < G * kRows * kSepDim; idx += kThreads) {
    const int g = idx / (kRows * kSepDim);
    const int r = (idx / kSepDim) % kRows;
    const int j = idx % kSepDim;
    const int n = n0 + r;
    a_s[idx] = n < N ? A[((size_t)g * N + n) * kSepDim + j] : 0.f;
  }
  __syncthreads();

  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const Box kb = mega_bias::load_box(k_rois + 4 * (size_t)m);
  float bk[kSepDim];
#pragma unroll
  for (int j = 0; j < kSepDim; ++j) bk[j] = Bt[(size_t)j * M + m];
  for (int r = 0; r < kRows; ++r) {
    const int n = n0 + r;
    if (n >= N) break;
    const Box qb = mega_bias::load_box(q_rois + 4 * (size_t)n);
    float f[kPairFeat];
    mega_bias::pair_features(qb, kb, fr, f);
    for (int g = 0; g < G; ++g)
      out[((size_t)g * N + n) * M + m] = mega_bias::group_bias(
          wt_s + g * kPairFeat, a_s + (g * kRows + r) * kSepDim, f, bk,
          b_s[g]);
  }
}

}  // namespace

// `freqs` points to the 8 fp32 rates on the host. Returns the CUDA error
// code of the launch (0 on success). Does not synchronise; runs on `stream`.
extern "C" int position_bias_forward(const float* q_rois, const float* k_rois,
                                     const float* A, const float* Bt,
                                     const float* wt, const float* b,
                                     float* out, int N, int M, int G,
                                     const float* freqs, void* stream) {
  if (N < 1 || M < 1 || G < 1 || G > kMaxGroups || freqs == nullptr)
    return (int)cudaErrorInvalidValue;
  Freqs fr;
  for (int i = 0; i < mega_bias::kFreqs; ++i) fr.c[i] = freqs[i];
  const dim3 grid((M + kThreads - 1) / kThreads, (N + kRows - 1) / kRows);
  position_bias_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      q_rois, k_rois, A, Bt, wt, b, out, N, M, G, fr);
  return (int)cudaGetLastError();
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* position_bias_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
