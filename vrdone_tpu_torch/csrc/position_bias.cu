// MEGA's geometric position bias for Hopper (sm_90a), fp32: the (G, N, M)
// tensor log(relu(Wg . PE(q_rois[n], k_rois[m]) + b) + 1e-6), and the
// tile-invariant factors that it and the fused set-attention kernel read.
//
// position_bias_kernel replaces the TPU kernel vrdone_tpu/ops/pallas/
// position_bias.py::fused_position_bias (pallas_call at 177, body
// _bias_kernel at 95 and bias_tile at 49). It serves MEGAHead.attention's
// dense route with fused_pe_bias on; the fused set-attention kernel
// computes the same bias inside itself (mega_bias.cuh holds the device code
// of both). bias_factors_kernel is the port of the XLA-side pe_setup (same
// file, 108), not of a TPU kernel: one launch in place of some 25 small
// torch kernels before each biased launch of either.
//
// What bounds position_bias_kernel on this card: at the detector's shape
// (G = 16, N = 675, M = 3750) the bias is a (G x 64) . (64 x pairs) product,
// 2.6e9 multiply-adds, against 162 MB of output (0.048 ms at 3.35 TB/s); per
// pair come 2 logf and 16 sincosf, and per output one log. On the fp32
// pipes with the operands read from shared memory, a design that only
// tiles registers is issue-bound near 0.13-0.19 ms. The design:
// - The product goes to the tensor cores: per query row and 8 keys, the
//   16 groups x 64 weights [wt | A_n] times [f(n, m); B(:, m)] is 4 k-steps
//   of mma.m16n8k16 on fp16 splits, x = hi + lo with both halves fp16,
//   summed as hi.hi + hi.lo + lo.hi in fp32: about fp32's precision (plain
//   TF32 or fp16 keeps three digits, too few for the gate-space
//   tolerance). Each row of weights is first scaled by a power of two
//   that puts its largest into [2^13, 2^14), so no half leaves fp16's
//   normal range; the scale is undone exactly in the epilogue (wt's per
//   group, A_n's per row and group, hence two accumulators). The fp16
//   product takes half the MMA instructions of 3xTF32 on m16n8k8 and half
//   the operand registers, and was the faster of the two on the card.
// - The features go straight into the B fragment: lane l holds rows
//   2 (l % 4), 2 (l % 4) + 1 and 8 on of key l / 4, so it computes sin and
//   cos of dx and dy at rates 2r and 2r + 1 (r = l % 4): 4 sincosf a lane a
//   pair and no feature twice. The pair's dx and dy come from one
//   log_offset a lane (lane l takes axis l & 1 of the key of tile
//   (l >> 1) & 1), a row ahead, and two shuffles. sincosf keeps its full
//   range reduction (mega_bias.cuh).
// - A warp owns 2 tiles of 8 keys and walks the block's kRows query rows:
//   its keys' B factors and the weights wt stay in registers, split; the
//   rows' A factors are staged once a block in shared memory, scaled, split
//   and in fragment order (one 16-byte load each of hi and lo a lane a
//   k-step). 3 blocks of 8 warps an SM.
// - Epilogue: log(relu(b + wt . f + A_n . B) + 1e-6) with the hardware's
//   log2 (finish_fast below); a lane's C fragment is 2 adjacent keys in 2
//   groups, stored as float2 with the streaming hint.
// - G up to 16 is one m-tile, rows past G carry zero weights and are not
//   stored; G up to 32 takes two m-tiles as grid.z, each recomputing the
//   features (the detector's G is 16).
// What still holds it back (PERF.md): the 8 sincosf a lane a row are about
// half of a warp's instructions, and each sincosf's slow-path branch keeps
// the next one's range reduction from starting early. Without the sines
// (a scratch test) the output's scattered 32-byte writes held it at about
// the same time.
//
// Layout: q_rois (N, 4), k_rois (M, 4) xyxy; A (G, N, 32); Bt (32, M);
// wt (G, 32) = Wg[:32].T; b (G,); out (G, N, M); Wg (64, G) with the strides
// given; all fp32, the others contiguous. The Python wrapper checks G <= 32
// and the shapes before the launch.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "mega_bias.cuh"

namespace {

using mega_bias::Freqs;
using mega_bias::kFreqs;
using mega_bias::kPairFeat;
using mega_bias::kSepDim;

constexpr int kMaxGroups = 32;
constexpr int kGroupTile = 16;  // the MMA's m: groups a block
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeyTiles = 2;    // 8-key n-tiles a warp
constexpr int kBlockKeys = kWarps * kKeyTiles * 8;
constexpr int kRows = 8;        // query rows a block walks
constexpr int kKSteps = 2;      // k-steps of 16 in each 32-wide half
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPairFeat == 16 * kKSteps && kSepDim == 16 * kKSteps,
              "each half of the embedding is 2 k-steps");
static_assert(kKeyTiles == 2, "a key's 4 lanes take 2 tiles x 2 axes");

// 2^k for k in [-126, 127]
__device__ __forceinline__ float pow2(int k) {
  return __int_as_float((127 + k) << 23);
}

// The exponent k that brings a row of largest magnitude mx into
// [2^13, 2^14), well inside fp16's range, at most 126 (for mx = 0).
__device__ __forceinline__ int row_scale(float mx) {
  return min(140 - ((__float_as_int(mx) >> 23) & 0xff), 126);
}

// x0, x1 as fp16 pairs: hi rounded to nearest, lo the rounded remainder
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t as_u32(__half2 h) {
  uint32_t u;
  memcpy(&u, &h, sizeof u);
  return u;
}

__device__ __forceinline__ Split split_f16(float x0, float x1) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 r = __half22float2(h);
  return {as_u32(h), as_u32(__floats2half2_rn(x0 - r.x, x1 - r.y))};
}

// d += a . b for one m16n8k16 tile (row-major A, column-major B, fp32 sums)
__device__ __forceinline__ void mma_f16(float d[4], const uint32_t a[4],
                                        const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b from the splits, hi.hi + hi.lo + lo.hi, the small ones first
__device__ __forceinline__ void mma_split(float d[4], const uint32_t ah[4],
                                          const uint32_t al[4],
                                          const uint32_t bh[2],
                                          const uint32_t bl[2]) {
  mma_f16(d, al, bh);
  mma_f16(d, ah, bl);
  mma_f16(d, ah, bh);
}

// finish() with the hardware's log2: lg2.approx's absolute error of about
// 2^-22 (in log2 units) is a relative error near 1e-7 in the gate, 200
// times below the gate-space tolerance (rtol 2e-5), at a tenth of logf's
// instructions in an issue-bound kernel.
__device__ __forceinline__ float finish_fast(float acc, float sep) {
  return __logf(fmaxf(acc + sep, 0.f) + 1e-6f);
}

__global__ void __launch_bounds__(kThreads, 3)
position_bias_kernel(const float* __restrict__ q_rois,
                     const float* __restrict__ k_rois,
                     const float* __restrict__ A, const float* __restrict__ Bt,
                     const float* __restrict__ wt, const float* __restrict__ b,
                     float* __restrict__ out, int N, int M, int G, Freqs fr) {
  // the rows' scaled A fragments, split: [row][k-step][lane], 4 words a
  // lane; the inverse of each (row, group)'s scale; the query boxes
  __shared__ uint4 a_hi[kRows * kKSteps * 32];
  __shared__ uint4 a_lo[kRows * kKSteps * 32];
  __shared__ float a_inv[kRows][kGroupTile];
  __shared__ float box_s[kRows][4];  // centre x, centre y, width, height
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.y * kRows, g0 = blockIdx.z * kGroupTile;

  // A[g0 + g, n0 + r, 2p .. 2p + 1], 16 threads a (row, group), scaled by
  // the power of two that takes the 32's largest into [2^13, 2^14): k-step
  // p / 8, column c = 2p % 16 of it, lane 4 (g % 8) + (c % 8) / 2, word
  // (g / 8) + 2 (c / 8) of the m16n8k16 A fragment
  constexpr int kStage = kGroupTile * kRows * kSepDim / 2 / kThreads;
  float2 av[kStage];
#pragma unroll
  for (int it = 0; it < kStage; ++it) {
    const int idx = tid + it * kThreads;
    const int p = idx % 16, r = idx / 16 % kRows, g = idx / (16 * kRows);
    av[it] = n0 + r < N && g0 + g < G
                 ? *reinterpret_cast<const float2*>(
                       A + ((size_t)(g0 + g) * N + n0 + r) * kSepDim + 2 * p)
                 : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int it = 0; it < kStage; ++it) {
    const int idx = tid + it * kThreads;
    const int p = idx % 16, r = idx / 16 % kRows, g = idx / (16 * kRows);
    float mx = fmaxf(fabsf(av[it].x), fabsf(av[it].y));
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const int k = row_scale(mx);
    const Split w = split_f16(av[it].x * pow2(k), av[it].y * pow2(k));
    const int c = 2 * p % 16;
    const int word = ((r * kKSteps + p / 8) * 32 + 4 * (g % 8) + c % 8 / 2) * 4 +
                     g / 8 + 2 * (c / 8);
    reinterpret_cast<uint32_t*>(a_hi)[word] = w.hi;
    reinterpret_cast<uint32_t*>(a_lo)[word] = w.lo;
    if (p == 0) a_inv[r][g] = pow2(-k);
  }
  if (tid < 4 * kRows) {
    const int r = tid / 4, c = tid % 4;
    float v = c < 2 ? 0.f : 1.f;  // rows past N: finite, never stored
    if (n0 + r < N) {
      const float* q = q_rois + 4 * (size_t)(n0 + r);
      v = c < 2 ? 0.5f * (q[c] + q[c + 2]) : q[c] - q[c - 2] + 1.f;
    }
    box_s[r][c] = v;
  }

  // wt's fragments, rows gid (words 0, 2) and gid + 8 (1, 3), columns 2 tq,
  // 2 tq + 1 (words 0, 1) and 8 more (2, 3) of a k-step, each row scaled
  // like A's
  float2 wv[kKSteps][4];
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int s = 0; s < kKSteps; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int g = g0 + gid + 8 * (e & 1);
      wv[s][e] = g < G ? *reinterpret_cast<const float2*>(
                             wt + g * kPairFeat + 16 * s + 2 * tq + 8 * (e >> 1))
                       : make_float2(0.f, 0.f);
      mx[e & 1] = fmaxf(mx[e & 1], fmaxf(fabsf(wv[s][e].x), fabsf(wv[s][e].y)));
    }
  int kw[2];
  float inv_w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
    kw[h] = row_scale(mx[h]);
    inv_w[h] = pow2(-kw[h]);
  }
  uint32_t wh[kKSteps][4], wl[kKSteps][4];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float sc = pow2(kw[e & 1]);
      const Split v = split_f16(wv[s][e].x * sc, wv[s][e].y * sc);
      wh[s][e] = v.hi;
      wl[s][e] = v.lo;
    }
  const float bias[2] = {g0 + gid < G ? b[g0 + gid] : 0.f,
                         g0 + gid + 8 < G ? b[g0 + gid + 8] : 0.f};

  // the warp's keys: Bt's fragments (rows 2 tq, 2 tq + 1 and 8 more of a
  // k-step, key gid of a tile), and the key centre of this lane's offset
  const int mw = blockIdx.x * kBlockKeys + warp * kKeyTiles * 8;
  uint32_t bh[kKeyTiles][kKSteps][2], bl[kKeyTiles][kKSteps][2];
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t)
#pragma unroll
    for (int s = 0; s < kKSteps; ++s)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = mw + 8 * t + gid;
        const float* col = Bt + (size_t)(16 * s + 2 * tq + 8 * e) * M + m;
        const Split v = split_f16(m < M ? col[0] : 0.f, m < M ? col[M] : 0.f);
        bh[t][s][e] = v.hi;
        bl[t][s][e] = v.lo;
      }
  const int axis = tq & 1, mc = mw + 8 * (tq >> 1) + gid;
  const float kc =
      mc < M ? 0.5f * (k_rois[4 * (size_t)mc + axis] +
                       k_rois[4 * (size_t)mc + axis + 2])
             : 0.f;
  const float c0 = mega_bias::rate(fr, 2 * tq),
              c1 = mega_bias::rate(fr, 2 * tq + 1);
  __syncthreads();
  if (mw >= M) return;  // no barrier follows

  // the next row's offset is computed while this row's bias is
  float d_next = mega_bias::log_offset(box_s[0][axis], box_s[0][2 + axis], kc);
  for (int r = 0; r < kRows; ++r) {
    const int n = n0 + r;
    if (n >= N) break;
    const float d = d_next;
    if (r + 1 < kRows)
      d_next = mega_bias::log_offset(box_s[r + 1][axis],
                                     box_s[r + 1][2 + axis], kc);
    // k-step 0 holds sin(dx c) at rows 2 tq, 2 tq + 1 (c = c0, c1) and
    // cos(dx c) 8 rows on, k-step 1 the same of dy: f[16 j + i] =
    // sin(pos_j c_i), f[16 j + 8 + i] = cos(pos_j c_i). All 8 sincosf of
    // the row first, so that their polynomials interleave.
    float sn[kKeyTiles][kKSteps][2], cs[kKeyTiles][kKSteps][2];
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t)
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        const float pos = __shfl_sync(kFull, d, 4 * gid + 2 * t + s);
        sincosf(pos * c0, &sn[t][s][0], &cs[t][s][0]);
        sincosf(pos * c1, &sn[t][s][1], &cs[t][s][1]);
      }
    // acc = wt . f (the feature k-steps), sep = A_n . B, both scaled
    float acc[kKeyTiles][4], sep[kKeyTiles][4];
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = sep[t][e] = 0.f;
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        const Split vs = split_f16(sn[t][s][0], sn[t][s][1]);
        const Split vc = split_f16(cs[t][s][0], cs[t][s][1]);
        const uint32_t fh[2] = {vs.hi, vc.hi}, fl[2] = {vs.lo, vc.lo};
        mma_split(acc[t], wh[s], wl[s], fh, fl);
      }
    }
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      const uint4 h = a_hi[(r * kKSteps + s) * 32 + lane];
      const uint4 l = a_lo[(r * kKSteps + s) * 32 + lane];
      const uint32_t ah[4] = {h.x, h.y, h.z, h.w}, al[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int t = 0; t < kKeyTiles; ++t)
        mma_split(sep[t], ah, al, bh[t][s], bl[t][s]);
    }
    // C fragment: groups gid (e = 0, 1) and gid + 8 (e = 2, 3), keys 2 tq
    // and 2 tq + 1 of a tile; unscaled exactly, b added as in b + wt . f.
    // Every value first, then the stores, so that the logs interleave.
    const float inv_a[2] = {a_inv[r][gid], a_inv[r][gid + 8]};
    float v[kKeyTiles][4];
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[t][e] = finish_fast(fmaf(acc[t][e], inv_w[e / 2], bias[e / 2]),
                              sep[t][e] * inv_a[e / 2]);
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t) {
      const int m = mw + 8 * t + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = g0 + gid + 8 * h;
        float* o = out + ((size_t)g * N + n) * M + m;
        if (g >= G || m >= M) continue;
        if (m + 1 < M && M % 2 == 0) {
          __stcs(reinterpret_cast<float2*>(o), make_float2(v[t][2 * h],
                                                           v[t][2 * h + 1]));
        } else {
          __stcs(o, v[t][2 * h]);
          if (m + 1 < M) __stcs(o + 1, v[t][2 * h + 1]);
        }
      }
    }
  }
}

// pe_setup's operands, one thread an item: (query n, factor j) writes
// A[:, n, j] for every group; (key m, axis, rate) writes that rate's cos
// and sin into Bt ([cos w | sin w | cos h | sin h], 8 rows each); (g, j)
// copies wt[g, j] = Wg[j, g].
__global__ void __launch_bounds__(256)
bias_factors_kernel(const float* __restrict__ q_rois,
                    const float* __restrict__ k_rois,
                    const float* __restrict__ W, int w_row, int w_col,
                    float* __restrict__ A, float* __restrict__ Bt,
                    float* __restrict__ wt, int N, int M, int G, Freqs fr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nq = N * kSepDim, nk = M * 2 * kFreqs;
  if (i < nq) {
    // A's 32: [w first 8 | w second 8 | h first 8 | h second 8], with the
    // weights of the sin feature at 32 + 16 axis + f, the cos at 40 + ...
    const int n = i / kSepDim, j = i % kSepDim;
    const int axis = j / 16, f = j % kFreqs;
    float s, c;
    mega_bias::size_sincos(q_rois + 4 * (size_t)n, axis,
                           mega_bias::rate(fr, f), &s, &c);
    const float* ws = W + (size_t)(32 + 16 * axis + f) * w_row;
    const float* wc = ws + (size_t)kFreqs * w_row;
    for (int g = 0; g < G; ++g)
      A[((size_t)g * N + n) * kSepDim + j] = mega_bias::fold(
          s, c, ws[(size_t)g * w_col], wc[(size_t)g * w_col], j / 8 % 2);
  } else if (i < nq + nk) {
    const int k = i - nq, m = k % M, axis = k / M / kFreqs, f = k / M % kFreqs;
    float s, c;
    mega_bias::size_sincos(k_rois + 4 * (size_t)m, axis,
                           mega_bias::rate(fr, f), &s, &c);
    Bt[(size_t)(16 * axis + f) * M + m] = c;
    Bt[(size_t)(16 * axis + kFreqs + f) * M + m] = s;
  } else if (i < nq + nk + G * kPairFeat) {
    const int k = i - nq - nk, g = k / kPairFeat, j = k % kPairFeat;
    wt[k] = W[(size_t)j * w_row + (size_t)g * w_col];
  }
}

bool load_freqs(const float* freqs, Freqs* fr) {
  if (freqs == nullptr) return false;
  for (int i = 0; i < kFreqs; ++i) fr->c[i] = freqs[i];
  return true;
}

}  // namespace

// `freqs` points to the 8 fp32 rates on the host. Returns the CUDA error
// code of the launch (0 on success). Does not synchronise; runs on `stream`.
extern "C" int position_bias_forward(const float* q_rois, const float* k_rois,
                                     const float* A, const float* Bt,
                                     const float* wt, const float* b,
                                     float* out, int N, int M, int G,
                                     const float* freqs, void* stream) {
  Freqs fr;
  if (N < 1 || M < 1 || G < 1 || G > kMaxGroups || !load_freqs(freqs, &fr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kBlockKeys - 1) / kBlockKeys, (N + kRows - 1) / kRows,
                  (G + kGroupTile - 1) / kGroupTile);
  position_bias_kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      q_rois, k_rois, A, Bt, wt, b, out, N, M, G, fr);
  return (int)cudaGetLastError();
}

// A (G, N, 32), Bt (32, M) and wt (G, 32) from the rois and Wg (64, G),
// whose element [j, g] is W[j * w_row + g * w_col]. Same conventions as
// above.
extern "C" int bias_factors_forward(const float* q_rois, const float* k_rois,
                                    const float* W, int w_row, int w_col,
                                    float* A, float* Bt, float* wt, int N,
                                    int M, int G, const float* freqs,
                                    void* stream) {
  Freqs fr;
  if (N < 0 || M < 0 || G < 1 || G > kMaxGroups || !load_freqs(freqs, &fr))
    return (int)cudaErrorInvalidValue;
  const int items = N * kSepDim + M * 2 * kFreqs + G * kPairFeat;
  bias_factors_kernel<<<(items + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      q_rois, k_rois, W, w_row, w_col, A, Bt, wt, N, M, G, fr);
  return (int)cudaGetLastError();
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* position_bias_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
