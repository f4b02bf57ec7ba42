// MEGA's fused grouped set-attention forward for Hopper (sm_90a), fp32 and
// bf16.
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
// are 2 * 16 * 675 * 3750 * 64 fmaf (10.4 GFLOP) on the fp32 pipes (TF32 is
// off: the parity setting), with the bias adding 1024 fmaf and 18
// transcendentals per pair; its bytes in and out (q, k, vproj, rois, the
// output) are about 35 MB. It is bound by operations.
//
// The design:
// - A block owns kRows(DGO) query rows and ALL G groups, one warp per
//   group, and walks one split of the keys in tiles of 32 (the sequential
//   key grid axis of the Pallas kernel becomes this loop).
// - Key splits fill the card: the keys are cut into S runs of whole tiles,
//   S chosen at the launch so that the row tiles x S blocks fill the
//   card's block slots once (pick_splits; at stage 0, 85 row tiles and 2
//   blocks an SM give S = 3). Each (block, split) leaves its rows' partial
//   softmax state (m, l, unnormalised acc) in scratch that the wrapper
//   allocates, and mega_attention_merge combines the S states in split
//   order, one thread an output float: no atomics, the same bits every
//   run. A split with no valid key has l = 0 and weighs nothing.
// - Registers: the launch bounds hold a thread to 64 so that 2 blocks (32
//   warps) share an SM. A row's softmax state lives in one lane (lane r
//   holds row r's max and sum) rather than in all 32, and P goes through
//   shared memory rather than registers; ptxas still spills a few dozen
//   bytes at the main instance.
// - The geometric bias is shared across the groups and spread over every
//   thread: for each key tile the block first writes the pairs' 32
//   sinusoid features to shared memory, feature-major, one (pair, axis) a
//   thread (a log and 8 sincosf; a pair's transcendentals run once for all
//   G groups), then builds the (G, rows, 32) bias tile, each thread 2
//   groups x 4 keys of one row, so a shared load of wt, A, f or B serves 4
//   or 8 FMAs and all 512 threads have work. The rows' separable factors
//   and the weights are staged once per block. A tile without a valid key
//   is skipped before its bias.
// - Scores: lane j of warp g takes key j of the tile and the block's rows,
//   reading its key row from L2 16 channels at a time (one wait a chunk)
//   and the rows' queries from shared memory as broadcasts; ub is loaded
//   beside them. Online softmax per (g, row), exp as the hardware's ex2.
//   P goes to the warp's slice of shared memory, key-major, over the
//   features (dead once the bias is built). P.V: each lane owns DGO / 32
//   output channels of every row, reads a key's P of all rows as float4
//   broadcasts, and has the vproj rows of kAhead keys in flight before it
//   uses the first (coalesced, one row a warp a key).
// - The all-invalid sentinel: invalid keys (and keys past M, which the
//   kernel masks itself; the inputs are not padded) score -inf and load no
//   vproj, a tile with no valid key is skipped before any exp, and the
//   running max is only ever taken over finite scores, so no
//   exp(-inf - -inf) arises. A row whose keys are all invalid keeps l = 0
//   and is written as exactly 0.
//
// What still holds it back (PERF.md): at stage 0 a warp spends about as
// long in the bias phase (its three barriers and the shared-memory loads
// of the bias tile) as in the score product (the query broadcasts, one
// float a lane a cycle of the SM's load bandwidth), and about half that in
// P.V; each 8-row block re-reads K and vproj from L2. Register micro-tiles
// of 4 rows x 4 keys in 16-row blocks (one block an SM), of 4 rows x 2 keys
// in 8-row blocks, and one block an SM with more loads in flight were
// tried and were slower.
//
// The bf16 instances (mega_attention_forward_bf16, the bf16 detector's
// path) are the same body with __nv_bfloat16 q, k, vproj and output (E in
// the templates), as the Pallas kernel runs on bf16 operands: the key rows
// come as 16-byte loads of 8 bf16 (2 a chunk, the 16 channels of fp32's 4),
// every stream is widened to fp32 in registers (exact), and the scores, the
// online softmax, l and the P.V sums stay fp32. ub stays fp32 (JAX divides
// the bf16 u.k by a numpy float, which promotes), and so does everything
// of the bias (rois, A, Bt, wt, b: JAX computes it in fp32). As the Pallas
// kernel does, P = exp(s - m) is rounded to bf16 before P.V while l sums
// the unrounded values, and the output is rounded to bf16 once: by the
// merge when the keys are split (the splits' partial states stay fp32),
// else by the single pass. Against the Pallas kernel's 128-key tiles, P is
// rounded relative to the running max of 32-key tiles (and of each split),
// so the two agree within bf16's rounding, not bit for bit.
//
// Layout: q (G, N, DG), k (G, M, DG), vproj (G, M, DGO), ub (G, M), valid
// (M,) bool (one byte each), out (N, G * DGO); with the bias, q_rois (N, 4),
// k_rois (M, 4), A (G, N, 32), Bt (32, M), wt (G, 32), b (G,). q, k, vproj
// and out are all fp32 or all bf16, the rest fp32; all contiguous. G <= 16,
// DG and DGO <= 256; the Python wrapper checks them before the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <algorithm>

#include "element.cuh"
#include "mega_bias.cuh"

namespace {

using element::bf16;
using mega_bias::Freqs;
using mega_bias::kPairFeat;
using mega_bias::kSepDim;

constexpr int kTile = 32;       // keys per tile, one lane each
constexpr int kMaxGroups = 16;  // one warp each
constexpr int kMaxDim = 256;

template <typename E>
struct Params {
  const E* q;
  const E* k;
  const E* vproj;
  const float* ub;
  const unsigned char* valid;
  const float* q_rois;  // null: no bias (the global flavour)
  const float* k_rois;
  const float* A;
  const float* Bt;
  const float* wt;
  const float* b;
  E* out;
  float* part;  // null: one split, the kernel writes `out` itself
  int N, M, G, DG, DGO;
  int tiles_per_split;
  float scale;
  Freqs fr;
};

constexpr int kAS = kSepDim + 1;  // A's row stride: rows in distinct banks
static_assert(kSepDim == kPairFeat, "the bias loop walks both at once");

// How the bias tile is spread: a thread computes kGS groups x 4 keys of
// one query row, (G / kGS) x kRows x kQuads items of a tile: 8 x 8 x 8 =
// 512 at 8 rows and 16 groups, one for each thread.
constexpr int kGS = 2;
constexpr int kQuads = kTile / 4;

// The 16 bytes of u as fp32: 4 floats, or 8 bf16 widened (exact).
template <typename E>
__device__ __forceinline__ void widen16(const uint4& u, float* x) {
  if constexpr (sizeof(E) == 4) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  } else {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = element::lo_f32(w[i]);
      x[2 * i + 1] = element::hi_f32(w[i]);
    }
  }
}

// kRows query rows per block and DPL = ceil(DGO / 32) output floats a lane
// per row: kRows * DPL <= 16 keeps the accumulators at 16 registers, and
// the launch bounds the rest, for 2 blocks an SM.
template <int kRows, int DPL, typename E>
__global__ void __launch_bounds__(kMaxGroups * 32, 2)
mega_attention_kernel(const Params<E> p) {
  // loads in flight a lane: 16-byte loads of the key row, 16 channels a
  // chunk (4 of fp32, 2 of bf16), and vproj rows of P.V
  constexpr int kVec = 16 / sizeof(E);
  constexpr int kChunk = 16 / kVec;
  constexpr int kAhead = DPL >= 16 ? 1 : 16 / DPL;
  constexpr int kPairs = kRows * kTile;
  extern __shared__ __align__(16) float smem[];
  const int G = p.G, DG = p.DG, DGO = p.DGO, N = p.N, M = p.M;
  const int Gp = (G + kGS - 1) / kGS * kGS;  // padded with 0s
  const bool with_bias = p.q_rois != nullptr;
  float* bias_s = smem;                         // G x kRows x kTile
  float* feat_s = bias_s + G * kRows * kTile;   // 32 x kRows * kTile
  // the features, and once the bias is built each warp's P (kTile x kPS)
  constexpr int kPS = kRows + 4;
  float* bt_s = feat_s + max(kPairFeat * kPairs, G * kTile * kPS);
  float* q_s = bt_s + kSepDim * kTile;          // G x kRows x DG
  float* a_s = q_s + G * kRows * DG;            // Gp x kRows x kAS
  float* wt_s = a_s + Gp * kRows * kAS;         // Gp x 32
  float* b_s = wt_s + Gp * kPairFeat;           // Gp
  float* qbox_s = b_s + Gp;                     // kRows x 4

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int g = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * kRows;
  // this block's keys: split blockIdx.y's whole tiles
  const int m_begin = blockIdx.y * p.tiles_per_split * kTile;
  const int m_end = min(M, m_begin + p.tiles_per_split * kTile);
  for (int idx = tid; idx < G * kRows * DG; idx += nthreads) {
    const int gg = idx / (kRows * DG);
    const int r = (idx / DG) % kRows;
    const int c = idx % DG;
    const int n = n0 + r;
    q_s[idx] = n < N ? element::to_f32(p.q[((size_t)gg * N + n) * DG + c])
                     : 0.f;
  }
  if (with_bias) {
    for (int idx = tid; idx < Gp * kRows * kSepDim; idx += nthreads) {
      const int gg = idx / (kRows * kSepDim);
      const int r = (idx / kSepDim) % kRows;
      const int j = idx % kSepDim;
      const int n = n0 + r;
      a_s[(gg * kRows + r) * kAS + j] =
          gg < G && n < N ? p.A[((size_t)gg * N + n) * kSepDim + j] : 0.f;
    }
    for (int idx = tid; idx < Gp * kPairFeat; idx += nthreads)
      wt_s[idx] = idx < G * kPairFeat ? p.wt[idx] : 0.f;
    for (int idx = tid; idx < Gp; idx += nthreads)
      b_s[idx] = idx < G ? p.b[idx] : 0.f;
    for (int idx = tid; idx < kRows * 4; idx += nthreads) {
      const int n = n0 + idx / 4;
      qbox_s[idx] = n < N ? p.q_rois[(size_t)n * 4 + idx % 4] : 0.f;
    }
  }
  __syncthreads();

  const float* qg = q_s + g * kRows * DG;
  const E* kg = p.k + (size_t)g * M * DG;
  const E* vg = p.vproj + (size_t)g * M * DGO;
  // 16-byte loads of the key rows where the widths and the base allow them
  const bool vec =
      DG % kVec == 0 && (reinterpret_cast<size_t>(p.k) & 15) == 0;

  // the softmax state (max, sum) of row r lives in lane r, two registers
  // where a copy in every lane would take 2 kRows
  float m_mine = -INFINITY, l_mine = 0.f, acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += kTile) {
    if (with_bias) {
      // a tile without a valid key is skipped whole (the test is the same
      // in every thread); it is also the barrier after which the previous
      // tile's bias, features and B are consumed
      if (!__syncthreads_or(m0 + lane < M && p.valid[m0 + lane])) continue;
      for (int idx = tid; idx < kSepDim * kTile; idx += nthreads) {
        const int m = m0 + idx % kTile;
        bt_s[idx] = m < M ? p.Bt[(size_t)(idx / kTile) * M + m] : 0.f;
      }
      // the pairs' 32 sinusoid features, feature-major: each (pair, axis)
      // once, one log and 8 sincosf; pairs past N or M get finite values
      // that nothing reads
      for (int it = tid; it < 2 * kPairs; it += nthreads) {
        const int axis = it / kPairs;  // 0: dx, 1: dy
        const int pr = it - axis * kPairs;
        const int m = m0 + pr % kTile;
        const float* qb = qbox_s + 4 * (pr / kTile);
        float kc = 0.f;
        if (m < M) {
          const float* kb = p.k_rois + 4 * (size_t)m;
          kc = 0.5f * (kb[axis] + kb[axis + 2]);
        }
        const float d = mega_bias::log_offset(
            0.5f * (qb[axis] + qb[axis + 2]), qb[axis + 2] - qb[axis] + 1.f,
            kc);
        float* f = feat_s + 2 * mega_bias::kFreqs * axis * kPairs + pr;
#pragma unroll
        for (int i = 0; i < mega_bias::kFreqs; ++i)
          sincosf(d * p.fr.c[i], f + i * kPairs,
                  f + (mega_bias::kFreqs + i) * kPairs);
      }
      __syncthreads();
      // the (G, kRows, kTile) bias tile over every thread: kGS groups x 4
      // keys of one row a thread, so each shared load serves several FMAs
      for (int it = tid; it < Gp / kGS * kRows * kQuads;
           it += nthreads) {
        const int kq = it % kQuads;
        const int r = it / kQuads % kRows;
        const int g0 = it / (kQuads * kRows) * kGS;
        float bacc[kGS][4], sep[kGS][4];
#pragma unroll
        for (int x = 0; x < kGS; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            bacc[x][y] = b_s[g0 + x];
            sep[x][y] = 0.f;
          }
        const float* fq = feat_s + r * kTile + 4 * kq;
        const float* bq = bt_s + 4 * kq;
        const float* aq = a_s + (g0 * kRows + r) * kAS;
#pragma unroll 4
        for (int j = 0; j < kPairFeat; ++j) {
          const float4 f4 =
              *reinterpret_cast<const float4*>(fq + j * kPairs);
          const float4 b4 = *reinterpret_cast<const float4*>(bq + j * kTile);
#pragma unroll
          for (int x = 0; x < kGS; ++x) {
            const float w = wt_s[(g0 + x) * kPairFeat + j];
            const float a = aq[x * kRows * kAS + j];
            bacc[x][0] = fmaf(w, f4.x, bacc[x][0]);
            bacc[x][1] = fmaf(w, f4.y, bacc[x][1]);
            bacc[x][2] = fmaf(w, f4.z, bacc[x][2]);
            bacc[x][3] = fmaf(w, f4.w, bacc[x][3]);
            sep[x][0] = fmaf(a, b4.x, sep[x][0]);
            sep[x][1] = fmaf(a, b4.y, sep[x][1]);
            sep[x][2] = fmaf(a, b4.z, sep[x][2]);
            sep[x][3] = fmaf(a, b4.w, sep[x][3]);
          }
        }
#pragma unroll
        for (int x = 0; x < kGS; ++x)
          if (g0 + x < G)
            *reinterpret_cast<float4*>(
                bias_s + ((g0 + x) * kRows + r) * kTile + 4 * kq) =
                make_float4(mega_bias::finish(bacc[x][0], sep[x][0]),
                            mega_bias::finish(bacc[x][1], sep[x][1]),
                            mega_bias::finish(bacc[x][2], sep[x][2]),
                            mega_bias::finish(bacc[x][3], sep[x][3]));
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
      const E* krow = kg + (size_t)m * DG;
      const float u = p.ub[(size_t)g * M + m];  // in flight with the key row
      if (vec) {
        // kChunk 16-byte loads of the key row in flight at once: the loop
        // waits on L2 once a chunk, not once a load
        for (int c0 = 0; c0 < DG; c0 += kVec * kChunk) {
          uint4 kv[kChunk];
#pragma unroll
          for (int j = 0; j < kChunk; ++j)
            kv[j] = c0 + kVec * j < DG
                        ? *reinterpret_cast<const uint4*>(krow + c0 + kVec * j)
                        : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            if (c0 + kVec * j >= DG) break;
            float kf[kVec];
            widen16<E>(kv[j], kf);
#pragma unroll
            for (int r = 0; r < kRows; ++r)
#pragma unroll
              for (int h = 0; h < kVec; h += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(
                    qg + r * DG + c0 + kVec * j + h);
                s[r] = fmaf(qv.x, kf[h], s[r]);
                s[r] = fmaf(qv.y, kf[h + 1], s[r]);
                s[r] = fmaf(qv.z, kf[h + 2], s[r]);
                s[r] = fmaf(qv.w, kf[h + 3], s[r]);
              }
          }
        }
      } else {
        for (int c = 0; c < DG; ++c) {
          const float kv = element::to_f32(krow[c]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) s[r] = fmaf(qg[r * DG + c], kv, s[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r] = s[r] * p.scale + u;
        if (with_bias) s[r] += bias_s[(g * kRows + r) * kTile + lane];
      }
    }

    // online softmax; every score below is finite or -inf (invalid), and
    // the tile holds at least one valid key, so each row's max is finite
    float* pw = feat_s + g * kTile * kPS;  // this warp's P, key-major
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float tmax = valid ? s[r] : -INFINITY;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      const float m_old = __shfl_sync(0xffffffffu, m_mine, r);
      const float m_new = fmaxf(m_old, tmax);
      const float alpha = __expf(m_old - m_new);  // 0 while m_old is -inf
      const float pv = valid ? __expf(s[r] - m_new) : 0.f;
      float psum = pv;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (lane == r) {
        l_mine = l_mine * alpha + psum;
        m_mine = m_new;
      }
      // P.V takes P in the streams' precision; l sums the unrounded P
      pw[lane * kPS + r] = element::round_to<E>(pv);
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r][d] *= alpha;
    }

    __syncwarp();  // the tile's P is written
    // P.V, kAhead keys at a time: their vproj loads are all in flight
    // before the first is used (an invalid key loads nothing and is skipped)
    const int n_keys = min(kTile, M - m0);
    for (int k0 = 0; k0 < n_keys; k0 += kAhead) {
      float vv[kAhead][DPL];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int kk = k0 + j;
        const bool live = kk < n_keys && ((vmask >> kk) & 1u);
        const E* vrow = vg + (size_t)(m0 + kk) * DGO;
#pragma unroll
        for (int d = 0; d < DPL; ++d) {
          const int c = lane + 32 * d;
          vv[j][d] = live && c < DGO ? element::to_f32(vrow[c]) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int kk = k0 + j;
        if (kk >= n_keys || !((vmask >> kk) & 1u)) continue;  // warp-uniform
        float pk[kRows];
        if constexpr (kRows % 4 == 0) {
#pragma unroll
          for (int r = 0; r < kRows; r += 4) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(pw + kk * kPS + r);
            pk[r] = p4.x;
            pk[r + 1] = p4.y;
            pk[r + 2] = p4.z;
            pk[r + 3] = p4.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < kRows; ++r) pk[r] = pw[kk * kPS + r];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int d = 0; d < DPL; ++d)
            acc[r][d] = fmaf(pk[r], vv[j][d], acc[r][d]);
      }
    }
    __syncwarp();  // P is read before the next tile writes it
  }

  if (p.part != nullptr) {
    // this split's partial softmax state, merged by mega_attention_merge
    const size_t split = (size_t)blockIdx.y * G + g;
    float* ml = p.part + (size_t)gridDim.y * G * N * DGO;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int n = n0 + r;
      if (n >= N) break;
      float* arow = p.part + (split * N + n) * DGO;
#pragma unroll
      for (int d = 0; d < DPL; ++d) {
        const int c = lane + 32 * d;
        if (c < DGO) arow[c] = acc[r][d];
      }
      if (lane == r) {
        ml[2 * (split * N + n)] = m_mine;
        ml[2 * (split * N + n) + 1] = l_mine;
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int n = n0 + r;
    if (n >= N) break;
    const float l = __shfl_sync(0xffffffffu, l_mine, r);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    E* orow = p.out + (size_t)n * G * DGO + (size_t)g * DGO;
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      const int c = lane + 32 * d;
      if (c < DGO) orow[c] = element::from_f32<E>(acc[r][d] * inv);
    }
  }
}

// Merges the S splits' partial (m, l, acc) of each (row, group) in split
// order, one thread an output float: deterministic, no atomics. A split
// with no valid key (l = 0, m = -inf) weighs nothing; a row with none in
// any split is written as 0. The output is rounded to E here, once.
template <typename E>
__global__ void __launch_bounds__(256)
mega_attention_merge(const float* part, E* out, int N, int G, int DGO,
                     int S) {
  const size_t total = (size_t)N * G * DGO;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % DGO);
  const size_t ng = idx / DGO;  // n * G + g
  const int g = (int)(ng % G);
  const size_t n = ng / G;
  const float* ml = part + (size_t)S * total;
  float m_max = -INFINITY;
  for (int s = 0; s < S; ++s) {
    const size_t j = ((size_t)s * G + g) * N + n;
    if (ml[2 * j + 1] > 0.f) m_max = fmaxf(m_max, ml[2 * j]);
  }
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t j = ((size_t)s * G + g) * N + n;
    const float ls = ml[2 * j + 1];
    if (!(ls > 0.f)) continue;
    const float w = expf(ml[2 * j] - m_max);
    l = fmaf(ls, w, l);
    acc = fmaf(part[j * DGO + c], w, acc);
  }
  out[idx] = element::from_f32<E>(l > 0.f ? acc / l : 0.f);
}

// An instance of the kernel (query rows a block, output floats a lane,
// element type) and its dynamic shared memory for G groups of width DG.
template <typename E>
struct Instance {
  void (*kernel)(Params<E>);
  int rows;
  size_t smem;
};

template <int kRows, int DPL, typename E>
Instance<E> make_instance(int G, int DG) {
  constexpr int kPairs = kRows * kTile;
  const int Gp = (G + kGS - 1) / kGS * kGS;
  constexpr int kPS = kRows + 4;
  const size_t floats = (size_t)G * kRows * kTile +
                        (size_t)std::max(kPairFeat * kPairs, G * kTile * kPS) +
                        kSepDim * kTile + (size_t)G * kRows * DG +
                        (size_t)Gp * kRows * kAS + (size_t)Gp * kPairFeat +
                        Gp + kRows * 4;
  return {mega_attention_kernel<kRows, DPL, E>, kRows,
          sizeof(float) * floats};
}

template <typename E>
Instance<E> pick_instance(int G, int DG, int DGO) {
  if (DGO <= 32) return make_instance<8, 1, E>(G, DG);
  if (DGO <= 64) return make_instance<8, 2, E>(G, DG);
  if (DGO <= 128) return make_instance<4, 4, E>(G, DG);
  return make_instance<2, 8, E>(G, DG);
}

constexpr int kMaxSplits = 16;

// The number of key splits: as many whole waves of blocks as the card holds
// at once, without more splits than key tiles (or kMaxSplits).
template <typename E>
cudaError_t pick_splits(const Instance<E>& in, int N, int M, int G, int* S) {
  cudaError_t err = cudaFuncSetAttribute(
      in.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)in.smem);
  if (err != cudaSuccess) return err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, in.kernel,
                                                      32 * G, in.smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (N + in.rows - 1) / in.rows;
  const int n_tiles = (M + kTile - 1) / kTile;
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  *S = min(max(1, slots / row_tiles), min(max(1, n_tiles), kMaxSplits));
  return cudaSuccess;
}

bool bad_shape(int N, int M, int G, int DG, int DGO) {
  return N < 1 || M < 0 || G < 1 || G > kMaxGroups || DG < 1 ||
         DG > kMaxDim || DGO < 1 || DGO > kMaxDim;
}

// The rows a block of E's instance for (G, DG, DGO) and its key splits.
template <typename E>
int plan(int N, int M, int G, int DG, int DGO, int* splits, int* rows) {
  if (bad_shape(N, M, G, DG, DGO)) return (int)cudaErrorInvalidValue;
  const Instance<E> in = pick_instance<E>(G, DG, DGO);
  *rows = in.rows;
  return (int)pick_splits(in, N, M, G, splits);
}

// Launches E's instance on `splits` runs of the keys, then (with more than
// one) the merge; the arguments are mega_attention_forward's.
template <typename E>
int forward(const E* q, const E* k, const E* vproj, const float* ub,
            const unsigned char* valid, const float* q_rois,
            const float* k_rois, const float* A, const float* Bt,
            const float* wt, const float* b, E* out, float* part, int N,
            int M, int G, int DG, int DGO, int splits, float scale,
            const float* freqs, void* stream) {
  if (bad_shape(N, M, G, DG, DGO) || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && part == nullptr) ||
      (q_rois != nullptr && freqs == nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (M + kTile - 1) / kTile;
  Params<E> p{q, k, vproj, ub, valid, q_rois, k_rois, A, Bt, wt, b, out,
              splits > 1 ? part : nullptr, N, M, G, DG, DGO,
              (n_tiles + splits - 1) / splits, scale, {}};
  if (q_rois != nullptr)
    for (int i = 0; i < mega_bias::kFreqs; ++i) p.fr.c[i] = freqs[i];
  const cudaStream_t s = (cudaStream_t)stream;
  const Instance<E> in = pick_instance<E>(G, DG, DGO);
  cudaError_t err = cudaFuncSetAttribute(
      in.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)in.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + in.rows - 1) / in.rows, splits);
  in.kernel<<<grid, 32 * G, in.smem, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1)
    return (int)err;
  const size_t total = (size_t)N * G * DGO;
  mega_attention_merge<E><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      part, out, N, G, DGO, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The instance (query rows a block) and the key splits that
// mega_attention_forward (is_bf16 = 0) or mega_attention_forward_bf16
// (is_bf16 = 1) takes for this problem on the current device; the caller
// sizes the scratch from the splits. Returns the CUDA error code (0 on
// success).
extern "C" int mega_attention_splits(int N, int M, int G, int DG, int DGO,
                                     int is_bf16, int* splits,
                                     int* rows) {
  return is_bf16 ? plan<bf16>(N, M, G, DG, DGO, splits, rows)
                 : plan<float>(N, M, G, DG, DGO, splits, rows);
}

// With q_rois null the kernel adds no bias and reads none of k_rois, A, Bt,
// wt, b or freqs; else `freqs` points to the 8 fp32 rates on the host.
// `scale` is 1/sqrt(DG). The keys are cut into `splits` runs of whole
// tiles; with more than one, `part` is scratch of splits * G * N * (DGO + 2)
// floats for their partial softmax states, merged into `out` by a second
// kernel. Returns the CUDA error code of the launches (0 on success). Does
// not synchronise; runs on `stream`.
extern "C" int mega_attention_forward(
    const float* q, const float* k, const float* vproj, const float* ub,
    const unsigned char* valid, const float* q_rois, const float* k_rois,
    const float* A, const float* Bt, const float* wt, const float* b,
    float* out, float* part, int N, int M, int G, int DG, int DGO,
    int splits, float scale, const float* freqs, void* stream) {
  return forward(q, k, vproj, ub, valid, q_rois, k_rois, A, Bt, wt, b, out,
                 part, N, M, G, DG, DGO, splits, scale, freqs, stream);
}

// The same with bf16 q, k, vproj and out; ub, the bias operands and the
// scratch stay fp32.
extern "C" int mega_attention_forward_bf16(
    const bf16* q, const bf16* k, const bf16* vproj, const float* ub,
    const unsigned char* valid, const float* q_rois, const float* k_rois,
    const float* A, const float* Bt, const float* wt, const float* b,
    bf16* out, float* part, int N, int M, int G, int DG, int DGO,
    int splits, float scale, const float* freqs, void* stream) {
  return forward(q, k, vproj, ub, valid, q_rois, k_rois, A, Bt, wt, b, out,
                 part, N, M, G, DG, DGO, splits, scale, freqs, stream);
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* mega_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
