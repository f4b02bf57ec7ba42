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
// The bf16 kernel (mega_attention_forward_bf16, the bf16 detector's path)
// is mega_attention_mma_kernel, with the products on the tensor cores; the
// fp32 kernel described above (its element type parameter now only ever
// float) keeps them on the FMA pipes, since TF32 is off. At stage 0 the bf16 products
// are 10.4 GFLOP at the dense bf16 rate (0.011 ms), so the bias's fp32
// work (64 fmaf a pair and group, 4.7 GFLOP over the valid pairs at 67
// TFLOP/s: 0.07 ms) sets its bound. Its design:
// - A block owns kMmaRows = 16 query rows (one m16 tile) and GB groups,
//   one warp each: all 16 up to 64 channels, so the pairs' features are
//   computed once for every group; 8 at 128 and 4 at 256 (grid.z walks
//   the chunks of groups, each computing the features again), where O's
//   fp32 accumulators (dgo / 2 registers a lane) and the tiles would not
//   fit 16 warps. Key splits and the merge are the fp32 kernel's, over
//   16-key tiles, from the bf16 kernel's own occupancy (one block an SM).
// - Q, K and V in shared memory as bf16 at a row stride of the channel
//   bucket (16, 32, 64, 128 or 256 of max(dg, dgo)) + 8. A warp copies its
//   group's query rows once and keeps their A fragments in registers (up
//   to the 128 bucket; read again each tile at 256), and copies its own K
//   and V tiles with 16-byte cp.async (2-byte loads where dg or dgo is not
//   a multiple of 8 or a stream is not 16-byte aligned), zero-filled past
//   M, at invalid keys and past dg/dgo, so that no invalid key's value is
//   read: P = 0 there, but 0 * NaN is NaN on the tensor cores too.
// - The key mask is read once a block into a window of bits (4096 keys,
//   moved on past its end); a tile with no valid key is skipped before its
//   copy, its bias and any exp.
// - S = Q.K^T runs on mma.sync m16n8k16 (bf16 operands, fp32 sums) with
//   K's B fragments from ldmatrix; the scores are scaled in fp32, ub and
//   the bias tile added and invalid keys set to -inf, and the online
//   softmax runs in registers (a row's 16 keys sit on the 4 lanes of a
//   quad: its max and sum are 2 shuffles). As the Pallas kernel does, P =
//   exp(s - m) is rounded to bf16 (cvt.rn.bf16x2) before P.V while l sums
//   the unrounded values; the two n8 accumulator tiles of S are P's k16 A
//   fragment, V's B fragments come from ldmatrix.trans, and O stays fp32
//   in registers. m stays in natural-log units, which the merge takes. The
//   output is rounded to bf16 once: by the merge when the keys are split
//   (the splits' partial states stay fp32), else by the single pass.
//   Against the Pallas kernel's 128-key tiles, P is rounded relative to the
//   running max of 16-key tiles (and of each split), so the two agree
//   within bf16's rounding, not bit for bit.
// - The bias tile is the fp32 kernel's code at 16 rows x 16 keys, the same
//   256 pairs a tile (one feature item and one bias item a thread of a
//   512-thread block), with the same sincosf full range reduction and
//   mega_bias::finish. With the bias, a warp's K/V copy of the tile is
//   issued before the block builds the tile's bias and lands behind it
//   (one stage: the bias buffers fill the rest of shared memory); without
//   it, the warps walk on with no block barrier, the next tile's copy in
//   flight in a second stage that takes the bias buffers' memory.
// - ub stays fp32 (JAX divides the bf16 u.k by a numpy float, which
//   promotes), and so does everything of the bias (rois, A, Bt, wt, b: JAX
//   computes it in fp32).
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
#include <type_traits>

#include "element.cuh"
#include "mega_bias.cuh"
#include "warp_mma.cuh"

namespace {

using element::bf16;
using warp_mma::cp_async16;
using warp_mma::cp_async_commit;
using warp_mma::cp_async_wait;
using warp_mma::ldmatrix_x4;
using warp_mma::ldmatrix_x4_trans;
using warp_mma::mma_bf16;
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

// ---------------------------------------------------------------------------
// The bf16 kernel, on the tensor cores.

constexpr int kMmaRows = 16;  // query rows a block: one m16 tile
constexpr int kMmaTile = 16;  // keys a tile: one k16 step of P.V
constexpr int kMmaPairs = kMmaRows * kMmaTile;
constexpr int kMmaQuads = kMmaTile / 4;
// the bias tile's row stride (floats): a quad's float2 reads of 4 rows
// fall in distinct banks
constexpr int kBS = kMmaTile + 8;
constexpr int kWindow = 4096;  // keys whose valid bits a block holds at once

// The shared memory of the instance for groups up to DB channels wide (the
// bucket of max(dg, dgo)) and GB groups a block, one warp each: the warps'
// query rows, a stage of their K and V tiles, and one region that holds a
// second K/V stage without the bias or the bias buffers with it.
template <int DB, int GB>
struct MmaTiles {
  static_assert(GB % kGS == 0, "the bias items take kGS groups at once");
  // row stride (bf16) of the Q, K and V tiles: 16 bytes past the row, so
  // rows stay 16-byte aligned and an ldmatrix's 8 rows hit distinct banks
  static constexpr int kS = DB + 8;
  static constexpr int kTileElems = kMmaTile * kS;  // one K or V tile
  static constexpr size_t kQBytes = sizeof(bf16) * GB * kMmaRows * kS;
  static constexpr size_t kStageBytes = sizeof(bf16) * GB * 2 * kTileElems;
  static constexpr size_t kBiasBytes =
      sizeof(float) *
      (GB * kMmaRows * kBS + kPairFeat * kMmaPairs + kSepDim * kMmaTile +
       GB * kMmaRows * kAS + GB * kPairFeat + GB + kMmaRows * 4);
  static constexpr size_t kBytes =
      kQBytes + kStageBytes +
      (kStageBytes > kBiasBytes ? kStageBytes : kBiasBytes);
};

// 16 rows of a tile (DB channels at stride kS) from rows first ..
// first + 15 of a group's stream of `width` channels a row, by one warp: a
// row at or past `end`, a row whose bit in `keep` is clear and channels
// past `width` are zeros, and nothing of them is read. 16-byte cp.async
// copies (vec: width % 8 == 0 and a 16-byte aligned stream) or 2-byte loads.
template <int DB, int kS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int first, int end, uint32_t keep,
                                           int width, bool vec, int lane) {
  if (vec) {
    constexpr int kChunks = DB / 8;  // 8 bf16 a copy
#pragma unroll
    for (int it = 0; it < kMmaRows * kChunks / 32; ++it) {
      const int idx = lane + 32 * it;
      const int r = idx / kChunks;
      const int c = 8 * (idx - r * kChunks);
      const bool live = first + r < end && (keep >> r) & 1u && c < width;
      cp_async16(dst + r * kS + c,
                 src + (live ? (size_t)(first + r) * width + c : 0), live);
    }
  } else {
    for (int idx = lane; idx < kMmaRows * DB; idx += 32) {
      const int r = idx / DB;
      const int c = idx - r * DB;
      const bool live = first + r < end && (keep >> r) & 1u && c < width;
      dst[r * kS + c] = live ? src[(size_t)(first + r) * width + c]
                             : element::from_f32<bf16>(0.f);
    }
  }
}

// The valid-key bits of keys key0 .. key0 + kWindow - 1 into win (a bit a
// key, 0 at and past M), as far as the block's keys (up to `stop`) reach,
// by every thread of the block between two barriers: the first lets every
// warp finish reading the bits it replaces. Block-uniform.
__device__ __forceinline__ void load_window(uint32_t* win,
                                            const unsigned char* valid,
                                            int key0, int M, int stop) {
  __syncthreads();
  const int n = min(kWindow, min(M, stop) - key0);
  for (int k0 = 0; k0 < n; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    const uint32_t word =
        __ballot_sync(0xffffffffu, k < n && valid[key0 + k]);
    if ((threadIdx.x & 31) == 0 && k < kWindow) win[k >> 5] = word;
  }
  __syncthreads();
}

// The 16 valid-key bits of tile t (in the window, which starts at key0).
__device__ __forceinline__ uint32_t tile_bits(const uint32_t* win, int key0,
                                              int t) {
  const int off = t * kMmaTile - key0;
  return (win[off >> 5] >> (off & 31)) & 0xffffu;
}

// The first tile at or after t and before t_end that holds a valid key
// (t_end if none), moving the window on where the tile lies past it.
// Block-uniform.
__device__ __forceinline__ int next_tile(uint32_t* win, int& key0,
                                         const unsigned char* valid, int t,
                                         int t_end, int M) {
  for (; t < t_end; ++t) {
    if ((t + 1) * kMmaTile > key0 + kWindow) {
      key0 = t * kMmaTile;
      load_window(win, valid, key0, M, t_end * kMmaTile);
    }
    if (tile_bits(win, key0, t)) return t;
  }
  return t_end;
}

// The bf16 kernel: the block owns kMmaRows query rows and groups
// blockIdx.z * GB onwards, one warp a group, and walks split blockIdx.y of
// the keys in tiles of kMmaTile. See the top of the file.
template <int DB, int GB>
__global__ void __launch_bounds__(32 * GB, 1)
mega_attention_mma_kernel(const Params<bf16> p, bool vec) {
  using T = MmaTiles<DB, GB>;
  constexpr int kS = T::kS;
  constexpr int kSteps = DB / 16;    // k16 steps of Q.K^T
  constexpr int kOT = DB / 8;        // n8 channel tiles of O
  constexpr int kNT = kMmaTile / 8;  // n8 key tiles of S
  // the query's A fragments stay in registers up to the 128 bucket
  constexpr bool kQRegs = DB <= 128;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mma);  // GB x kMmaRows x kS
  // a warp's K tile, then its V tile, in each stage
  bf16* kv0 = reinterpret_cast<bf16*>(smem_mma + T::kQBytes);
  unsigned char* region = smem_mma + T::kQBytes + T::kStageBytes;
  bf16* kv1 = reinterpret_cast<bf16*>(region);
  float* bias_s = reinterpret_cast<float*>(region);  // GB x kMmaRows x kBS
  float* feat_s = bias_s + GB * kMmaRows * kBS;      // 32 x kMmaPairs
  float* bt_s = feat_s + kPairFeat * kMmaPairs;      // 32 x kMmaTile
  float* a_s = bt_s + kSepDim * kMmaTile;            // GB x kMmaRows x kAS
  float* wt_s = a_s + GB * kMmaRows * kAS;           // GB x 32
  float* b_s = wt_s + GB * kPairFeat;                // GB
  float* qbox_s = b_s + GB;                          // kMmaRows x 4
  __shared__ uint32_t win[kWindow / 32];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int N = p.N, M = p.M, G = p.G, DG = p.DG, DGO = p.DGO;
  const int g0 = blockIdx.z * GB;  // the block's groups: g0 .. g0 + gb - 1
  const int gb = min(GB, G - g0);
  const int gbp = (gb + kGS - 1) / kGS * kGS;  // padded with 0s
  const int g = g0 + w;
  // warp-uniform: a warp past the block's last group only helps with the
  // bias
  const bool live = w < gb;
  const int n0 = blockIdx.x * kMmaRows;
  const int n_tiles = (M + kMmaTile - 1) / kMmaTile;
  const int t_begin = blockIdx.y * p.tiles_per_split;
  const int t_end = min(n_tiles, t_begin + p.tiles_per_split);
  const bool with_bias = p.q_rois != nullptr;

  bf16* qw = q_s + w * kMmaRows * kS;
  const bf16* kg = p.k + (size_t)g * M * DG;
  const bf16* vg = p.vproj + (size_t)g * M * DGO;
  if (live)
    stage_rows<DB, kS>(qw, p.q + (size_t)g * N * DG, n0, N, 0xffffu, DG,
                       vec, lane);
  cp_async_commit();
  if (with_bias) {
    // the rows' separable factors, the groups' weights and the query boxes
    for (int idx = tid; idx < gbp * kMmaRows * kSepDim; idx += nthreads) {
      const int gg = idx / (kMmaRows * kSepDim);
      const int r = (idx / kSepDim) % kMmaRows;
      const int j = idx % kSepDim;
      const int n = n0 + r;
      a_s[(gg * kMmaRows + r) * kAS + j] =
          gg < gb && n < N ? p.A[((size_t)(g0 + gg) * N + n) * kSepDim + j]
                           : 0.f;
    }
    for (int idx = tid; idx < gbp * kPairFeat; idx += nthreads)
      wt_s[idx] = idx < gb * kPairFeat
                      ? p.wt[(size_t)g0 * kPairFeat + idx] : 0.f;
    for (int idx = tid; idx < gbp; idx += nthreads)
      b_s[idx] = idx < gb ? p.b[g0 + idx] : 0.f;
    for (int idx = tid; idx < kMmaRows * 4; idx += nthreads) {
      const int n = n0 + idx / 4;
      qbox_s[idx] = n < N ? p.q_rois[(size_t)n * 4 + idx % 4] : 0.f;
    }
  }
  // the first window's barriers also publish the staged factors
  int key0 = t_begin * kMmaTile;
  load_window(win, p.valid, key0, M, t_end * kMmaTile);
  int t = next_tile(win, key0, p.valid, t_begin, t_end, M);

  // the query's fragments: row lane % 16, channels from (lane / 16) * 8 of
  // each k16 step (an ldmatrix.x4 of Q's A fragment)
  const bf16* qa = qw + (lane & 15) * kS + (lane >> 4) * 8;
  uint32_t qf[kQRegs ? kSteps : 1][4];
  cp_async_wait<0>();
  __syncwarp();
  if constexpr (kQRegs) {
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) ldmatrix_x4(qf[kk], qa + 16 * kk);
    }
  }
  // the rows lanes point at in an ldmatrix.x4: K's B fragments of two k16
  // steps of one n8 key tile (key lane % 8, channels from (lane / 8) * 8);
  // V's, transposed, of the k16 key step for two n8 channel tiles (key
  // lane % 16, channels from (lane / 16) * 8)
  const int koff = (lane & 7) * kS + (lane >> 3) * 8;
  const int voff = (lane & 15) * kS + (lane >> 4) * 8;
  bf16* kv_w[2] = {kv0 + w * 2 * T::kTileElems, kv1 + w * 2 * T::kTileElems};
  const float* bias_w = bias_s + w * kMmaRows * kBS;

  // O, and rows lane / 4 and lane / 4 + 8: the running max (natural log
  // units, as the merge takes it) and this lane's part of the sum
  float o[kOT][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int ot = 0; ot < kOT; ++ot)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ot][e] = 0.f;

  int stage = 0;
  if (!with_bias) {
    if (live && t < t_end)
      for (int x = 0; x < 2; ++x)
        stage_rows<DB, kS>(kv_w[0] + x * T::kTileElems, x ? vg : kg,
                           t * kMmaTile, M, tile_bits(win, key0, t),
                           x ? DGO : DG, vec, lane);
    cp_async_commit();
  }
  while (t < t_end) {
    const int m0 = t * kMmaTile;
    const uint32_t bits = tile_bits(win, key0, t);
    int t_next;
    if (with_bias) {
      // this warp's K and V tile, in flight while the block builds the
      // tile's bias (one stage: the bias buffers hold the other)
      if (live)
        for (int x = 0; x < 2; ++x)
          stage_rows<DB, kS>(kv_w[0] + x * T::kTileElems, x ? vg : kg, m0, M,
                             bits, x ? DGO : DG, vec, lane);
      cp_async_commit();
      // B's columns and the pairs' 32 sinusoid features, feature-major:
      // each (pair, axis) once, one log and 8 sincosf; pairs past N or M
      // get finite values that no output takes
      for (int idx = tid; idx < kSepDim * kMmaTile; idx += nthreads) {
        const int m = m0 + idx % kMmaTile;
        bt_s[idx] = m < M ? p.Bt[(size_t)(idx / kMmaTile) * M + m] : 0.f;
      }
      for (int it = tid; it < 2 * kMmaPairs; it += nthreads) {
        const int axis = it / kMmaPairs;  // 0: dx, 1: dy
        const int pr = it - axis * kMmaPairs;
        const int m = m0 + pr % kMmaTile;
        const float* qb = qbox_s + 4 * (pr / kMmaTile);
        float kc = 0.f;
        if (m < M) {
          const float* kb = p.k_rois + 4 * (size_t)m;
          kc = 0.5f * (kb[axis] + kb[axis + 2]);
        }
        const float d = mega_bias::log_offset(
            0.5f * (qb[axis] + qb[axis + 2]), qb[axis + 2] - qb[axis] + 1.f,
            kc);
        float* f = feat_s + 2 * mega_bias::kFreqs * axis * kMmaPairs + pr;
#pragma unroll
        for (int i = 0; i < mega_bias::kFreqs; ++i)
          sincosf(d * p.fr.c[i], f + i * kMmaPairs,
                  f + (mega_bias::kFreqs + i) * kMmaPairs);
      }
      // the features are written, and every warp is done with the previous
      // tile's bias
      __syncthreads();
      // the (gb, kMmaRows, kMmaTile) bias tile over every thread: kGS
      // groups x 4 keys of one row a thread, one item each at 16 groups
      for (int it = tid; it < gbp / kGS * kMmaRows * kMmaQuads;
           it += nthreads) {
        const int kq = it % kMmaQuads;
        const int r = it / kMmaQuads % kMmaRows;
        const int gl = it / (kMmaQuads * kMmaRows) * kGS;
        float bacc[kGS][4], sep[kGS][4];
#pragma unroll
        for (int x = 0; x < kGS; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            bacc[x][y] = b_s[gl + x];
            sep[x][y] = 0.f;
          }
        const float* fq = feat_s + r * kMmaTile + 4 * kq;
        const float* bq = bt_s + 4 * kq;
        const float* aq = a_s + (gl * kMmaRows + r) * kAS;
#pragma unroll 4
        for (int j = 0; j < kPairFeat; ++j) {
          const float4 f4 =
              *reinterpret_cast<const float4*>(fq + j * kMmaPairs);
          const float4 b4 =
              *reinterpret_cast<const float4*>(bq + j * kMmaTile);
#pragma unroll
          for (int x = 0; x < kGS; ++x) {
            const float wj = wt_s[(gl + x) * kPairFeat + j];
            const float a = aq[x * kMmaRows * kAS + j];
            bacc[x][0] = fmaf(wj, f4.x, bacc[x][0]);
            bacc[x][1] = fmaf(wj, f4.y, bacc[x][1]);
            bacc[x][2] = fmaf(wj, f4.z, bacc[x][2]);
            bacc[x][3] = fmaf(wj, f4.w, bacc[x][3]);
            sep[x][0] = fmaf(a, b4.x, sep[x][0]);
            sep[x][1] = fmaf(a, b4.y, sep[x][1]);
            sep[x][2] = fmaf(a, b4.z, sep[x][2]);
            sep[x][3] = fmaf(a, b4.w, sep[x][3]);
          }
        }
#pragma unroll
        for (int x = 0; x < kGS; ++x)
          if (gl + x < gb)
            *reinterpret_cast<float4*>(
                bias_s + ((gl + x) * kMmaRows + r) * kBS + 4 * kq) =
                make_float4(mega_bias::finish(bacc[x][0], sep[x][0]),
                            mega_bias::finish(bacc[x][1], sep[x][1]),
                            mega_bias::finish(bacc[x][2], sep[x][2]),
                            mega_bias::finish(bacc[x][3], sep[x][3]));
      }
      __syncthreads();  // the bias tile is built
      t_next = next_tile(win, key0, p.valid, t + 1, t_end, M);
    } else {
      // the next tile's K and V into the other stage, in flight while this
      // one is used; the warps walk on without a block barrier
      t_next = next_tile(win, key0, p.valid, t + 1, t_end, M);
      if (live && t_next < t_end)
        for (int x = 0; x < 2; ++x)
          stage_rows<DB, kS>(kv_w[stage ^ 1] + x * T::kTileElems,
                             x ? vg : kg, t_next * kMmaTile, M,
                             tile_bits(win, key0, t_next), x ? DGO : DG, vec,
                             lane);
      cp_async_commit();
    }

    if (live) {
      // ub of this lane's 4 keys: key 8 jn + 2 (lane % 4) + x of the tile
      float ubv[kNT][2];
#pragma unroll
      for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int m = m0 + 8 * jn + 2 * (lane & 3) + x;
          ubv[jn][x] = m < M ? p.ub[(size_t)g * M + m] : 0.f;
        }
      if (with_bias)
        cp_async_wait<0>();
      else
        cp_async_wait<1>();
      __syncwarp();  // every lane's part of this tile has landed
      const bf16* kt = kv_w[with_bias ? 0 : stage];
      const bf16* vt = kt + T::kTileElems;

      // S = Q.K^T on the tensor cores, fp32 sums of the bf16 products
      float s[kNT][4];
#pragma unroll
      for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; kk += 2) {
        uint32_t a[2][4];
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          if (kk + k2 >= kSteps) break;
          if constexpr (kQRegs) {
#pragma unroll
            for (int x = 0; x < 4; ++x) a[k2][x] = qf[kk + k2][x];
          } else {
            ldmatrix_x4(a[k2], qa + 16 * (kk + k2));
          }
        }
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kt + 8 * jn * kS + koff + 16 * kk);
          mma_bf16(s[jn], a[0], kf[0], kf[1]);
          if (kk + 1 < kSteps) mma_bf16(s[jn], a[1], kf[2], kf[3]);
        }
      }

      // the scores in fp32: s[jn][e] is row lane / 4 + 8 (e / 2), key
      // 8 jn + 2 (lane % 4) + e % 2 of the tile, so a row's keys sit on the
      // 4 lanes of a quad. Invalid keys score -inf; the tile holds a valid
      // key, so every row's max is finite
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * jn + 2 * (lane & 3) + (e & 1);
          float x = s[jn][e] * p.scale + ubv[jn][e & 1];
          if (with_bias)
            x += bias_w[((lane >> 2) + 8 * (e >> 1)) * kBS + key];
          s[jn][e] = (bits >> key) & 1u ? x : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[jn][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = __expf(m_run[r] - mx[r]);  // 0 while m is -inf
        m_run[r] = mx[r];
        l_run[r] *= alpha;
#pragma unroll
        for (int ot = 0; ot < kOT; ++ot) {
          o[ot][2 * r] *= alpha;
          o[ot][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[jn][e] = __expf(s[jn][e] - m_run[e >> 1]);
          l_run[e >> 1] += s[jn][e];
        }

      // O += P.V with P rounded to bf16 in registers (l summed it
      // unrounded): the accumulators of the two n8 key tiles are the A
      // fragment of the k16 key step
      const uint32_t pa[4] = {element::pack2(s[0][0], s[0][1]),
                              element::pack2(s[0][2], s[0][3]),
                              element::pack2(s[1][0], s[1][1]),
                              element::pack2(s[1][2], s[1][3])};
#pragma unroll
      for (int ot = 0; ot < kOT; ot += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + voff + 8 * ot);
        mma_bf16(o[ot], pa, vf[0], vf[1]);
        mma_bf16(o[ot + 1], pa, vf[2], vf[3]);
      }
      __syncwarp();  // the tile is read before a later copy overwrites it
    }
    t = t_next;
    stage ^= 1;
  }
  cp_async_wait<0>();  // a copy issued for no tile has landed
  if (!live) return;

  float l_row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] = l_run[r] + __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
  const int c0 = 2 * (lane & 3);
  if (p.part != nullptr) {
    // this split's partial softmax state, merged by mega_attention_merge
    const size_t split = (size_t)blockIdx.y * G + g;
    float* ml = p.part + (size_t)gridDim.y * G * N * DGO;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + (lane >> 2) + 8 * r;
      if (n >= N) continue;
      float* arow = p.part + (split * N + n) * DGO;
#pragma unroll
      for (int ot = 0; ot < kOT; ++ot) {
        const int c = 8 * ot + c0;
        if (c < DGO) arow[c] = o[ot][2 * r];
        if (c + 1 < DGO) arow[c + 1] = o[ot][2 * r + 1];
      }
      if ((lane & 3) == 0) {
        ml[2 * (split * N + n)] = m_run[r];
        ml[2 * (split * N + n) + 1] = l_row[r];
      }
    }
    return;
  }
  // O / l, rounded once to bf16; a row with no valid key is 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + (lane >> 2) + 8 * r;
    if (n >= N) continue;
    const float inv = l_row[r] > 0.f ? 1.f / l_row[r] : 0.f;
    bf16* orow = p.out + (size_t)n * G * DGO + (size_t)g * DGO;
#pragma unroll
    for (int ot = 0; ot < kOT; ++ot) {
      const int c = 8 * ot + c0;
      const float y0 = o[ot][2 * r] * inv, y1 = o[ot][2 * r + 1] * inv;
      if (DGO % 2 == 0 && c + 1 < DGO) {
        *reinterpret_cast<uint32_t*>(orow + c) = element::pack2(y0, y1);
      } else {
        if (c < DGO) orow[c] = element::from_f32<bf16>(y0);
        if (c + 1 < DGO) orow[c + 1] = element::from_f32<bf16>(y1);
      }
    }
  }
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

// An instance of the bf16 kernel: its channel bucket, groups a block and
// dynamic shared memory.
struct MmaInstance {
  void (*kernel)(Params<bf16>, bool);
  int bucket, groups;
  size_t smem;
};

template <int DB, int GB>
MmaInstance mma_instance() {
  return {mega_attention_mma_kernel<DB, GB>, DB, GB,
          MmaTiles<DB, GB>::kBytes};
}

// The bucket of max(dg, dgo), and as many groups a block as registers and
// shared memory hold at one block an SM: 16 up to 64 channels (O and Q's
// fragments in 48 of a thread's 128 registers), 8 at 128, 4 at 256 (Q's
// fragments read from shared memory each tile).
MmaInstance pick_mma(int DG, int DGO) {
  const int d = max(DG, DGO);
  return d <= 16    ? mma_instance<16, 16>()
         : d <= 32  ? mma_instance<32, 16>()
         : d <= 64  ? mma_instance<64, 16>()
         : d <= 128 ? mma_instance<128, 8>()
                    : mma_instance<256, 4>();
}

cudaError_t mma_attributes(const MmaInstance& in) {
  cudaError_t err = cudaFuncSetAttribute(
      in.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)in.smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(in.kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

constexpr int kMaxSplits = 16;

// The number of key splits: as many whole waves of `blocks` blocks a split
// as the card holds at once (from the kernel's occupancy at `threads`
// threads and `smem` bytes), without more splits than key tiles (or
// kMaxSplits).
template <typename F>
cudaError_t pick_splits(F kernel, int threads, size_t smem, int blocks,
                        int n_tiles, int* S) {
  int dev, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  const int slots = sms * (per_sm > 0 ? per_sm : 1);
  *S = min(max(1, slots / blocks), min(max(1, n_tiles), kMaxSplits));
  return cudaSuccess;
}

bool bad_shape(int N, int M, int G, int DG, int DGO) {
  return N < 1 || M < 0 || G < 1 || G > kMaxGroups || DG < 1 ||
         DG > kMaxDim || DGO < 1 || DGO > kMaxDim;
}

// The rows a block of E's kernel for (G, DG, DGO) and its key splits: the
// fp32 kernel's blocks of `rows` rows and every group, the bf16 kernel's
// of 16 rows and a chunk of groups (grid.z), each over its own key tiles.
template <typename E>
int plan(int N, int M, int G, int DG, int DGO, int* splits, int* rows) {
  if (bad_shape(N, M, G, DG, DGO)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (std::is_same_v<E, bf16>) {
    const MmaInstance in = pick_mma(DG, DGO);
    *rows = kMmaRows;
    if ((err = mma_attributes(in)) != cudaSuccess) return (int)err;
    const int blocks =
        (N + kMmaRows - 1) / kMmaRows * ((G + in.groups - 1) / in.groups);
    return (int)pick_splits(in.kernel, 32 * min(G, in.groups), in.smem,
                            blocks, (M + kMmaTile - 1) / kMmaTile, splits);
  } else {
    const Instance<E> in = pick_instance<E>(G, DG, DGO);
    *rows = in.rows;
    err = cudaFuncSetAttribute(
        in.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)in.smem);
    if (err != cudaSuccess) return (int)err;
    return (int)pick_splits(in.kernel, 32 * G, in.smem,
                            (N + in.rows - 1) / in.rows,
                            (M + kTile - 1) / kTile, splits);
  }
}

// Launches E's kernel on `splits` runs of the keys, then (with more than
// one) the merge; the arguments are mega_attention_forward's.
template <typename E>
int forward(const E* q, const E* k, const E* vproj, const float* ub,
            const unsigned char* valid, const float* q_rois,
            const float* k_rois, const float* A, const float* Bt,
            const float* wt, const float* b, E* out, float* part, int N,
            int M, int G, int DG, int DGO, int splits, float scale,
            const float* freqs, void* stream) {
  constexpr bool kMma = std::is_same_v<E, bf16>;
  if (bad_shape(N, M, G, DG, DGO) || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && part == nullptr) ||
      (q_rois != nullptr && freqs == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tile = kMma ? kMmaTile : kTile;
  const int n_tiles = (M + tile - 1) / tile;
  Params<E> p{q, k, vproj, ub, valid, q_rois, k_rois, A, Bt, wt, b, out,
              splits > 1 ? part : nullptr, N, M, G, DG, DGO,
              (n_tiles + splits - 1) / splits, scale, {}};
  if (q_rois != nullptr)
    for (int i = 0; i < mega_bias::kFreqs; ++i) p.fr.c[i] = freqs[i];
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if constexpr (kMma) {
    const MmaInstance in = pick_mma(DG, DGO);
    if ((err = mma_attributes(in)) != cudaSuccess) return (int)err;
    // 16-byte copies where every row starts 16-byte aligned
    const bool vec = DG % 8 == 0 && DGO % 8 == 0 &&
                     ((reinterpret_cast<uintptr_t>(q) |
                       reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(vproj)) & 15) == 0;
    const dim3 grid((N + kMmaRows - 1) / kMmaRows, splits,
                    (G + in.groups - 1) / in.groups);
    in.kernel<<<grid, 32 * min(G, in.groups), in.smem, s>>>(p, vec);
  } else {
    const Instance<E> in = pick_instance<E>(G, DG, DGO);
    err = cudaFuncSetAttribute(
        in.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)in.smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N + in.rows - 1) / in.rows, splits);
    in.kernel<<<grid, 32 * G, in.smem, s>>>(p);
  }
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

// The bf16 kernel's instance for (G, DG, DGO): its channel bucket and the
// groups a block (a launch takes ceil(G / groups) blocks along grid.z),
// for the wrapper's tests and reports. Returns the CUDA error code.
extern "C" int mega_attention_mma_instance(int G, int DG, int DGO,
                                           int* bucket, int* groups) {
  if (bad_shape(1, 0, G, DG, DGO)) return (int)cudaErrorInvalidValue;
  const MmaInstance in = pick_mma(DG, DGO);
  *bucket = in.bucket;
  *groups = in.groups;
  return 0;
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* mega_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
