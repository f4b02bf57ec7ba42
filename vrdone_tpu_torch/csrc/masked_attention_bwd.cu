// Key-masked full attention backward for Hopper (sm_90a), fp32 and bf16:
// K8 (dQ) and K9 (dK, dV).
//
// Replaces the backward of the Pallas library flash kernel that
// vrdone_tpu/ops/masked.py::_full_attention_flash trains through when
// VRDONE_FLASH_TRAIN=1 (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dq, whose pallas_call runs _flash_attention_dq_kernel,
// and _flash_attention_bwd_dkv, which runs _flash_attention_dkv_kernel). The
// forward is K7 (masked_attention.cu) with its lse output. For a (batch,
// head), with s_ij = scale * q_i . k_j:
//   P_ij  = exp(s_ij - lse_i) at a valid key j, 0 at an invalid one
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij * (dP_ij - Dr_i) * scale,   Dr_i = rowsum(dO_i * O_i)
//   dQ_i = sum_j dS_ij k_j,  dK_j = sum_i dS_ij q_i,  dV_j = sum_i P_ij dO_i
// An invalid key gets exactly zero dK and dV. A query row with no valid key
// has lse = +inf (K7 writes it so), so its P is 0 at every key: its dQ is 0
// and it adds nothing to dK or dV (the forward pins that row's output to 0).
//
// What bounds it on this card. K8 does 6 and K9 8 flops a (query, valid
// key) pair a channel (three and four products). At the VidOR train step's
// S/O cross-attention (B*H = 48*8, 512 x 512, d = 64, every key valid) that
// is 39 and 52 GFLOP: 0.58 and 0.77 ms on the fp32 FMA pipes (67 TFLOP/s)
// against 0.08 and 0.09 ms for their fp32 bytes, so the operations bound the
// fp32 instances; 0.039 and 0.052 ms on the tensor cores (989 TFLOP/s)
// against 0.038 and 0.046 ms for their bf16 bytes, so in bf16 the two are
// even, and with chip_smoke.py's random-length key masks the bytes bound
// both kernels.
//
// fp32: one FMA body for both kernels (masked_attention_bwd_kernel<DB, TM,
// KV>), rounding nowhere: a block owns kRows rows of one (batch, head) --
// query rows for K8, key rows for K9 -- and walks the partner rows (keys
// for K8, queries for K9) in tiles of 32.
// - The owner tile's two streams (K8: Q and dO; K9: K and V) are read once
//   into shared memory, zero past the rows, past d and (K9) at an invalid
//   key. The partner tile's two streams (K8: K and V; K9: Q and dO) come in
//   with cp.async, 16 bytes a thread, double-buffered, zero past the rows,
//   past d and (K8) at an invalid key. K8 skips a key tile with no valid key
//   before its copy, as K7 does; a K9 block whose owner keys are all invalid
//   writes zeros and stops.
// - Register micro-tiles as in K7's fp32 body: each of the 128 threads owns
//   TM owner rows x 4 partners of the 32-partner tile, and takes s and dP
//   for them at once, from TM owner and 4 partner 4-channel loads of each
//   stream a step (2 x 16 TM FMAs).
// - P (K9) and dS go to shared memory partner-major, and the tile's
//   products accumulate into TM owner rows x d/8 channels a thread: dQ +=
//   dS.K (K8); dK += dS^T.Q and dV += P^T.dO (K9).
// - kRows = 16 TM: 64 rows (TM 4) up to d = 64, 32 at the 128 bucket and 16
//   at 256, which keeps K9's two accumulators at 64 registers a thread and
//   the tiles within shared memory; 16 wherever there are at most 16 owner
//   rows (the predictor's 9 queries in K8, 9 keys in K9).
// - d % 4 != 0 or a stream that is not 16-byte aligned: the same body with
//   element-wise copies.
//
// bf16: one tensor-core body for both kernels, masked_attention_bwd_mma_
// kernel<DB, W, NP, KV> on mma.sync m16n8k16 (bf16 operands, fp32 sums),
// built from the pieces of K7 bf16 (masked_attention.cu) and of the band
// backward's bf16 kernel (band_attention.cu, band_backward_mma_kernel). It
// follows the library backward's rounding points: the scores and dP are
// fp32 sums of the bf16 operands, the score scaled after the dot, P and dS
// (scaled) fp32, then P rounded to bf16 before P^T.dO and dS rounded to
// bf16 before dS.K and dS^T.Q, every sum fp32, each gradient rounded to
// bf16 once.
// - Owners as the m16 operand. A block of W warps owns 16 W owner rows;
//   each warp owns 16 of them and computes both products of a partner tile
//   with its owners as A: K8 S = Q.K^T and dP = dO.V^T, K9 S^T = K.Q^T and
//   dP^T = V.dO^T, the partners' B fragments by ldmatrix, so nothing is
//   transposed through shared memory. The owner fragments come from
//   ldmatrix once and stay in registers up to the 128 bucket in K8 and the
//   64 bucket in K9 (whose two gradient sums take twice the registers);
//   above, they are read again from shared memory each k16 step.
// - Partner tiles of NP rows (64 up to the 64 bucket, 32 above) arrive by
//   16-byte cp.async, double-buffered, at a row stride of DB + 8 (rows stay
//   16-byte aligned and an ldmatrix's 8 rows hit distinct banks): K8's K and
//   V, an invalid key zero-filled and a key tile with no valid key skipped
//   before its copy (the valid-key bits of 4096 keys held in shared memory,
//   as K7 bf16 holds them); K9's Q and dO with the lse and Dr of those
//   queries (4-byte cp.async).
// - A staged tile is computed 32 partners at a time (16 in K9), so that one
//   chunk's S, dP, P and dS live in registers beside the gradient sums.
//   What sets the pace is how many blocks an SM holds: 168 registers or
//   fewer a thread let it hold three blocks of 4 warps where it held two,
//   and K9 fits them only with 16-partner chunks.
// - P and dS stay in registers: formed in fp32 from the accumulators, with
//   invalid keys, partners past Tq or Tk and owners past the edge excluded
//   by selection (never by multiplying zero-filled data: 0 * NaN is NaN in
//   the tensor cores too), then rounded to bf16 and packed straight into A
//   fragments (the accumulators of n8 tiles 2 kk and 2 kk + 1 are the A
//   fragment of k16 step kk, as K7 bf16 feeds P to P.V).
// - The products: K8 dQ += dS.K, K9 dV += P^T.dO and dK += dS^T.Q, the B
//   fragments from ldmatrix.trans of the partner tiles, fp32 sums. A
//   gradient of more than 128 channels (64 in K9) is summed in passes over
//   the partners, 128 (64) channels a pass, so that no sum takes more than
//   64 registers; each K8 pass walks the keys from the block's first tile
//   with a valid key, in the window of key bits that holds it. Each gradient is staged, rounded to bf16, in the partner
//   tiles, free by then, and written in 16-byte stores.
// - No atomics and no second pass over the output: K8 owns query rows and K9
//   key rows, so the result is the same bit for bit from launch to launch. A
//   K9 block whose owner keys are all invalid writes zeros and stops.
// - Owner rows a block: 16, 32 or 64, the smallest that holds the owners
//   (64 past 64). The rule for both element types is pick_backward, which
//   ops/full_attention.py::backward_instance reports.
// - d % 8 != 0 or a stream that is not 16-byte aligned: 2-byte copies and
//   stores into the same padded layout.
//
// Measured (chip_smoke.py --only kernels, each kernel alone, on "NVIDIA
// H100 80GB HBM3, 700.00 W", this source and the one before it in turns
// in one run; PERF.md section 6) at B*H = 48*8, 512 x 512, d = 64 with
// random-length key masks: bf16 K8 0.1660-0.1666 ms and K9 0.1659-0.1673 ms
// (168 registers each, no spills), where the FMA body on widened bf16
// operands took 0.6453-0.6475 and 0.8419-0.8425; bounds 0.0380 and 0.0455
// ms (bytes). fp32 K8 0.7819-0.7880 ms and K9 1.0442-1.0639 ms against
// 0.3201 and 0.4268 (operations).

// Layout: q, dout and dq are (B, Tq, H*d), k, v, dk and dv (B, Tk, H*d),
// contiguous, all fp32 or all bf16 (the _bf16 entry points), heads split
// head-major along the channels. mask is (B, Tk) bool (one byte each); lse
// and dr are (B, H, Tq) fp32. Takes any Tq and Tk and 1 <= d <= 256; the
// Python wrapper rejects anything else before the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "element.cuh"
#include "warp_mma.cuh"

namespace {

using element::bf16;
using warp_mma::cp_async16;
using warp_mma::cp_async4;
using warp_mma::cp_async_commit;
using warp_mma::cp_async_wait;
using warp_mma::ldmatrix_x4;
using warp_mma::ldmatrix_x4_trans;
using warp_mma::mma_bf16;

constexpr int kThreads = 128;  // 4 warps, each 4 row groups of 8 lanes
constexpr int kTile = 32;      // partners a tile: 8 lanes x 4
constexpr int kMaxD = 256;

template <typename E>
struct Grads {
  const E* q;
  const E* k;
  const E* v;
  const unsigned char* mask;
  const float* lse;  // (B, H, Tq)
  const float* dr;   // (B, H, Tq)
  const E* dout;
  E* dq;  // K8
  E* dk;  // K9
  E* dv;  // K9
  int B, Tq, Tk, H, D;
  float scale;
};

// Shared-memory tiles of an fp32 instance (K9 with KV).
template <int DB, int TM, bool KV>
struct BwdTiles {
  static constexpr int kRows = 16 * TM;  // 4 warps x 4 row groups x TM
  static constexpr int kAS = DB + 4;     // owner row stride (floats)
  // partner row stride (floats): 16 bytes past the row, so rows stay
  // 16-byte aligned for cp.async and a quarter-warp's loads hit distinct
  // banks
  static constexpr int kBS = DB + 4;
  static constexpr int kPS = kRows + 4;  // P / dS row stride (floats)
  static constexpr int kA = kRows * kAS;
  static constexpr int kB = kTile * kBS;
  static constexpr int kP = kTile * kPS;
  static constexpr int kNP = KV ? 2 : 1;  // P and dS (K9), dS (K8)
  // owner streams, P / dS, 2 stages of the partners' lse and Dr (K9), then
  // 2 stages of each partner stream
  static constexpr size_t kBytes =
      sizeof(float) * (2 * kA + kNP * kP + 4 * kTile + 4 * kB);
};

// The first key tile at or after t that holds a valid key (n_tiles if
// none). Block-uniform; every test is a barrier, and there is at least one.
__device__ __forceinline__ int next_tile(const unsigned char* mrow, int t,
                                         int n_tiles, int Tk) {
  for (;; ++t) {
    const int j = t * kTile + (threadIdx.x & (kTile - 1));
    if (__syncthreads_or(t < n_tiles && j < Tk && mrow[j]) || t >= n_tiles)
      return t;
  }
}

// kRows owner rows first .. of src (row stride C past base) into dst at
// stride DB + 4; rows at or past `end`, with a mask rows whose byte is 0,
// and channels past D are 0.
template <int DB, int kRows>
__device__ __forceinline__ void load_owner(float* dst, const float* src,
                                           size_t base, int first, int end,
                                           const unsigned char* mrow, int C,
                                           int D, bool vec) {
  constexpr int kAS = DB + 4;
  if (vec) {
    for (int idx = threadIdx.x; idx < kRows * DB / 4; idx += kThreads) {
      const int r = idx / (DB / 4);
      const int c = 4 * (idx - r * (DB / 4));
      const int j = first + r;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < end && c < D && (mrow == nullptr || mrow[j]))
        element::load<4>(src + base + (size_t)j * C + c, x);
      *reinterpret_cast<float4*>(dst + r * kAS + c) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * DB; idx += kThreads) {
      const int r = idx / DB;
      const int c = idx - r * DB;
      const int j = first + r;
      dst[r * kAS + c] = j < end && c < D && (mrow == nullptr || mrow[j])
                             ? src[base + (size_t)j * C + c]
                             : 0.f;
    }
  }
}

// One partner tile, rows j0 .. j0 + kTile - 1 of src1 and src2, into d1 and
// d2 (stride DB + 4); rows at or past `end`, with a mask rows whose byte is
// 0, and channels past D are 0.
template <int DB>
__device__ __forceinline__ void load_partners(float* d1, float* d2,
                                              const float* src1,
                                              const float* src2, size_t base,
                                              int j0, int end,
                                              const unsigned char* mrow,
                                              int C, int D, bool vec) {
  constexpr int kBS = DB + 4;
  if (vec) {
    constexpr int kChunks = DB / 4;  // 16-byte copies a row
#pragma unroll
    for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int n = idx / kChunks;
      const int c = 4 * (idx - n * kChunks);
      const int j = j0 + n;
      const bool live = j < end && c < D && (mrow == nullptr || mrow[j]);
      const size_t off = live ? base + (size_t)j * C + c : 0;
      cp_async16(d1 + n * kBS + c, src1 + off, live);
      cp_async16(d2 + n * kBS + c, src2 + off, live);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * DB; idx += kThreads) {
      const int n = idx / DB;
      const int c = idx - n * DB;
      const int j = j0 + n;
      const bool live = j < end && c < D && (mrow == nullptr || mrow[j]);
      const size_t off = base + (size_t)j * C + c;
      d1[n * kBS + c] = live ? src1[off] : 0.f;
      d2[n * kBS + c] = live ? src2[off] : 0.f;
    }
  }
}

// The N values of a thread's P or dS slots at p (16-byte aligned when N is
// a multiple of 4) into x.
template <int N>
__device__ __forceinline__ void load_slots(const float* p, float* x) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) element::load<4>(p + i, x + i);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

template <int DB, int TM, bool KV>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_kernel(const Grads<float> p, int row_tiles, bool vec) {
  using T = BwdTiles<DB, TM, KV>;
  extern __shared__ __align__(16) float smem[];
  float* a1 = smem;                    // K8: Q; K9: K (kRows x kAS, fp32)
  float* a2 = a1 + T::kA;              // K8: dO; K9: V
  float* ps = a2 + T::kA;              // K9: P (kTile x kPS, partner-major)
  float* dss = ps + (KV ? T::kP : 0);  // dS, partner-major
  float* stats = ps + T::kNP * T::kP;  // K9: 2 x (lse, Dr) of kTile queries
  float* b1s = stats + 4 * kTile;  // 2 stages, K8: K; K9: Q
  float* b2s = b1s + 2 * T::kB;    // K8: V; K9: dO

  const int bh = blockIdx.x / row_tiles;
  const int o0 = (blockIdx.x - bh * row_tiles) * T::kRows;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int D = p.D, C = p.H * p.D;
  const size_t qbase = (size_t)b * p.Tq * C + (size_t)h * D;
  const size_t kbase = (size_t)b * p.Tk * C + (size_t)h * D;
  const unsigned char* mrow = p.mask + (size_t)b * p.Tk;
  const float* lrow = p.lse + (size_t)bh * p.Tq;
  const float* drow = p.dr + (size_t)bh * p.Tq;
  // K8's owners are queries and its partners keys; K9's the other way
  const int n_own = KV ? p.Tk : p.Tq;
  const int n_par = KV ? p.Tq : p.Tk;
  const size_t obase = KV ? kbase : qbase;
  const size_t pbase = KV ? qbase : kbase;
  const int n_tiles = (n_par + kTile - 1) / kTile;

  if constexpr (KV) {
    // a block whose owner keys are all invalid: dK = dV = 0
    const int j = o0 + threadIdx.x;
    if (!__syncthreads_or(threadIdx.x < T::kRows && j < p.Tk && mrow[j])) {
      for (int idx = threadIdx.x; idx < T::kRows * D; idx += kThreads) {
        const int r = idx / D;
        const size_t off = kbase + (size_t)(o0 + r) * C + (idx - r * D);
        if (o0 + r < p.Tk) {
          p.dk[off] = 0.f;
          p.dv[off] = 0.f;
        }
      }
      return;
    }
  }

  load_owner<DB, T::kRows>(a1, KV ? p.k : p.q, obase, o0, n_own,
                           KV ? mrow : nullptr, C, D, vec);
  load_owner<DB, T::kRows>(a2, KV ? p.v : p.dout, obase, o0, n_own,
                           KV ? mrow : nullptr, C, D, vec);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // this thread's partners of a tile are col + 8 * jn, its owner rows of
  // the block row0 + 4 * i; its P and dS of a partner sit at pslot + i
  const int col = lane & 7;
  const int row0 = warp * 4 * TM + (lane >> 3);
  const int pslot = warp * 4 * TM + (lane >> 3) * TM;

  // K8: the owner rows' lse and Dr (+inf and 0 past Tq); K9: whether each
  // owner key is valid
  float own_lse[TM], own_dr[TM];
  bool own_ok[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = o0 + row0 + 4 * i;
    own_ok[i] = KV && r < p.Tk && mrow[r];
    own_lse[i] = !KV && r < p.Tq ? lrow[r] : INFINITY;
    own_dr[i] = !KV && r < p.Tq ? drow[r] : 0.f;
  }

  // the partner tile `tile` (and, K9, its queries' lse and Dr) into stage st
  auto stage_tile = [&](int tile, int st) {
    load_partners<DB>(b1s + st * T::kB, b2s + st * T::kB, KV ? p.q : p.k,
                      KV ? p.dout : p.v, pbase, tile * kTile, n_par,
                      KV ? nullptr : mrow, C, D, vec);
    if (KV && threadIdx.x < kTile) {
      const int i = tile * kTile + threadIdx.x;
      float* sl = stats + st * 2 * kTile;
      sl[threadIdx.x] = i < p.Tq ? lrow[i] : INFINITY;
      sl[kTile + threadIdx.x] = i < p.Tq ? drow[i] : 0.f;
    }
  };
  int t = KV ? 0 : next_tile(mrow, 0, n_tiles, p.Tk);
  if (t < n_tiles) stage_tile(t, 0);
  cp_async_commit();

  constexpr int kAcc2 = KV ? TM : 1;
  float acc1[TM][DB / 8], acc2[kAcc2][KV ? DB / 8 : 1];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < DB / 8; ++c) acc1[i][c] = 0.f;
#pragma unroll
  for (int i = 0; i < kAcc2; ++i)
#pragma unroll
    for (int c = 0; c < (KV ? DB / 8 : 1); ++c) acc2[i][c] = 0.f;

  int stage = 0;
  while (t < n_tiles) {
    // the barrier tells both that this tile (and the owner tile) landed for
    // every thread and that every thread is done with the other stage and
    // with the P / dS tile, which are overwritten below
    cp_async_wait<0>();
    int t_next;
    if constexpr (KV) {
      __syncthreads();
      t_next = t + 1;
    } else {
      t_next = next_tile(mrow, t + 1, n_tiles, p.Tk);
    }
    if (t_next < n_tiles) stage_tile(t_next, stage ^ 1);
    cp_async_commit();
    const float* b1 = b1s + stage * T::kB;
    const float* b2 = b2s + stage * T::kB;

    // s = a1 . b1 (unscaled) and dP = a2 . b2 for TM rows x 4 partners
    float s[TM][4], dp[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) s[i][jn] = dp[i][jn] = 0.f;
#pragma unroll 2
    for (int c = 0; c < DB; c += 4) {
      float4 u1[TM], u2[TM];
      float w1[4][4], w2[4][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        u1[i] = *reinterpret_cast<const float4*>(a1 + (row0 + 4 * i) * T::kAS
                                                 + c);
        u2[i] = *reinterpret_cast<const float4*>(a2 + (row0 + 4 * i) * T::kAS
                                                 + c);
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        element::load<4>(b1 + (col + 8 * jn) * T::kBS + c, w1[jn]);
        element::load<4>(b2 + (col + 8 * jn) * T::kBS + c, w2[jn]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          float a = s[i][jn], d = dp[i][jn];
          a = fmaf(u1[i].x, w1[jn][0], a);
          a = fmaf(u1[i].y, w1[jn][1], a);
          a = fmaf(u1[i].z, w1[jn][2], a);
          a = fmaf(u1[i].w, w1[jn][3], a);
          d = fmaf(u2[i].x, w2[jn][0], d);
          d = fmaf(u2[i].y, w2[jn][1], d);
          d = fmaf(u2[i].z, w2[jn][2], d);
          d = fmaf(u2[i].w, w2[jn][3], d);
          s[i][jn] = a;
          dp[i][jn] = d;
        }
    }

    // P = exp(s * scale - lse) at valid pairs, dS = P (dP - Dr) scale
    const float* sl = stats + stage * 2 * kTile;
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int n = col + 8 * jn;
      const int j = t * kTile + n;
      // K8: whether the key is valid; K9: the query's lse and Dr
      const bool key_ok = !KV && j < p.Tk && mrow[j];
      const float q_lse = KV ? sl[n] : 0.f;
      const float q_dr = KV ? sl[kTile + n] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const bool ok = KV ? own_ok[i] : key_ok;
        const float pij =
            ok ? __expf(s[i][jn] * p.scale - (KV ? q_lse : own_lse[i])) : 0.f;
        const float dsij = pij * (dp[i][jn] - (KV ? q_dr : own_dr[i])) *
                           p.scale;
        dss[n * T::kPS + pslot + i] = dsij;
        if constexpr (KV) ps[n * T::kPS + pslot + i] = pij;
      }
    }
    __syncthreads();  // P and dS of the whole tile are in shared memory

    // K8: dQ += dS . K; K9: dK += dS^T . Q, dV += P^T . dO
#pragma unroll 4
    for (int n = 0; n < kTile; ++n) {
      float dn[TM], pn[kAcc2];
      load_slots<TM>(dss + n * T::kPS + pslot, dn);
      if constexpr (KV) load_slots<TM>(ps + n * T::kPS + pslot, pn);
#pragma unroll
      for (int jc = 0; jc < DB / 32; ++jc) {
        float y[4];
        element::load<4>(b1 + n * T::kBS + 4 * col + 32 * jc, y);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc1[i][4 * jc + e] = fmaf(dn[i], y[e], acc1[i][4 * jc + e]);
        if constexpr (KV) {
          float z[4];
          element::load<4>(b2 + n * T::kBS + 4 * col + 32 * jc, z);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc2[i][4 * jc + e] = fmaf(pn[i], z[e], acc2[i][4 * jc + e]);
        }
      }
    }
    t = t_next;
    stage ^= 1;
  }

  // the gradients; an invalid owner key's are 0
  float* g1 = KV ? p.dk : p.dq;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = o0 + row0 + 4 * i;
    if (r >= n_own) continue;
    const bool zero = KV && !own_ok[i];
#pragma unroll
    for (int jc = 0; jc < DB / 32; ++jc) {
      const int c = 4 * col + 32 * jc;
      const size_t off = obase + (size_t)r * C + c;
      float y[4], z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = zero ? 0.f : acc1[i][4 * jc + e];
        if constexpr (KV) z[e] = zero ? 0.f : acc2[i][4 * jc + e];
      }
      if (vec) {
        if (c < D) {
          element::store<4>(g1 + off, y);
          if constexpr (KV) element::store<4>(p.dv + off, z);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < D) {
            g1[off + e] = y[e];
            if constexpr (KV) p.dv[off + e] = z[e];
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernel, on the tensor cores.

constexpr int kWindow = 4096;  // keys a K8 block's valid-key bits cover

// Partner rows a tile of the tensor-core kernel at head-dim bucket DB.
constexpr int mma_tile(int DB) { return DB <= 64 ? 64 : 32; }

template <int DB, int W, int NP, bool KV>
struct MmaBwdTiles {
  static constexpr int kT = 32 * W;        // threads: a warp a 16-row tile
  static constexpr int kRows = 16 * W;     // owner rows a block
  static constexpr int kS = DB + 8;        // row stride of every tile (bf16)
  static constexpr int kOwn = kRows * kS;  // one owner tile
  static constexpr int kPart = NP * kS;    // one partner tile
  // two owner tiles, two stages of two partner tiles, then K9's two stages
  // of its queries' lse and Dr, or K8's window of valid-key bits
  static constexpr size_t kBytes =
      sizeof(bf16) * (2 * kOwn + 4 * kPart) +
      (KV ? sizeof(float) * 4 * NP : sizeof(uint32_t) * (kWindow / 32));
};

// ROWS rows of a tile (DB channels at stride DB + 8) from the stream's rows
// first .. first + ROWS - 1 (row stride C past base), copied by kT threads;
// a row at or past `end` or whose bit in `rows` is clear, and channels past
// D, are 0. 16-byte cp.async copies (vec) or 2-byte loads.
template <int ROWS, int DB, int kT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           size_t base, int first, int end,
                                           uint64_t rows, int C, int D,
                                           bool vec) {
  constexpr int kS = DB + 8;
  if (vec) {
    constexpr int kChunks = DB / 8;  // 8 bf16 a copy
    constexpr int kN = ROWS * kChunks;
#pragma unroll 1
    for (int it = 0; it < (kN + kT - 1) / kT; ++it) {
      const int idx = threadIdx.x + it * kT;
      if (idx >= kN) break;
      const int r = idx / kChunks;
      const int c = 8 * (idx - r * kChunks);
      const int j = first + r;
      const bool live = j < end && c < D && (rows >> r) & 1u;
      cp_async16(dst + r * kS + c,
                 src + (live ? base + (size_t)j * C + c : 0), live);
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < ROWS * DB; idx += kT) {
      const int r = idx / DB;
      const int c = idx - r * DB;
      const int j = first + r;
      const bool live = j < end && c < D && (rows >> r) & 1u;
      dst[r * kS + c] = live ? src[base + (size_t)j * C + c]
                             : element::from_f32<bf16>(0.f);
    }
  }
}

// The valid-key bits of keys key0 .. key0 + kWindow - 1 into win (a bit a
// key; 0 past Tk up to the end of its tile of NP keys), read by kT threads
// between two barriers, so that nobody still reads the window it replaces.
// Block-uniform.
template <int NP, int kT>
__device__ __forceinline__ void load_window(uint32_t* win,
                                            const unsigned char* mrow,
                                            int key0, int Tk) {
  __syncthreads();
  const int n = min(kWindow, (Tk - key0 + NP - 1) / NP * NP);
  for (int k0 = 0; k0 < n; k0 += kT) {
    const int k = k0 + threadIdx.x;
    const uint32_t word =
        __ballot_sync(0xffffffffu, k < n && key0 + k < Tk && mrow[key0 + k]);
    if ((threadIdx.x & 31) == 0 && k < n) win[k >> 5] = word;
  }
  __syncthreads();
}

// The valid-key bits of key tile t, a bit a key of the tile; key0 is the
// first key of the window that holds it.
template <int NP>
__device__ __forceinline__ uint64_t tile_keys(const uint32_t* win, int t,
                                              int key0) {
  const uint32_t* w = win + (t * NP - key0) / 32;
  if constexpr (NP == 64) return w[0] | (uint64_t)w[1] << 32;
  return w[0];
}

// The first key tile at or after t that holds a valid key (n_tiles if
// none), moving the window on (key0) where a tile lies past it.
// Block-uniform.
template <int NP, int kT>
__device__ __forceinline__ int next_valid_tile(uint32_t* win, int& key0,
                                               const unsigned char* mrow,
                                               int t, int n_tiles, int Tk) {
  for (; t < n_tiles; ++t) {
    if ((t + 1) * NP > key0 + kWindow) {
      key0 = t * NP;
      load_window<NP, kT>(win, mrow, key0, Tk);
    }
    if (tile_keys<NP>(win, t, key0)) return t;
  }
  return n_tiles;
}

// A warp's 16 gradient rows, staged at y (kOC channels at stride DB + 8),
// to rows r0 .. r0 + 15 of dst (row stride C past base; channels from oc),
// those before `end` and channels before D: 16-byte stores (vec) or 2-byte
// ones.
template <int DB, int kOC>
__device__ __forceinline__ void write_rows(bf16* dst, const bf16* y,
                                           size_t base, int r0, int end,
                                           int oc, int C, int D, bool vec,
                                           int lane) {
  constexpr int kS = DB + 8;
  if (vec) {
    constexpr int kChunks = kOC / 8;
#pragma unroll
    for (int it = 0; it < 16 * kChunks / 32; ++it) {
      const int idx = lane + 32 * it;
      const int r = idx / kChunks;
      const int c = 8 * (idx - r * kChunks);
      if (r0 + r < end && oc + c < D)
        *reinterpret_cast<uint4*>(dst + base + (size_t)(r0 + r) * C + oc +
                                  c) =
            *reinterpret_cast<const uint4*>(y + r * kS + c);
    }
  } else {
    for (int idx = lane; idx < 16 * kOC; idx += 32) {
      const int r = idx / kOC;
      const int c = idx - r * kOC;
      if (r0 + r < end && oc + c < D)
        dst[base + (size_t)(r0 + r) * C + oc + c] = y[r * kS + c];
    }
  }
}

// The A fragment of k16 step kk of a warp's [owner x partner] tile x (its
// n8 accumulator tiles 2 kk and 2 kk + 1), rounded to bf16.
template <int NT>
__device__ __forceinline__ void pack_step(uint32_t a[4],
                                          const float (&x)[NT][4], int kk) {
  a[0] = element::pack2(x[2 * kk][0], x[2 * kk][1]);
  a[1] = element::pack2(x[2 * kk][2], x[2 * kk][3]);
  a[2] = element::pack2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = element::pack2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// The bf16 backward on the tensor cores, K8 (KV false: owners are queries,
// partners keys) and K9 (KV true: owners are keys, partners queries). A
// block of W warps takes 16 W owner rows of one (batch, head) from o0;
// warp w owns rows o0 + 16 w .. o0 + 16 w + 15, an m16 tile, and walks the
// partners in tiles of NP rows, NP / 8 n8 tiles. A lane holds the pairs of
// owner rows g = lane / 4 and g + 8 with the partner columns 8 jn + 2 (lane
// % 4) + 0 and 1 of each n8 tile jn (mma.sync's accumulator layout).
template <int DB, int W, int NP, bool KV>
__global__ void __launch_bounds__(32 * W)
masked_attention_bwd_mma_kernel(const Grads<bf16> p, int row_tiles,
                                bool vec) {
  using T = MmaBwdTiles<DB, W, NP, KV>;
  constexpr int kS = T::kS, kT = T::kT, kRows = T::kRows;
  constexpr int kSteps = DB / 16;  // k16 channel steps of S and dP
  // partners of S and dP at a time (K9's two gradient sums leave room for
  // fewer) and their n8 tiles
  constexpr int kChunk = KV ? 16 : 32;
  constexpr int kNT = kChunk / 8;
  // gradient channels a pass: each accumulator of at most 64 registers
  constexpr int kOC = DB < (KV ? 64 : 128) ? DB : KV ? 64 : 128;
  constexpr int kOT = kOC / 8;                    // their n8 tiles
  constexpr bool kOwnRegs = DB <= (KV ? 64 : 128);
  static_assert(4 * NP >= (KV ? 2 : 1) * kRows,
                "the gradients are staged in the partner tiles");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  bf16* oa = reinterpret_cast<bf16*>(bwd_smem);  // K8: Q; K9: K
  bf16* ob = oa + T::kOwn;                       // K8: dO; K9: V
  bf16* pa = ob + T::kOwn;        // 2 stages, K8: K; K9: Q
  bf16* pb = pa + 2 * T::kPart;   // 2 stages, K8: V; K9: dO
  // K9: 2 stages of (lse, Dr) of NP queries; K8: the valid-key bits
  float* stats = reinterpret_cast<float*>(pb + 2 * T::kPart);
  uint32_t* win = reinterpret_cast<uint32_t*>(stats);

  const int bh = blockIdx.x / row_tiles;
  const int o0 = (blockIdx.x - bh * row_tiles) * kRows;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int Tq = p.Tq, Tk = p.Tk, D = p.D, C = p.H * p.D;
  const size_t qbase = (size_t)b * Tq * C + (size_t)h * D;
  const size_t kbase = (size_t)b * Tk * C + (size_t)h * D;
  const unsigned char* mrow = p.mask + (size_t)b * Tk;
  const float* lrow = p.lse + (size_t)bh * Tq;
  const float* drow = p.dr + (size_t)bh * Tq;
  // K8's owners are queries and its partners keys; K9's the other way
  const int n_own = KV ? Tk : Tq;
  const int n_par = KV ? Tq : Tk;
  const size_t obase = KV ? kbase : qbase;
  const size_t pbase = KV ? qbase : kbase;
  const int n_tiles = (n_par + NP - 1) / NP;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;

  // K9: the block's valid owner keys, a bit a row (the same in every warp);
  // a block with none writes dK = dV = 0 and stops
  uint64_t own_keys = ~0ull;
  if constexpr (KV) {
    own_keys = 0;
#pragma unroll
    for (int r0 = 0; r0 < kRows; r0 += 32) {
      const int r = r0 + lane;
      own_keys |= (uint64_t)__ballot_sync(
                      0xffffffffu, r < kRows && o0 + r < Tk && mrow[o0 + r])
                  << r0;
    }
    if (own_keys == 0) {
      for (int idx = threadIdx.x; idx < kRows * D; idx += kT) {
        const int r = idx / D;
        const size_t off = kbase + (size_t)(o0 + r) * C + (idx - r * D);
        if (o0 + r < Tk) {
          p.dk[off] = element::from_f32<bf16>(0.f);
          p.dv[off] = element::from_f32<bf16>(0.f);
        }
      }
      return;
    }
  }

  // the owner tiles (an invalid owner key's rows 0), then K8's window and
  // first key tile with a valid key
  stage_rows<kRows, DB, kT>(oa, KV ? p.k : p.q, obase, o0, n_own, own_keys,
                            C, D, vec);
  stage_rows<kRows, DB, kT>(ob, KV ? p.v : p.dout, obase, o0, n_own,
                            own_keys, C, D, vec);
  cp_async_commit();
  // K8: the first key of the window that holds t0, where every pass over
  // the keys starts
  int key0 = 0, t0 = 0, key0_t0 = 0;
  if constexpr (!KV) {
    load_window<NP, kT>(win, mrow, key0, Tk);
    t0 = next_valid_tile<NP, kT>(win, key0, mrow, 0, n_tiles, Tk);
    key0_t0 = key0;
  }

  // the partner tile `tile` (K9: and its queries' lse and Dr) into stage st
  auto stage_tile = [&](int tile, int st) {
    const uint64_t rows = KV ? ~0ull : tile_keys<NP>(win, tile, key0);
    stage_rows<NP, DB, kT>(pa + st * T::kPart, KV ? p.q : p.k, pbase,
                           tile * NP, n_par, rows, C, D, vec);
    stage_rows<NP, DB, kT>(pb + st * T::kPart, KV ? p.dout : p.v, pbase,
                           tile * NP, n_par, rows, C, D, vec);
    if constexpr (KV) {
      for (int i = threadIdx.x; i < 2 * NP; i += kT) {
        const int q = tile * NP + (i & (NP - 1));
        cp_async4(stats + st * 2 * NP + i,
                  (i < NP ? lrow : drow) + (q < Tq ? q : 0), q < Tq);
      }
    }
  };

  const int wr = 16 * warp;              // the warp's first row of the block
  const bool live = o0 + wr < n_own;     // warp-uniform
  const bf16* ow1 = oa + wr * kS;        // the warp's owner rows
  const bf16* ow2 = ob + wr * kS;
  // the rows this lane points at in an ldmatrix.x4: an owner tile's A
  // fragment of one k16 step, or (transposed) a partner tile's B fragments
  // of one k16 partner step for two n8 channel tiles (row lane % 16,
  // channels from (lane / 16) * 8); a partner tile's B fragments of S and
  // dP for two k16 steps of one n8 tile (row lane % 8, channels from
  // (lane / 8) * 8)
  const int xoff = (lane & 15) * kS + (lane >> 4) * 8;
  const int boff = (lane & 7) * kS + (lane >> 3) * 8;
  // this lane's owner rows g and g + 8: whether each is a row to compute
  // (before the edge; K9: a valid key) and (K8) its lse and Dr
  bool row_ok[2];
  float own_lse[2], own_dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = o0 + wr + g + 8 * r;
    row_ok[r] = i < n_own && (own_keys >> (wr + g + 8 * r)) & 1u;
    own_lse[r] = !KV && i < Tq ? lrow[i] : INFINITY;
    own_dr[r] = !KV && i < Tq ? drow[i] : 0.f;
  }

  uint32_t fa[kOwnRegs ? kSteps : 1][4], fb[kOwnRegs ? kSteps : 1][4];
  bool first = true;
#pragma unroll
  for (int oc = 0; oc < DB; oc += kOC) {
    float acc1[kOT][4], acc2[KV ? kOT : 1][4];
#pragma unroll
    for (int ot = 0; ot < kOT; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[ot][e] = acc2[KV ? ot : 0][e] = 0.f;

    int t = t0, stage = 0;
    if (t < n_tiles) stage_tile(t, 0);
    cp_async_commit();
    while (t < n_tiles) {
      // K8: this tile's valid keys, read before the barrier below, after
      // which the window may move on
      const uint64_t keys = KV ? 0 : tile_keys<NP>(win, t, key0);
      // the barrier tells both that this tile (and the owner tiles) landed
      // for every thread and that every warp is done with the other stage,
      // which the next copy overwrites while this tile is used
      cp_async_wait<0>();
      __syncthreads();
      const int t_next =
          KV ? t + 1
             : next_valid_tile<NP, kT>(win, key0, mrow, t + 1, n_tiles, Tk);
      if (t_next < n_tiles) stage_tile(t_next, stage ^ 1);
      cp_async_commit();
      if (live) {
        const bf16* b1 = pa + stage * T::kPart;
        const bf16* b2 = pb + stage * T::kPart;
        if constexpr (kOwnRegs) {
          if (first) {
#pragma unroll
            for (int kk = 0; kk < kSteps; ++kk) {
              ldmatrix_x4(fa[kk], ow1 + xoff + 16 * kk);
              ldmatrix_x4(fb[kk], ow2 + xoff + 16 * kk);
            }
          }
        }

        // the tile kChunk partners at a time: one chunk's S, dP, P and dS
        // live in registers beside the gradient sums
#pragma unroll 1
        for (int pc = 0; pc < NP; pc += kChunk) {
          const bf16* c1 = b1 + pc * kS;  // the chunk's partner rows
          const bf16* c2 = b2 + pc * kS;

          // S = own1 . part1^T and dP = own2 . part2^T, each partner
          // fragment serving its n8 tile
          float s[kNT][4], dp[kNT][4];
#pragma unroll
          for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[jn][e] = dp[jn][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kSteps; kk += 2) {
            uint32_t a1[2][4], a2[2][4];
#pragma unroll
            for (int k2 = 0; k2 < 2; ++k2) {
              if constexpr (kOwnRegs) {
#pragma unroll
                for (int x = 0; x < 4; ++x) {
                  a1[k2][x] = fa[kk + k2][x];
                  a2[k2][x] = fb[kk + k2][x];
                }
              } else {
                ldmatrix_x4(a1[k2], ow1 + xoff + 16 * (kk + k2));
                ldmatrix_x4(a2[k2], ow2 + xoff + 16 * (kk + k2));
              }
            }
#pragma unroll
            for (int jn = 0; jn < kNT; ++jn) {
              uint32_t f[4];
              ldmatrix_x4(f, c1 + 8 * jn * kS + boff + 16 * kk);
              mma_bf16(s[jn], a1[0], f[0], f[1]);
              mma_bf16(s[jn], a1[1], f[2], f[3]);
              ldmatrix_x4(f, c2 + 8 * jn * kS + boff + 16 * kk);
              mma_bf16(dp[jn], a2[0], f[0], f[1]);
              mma_bf16(dp[jn], a2[1], f[2], f[3]);
            }
          }

          // P = exp(s * scale - lse) and dS = P (dP - Dr) scale in place of
          // S and dP, in fp32; a pair whose key is invalid, whose partner
          // lies past the edge or whose owner row is not computed is 0,
          // selected (never multiplied), so that nothing of such a row
          // reaches the sums
          const float* sl = stats + stage * 2 * NP + pc;  // K9: lse, Dr
#pragma unroll
          for (int jn = 0; jn < kNT; ++jn) {
            float2 ql = make_float2(0.f, 0.f), qr = ql;
            if constexpr (KV) {
              ql = *reinterpret_cast<const float2*>(sl + 8 * jn + 2 * qd);
              qr = *reinterpret_cast<const float2*>(sl + NP + 8 * jn +
                                                    2 * qd);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              // the partner's column in the tile
              const int c = pc + 8 * jn + 2 * qd + (e & 1);
              const int r = e >> 1;
              const bool ok = row_ok[r] && (KV ? t * NP + c < Tq
                                               : (keys >> c) & 1u);
              const float lse = KV ? (e & 1 ? ql.y : ql.x) : own_lse[r];
              const float drv = KV ? (e & 1 ? qr.y : qr.x) : own_dr[r];
              const float pv =
                  ok ? __expf(__fmul_rn(s[jn][e], p.scale) - lse) : 0.f;
              s[jn][e] = pv;
              dp[jn][e] = ok ? pv * (dp[jn][e] - drv) * p.scale : 0.f;
            }
          }

          // K8: dQ += dS . K; K9: dK += dS^T . Q and dV += P^T . dO, with P
          // and dS rounded to bf16 in registers; each partner fragment
          // serves two n8 channel tiles
#pragma unroll
          for (int kk = 0; kk < kChunk / 16; ++kk) {
            uint32_t xd[4], xp[4];
            pack_step<kNT>(xd, dp, kk);
            if constexpr (KV) pack_step<kNT>(xp, s, kk);
#pragma unroll
            for (int ot = 0; ot < kOT; ot += 2) {
              uint32_t f[4];
              ldmatrix_x4_trans(f, c1 + 16 * kk * kS + xoff + oc + 8 * ot);
              mma_bf16(acc1[ot], xd, f[0], f[1]);
              mma_bf16(acc1[ot + 1], xd, f[2], f[3]);
              if constexpr (KV) {
                ldmatrix_x4_trans(f, c2 + 16 * kk * kS + xoff + oc + 8 * ot);
                mma_bf16(acc2[ot], xp, f[0], f[1]);
                mma_bf16(acc2[ot + 1], xp, f[2], f[3]);
              }
            }
          }
        }
        first = false;
      }
      t = t_next;
      stage ^= 1;
    }

    // every warp is done with the partner tiles and every copy has landed
    // (where no key tile was walked, the owner tiles' too): each warp
    // stages its gradient rows, rounded to bf16 once (an invalid owner
    // key's 0), in rows of the partner tiles of its own, and writes them out
    cp_async_wait<0>();
    __syncthreads();
    if (live) {
      bf16* y1 = pa + (KV ? 2 : 1) * wr * kS;
      bf16* y2 = y1 + 16 * kS;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool keep = !KV || row_ok[r];
        const int row = (g + 8 * r) * kS + 2 * qd;
        uint32_t* o1 = reinterpret_cast<uint32_t*>(y1 + row);
        uint32_t* o2 = reinterpret_cast<uint32_t*>(y2 + row);
#pragma unroll
        for (int ot = 0; ot < kOT; ++ot) {
          o1[4 * ot] = keep ? element::pack2(acc1[ot][2 * r],
                                             acc1[ot][2 * r + 1])
                            : 0u;
          if constexpr (KV)
            o2[4 * ot] = keep ? element::pack2(acc2[ot][2 * r],
                                               acc2[ot][2 * r + 1])
                              : 0u;
        }
      }
      __syncwarp();
      write_rows<DB, kOC>(KV ? p.dk : p.dq, y1, obase, o0 + wr, n_own, oc, C,
                          D, vec, lane);
      if constexpr (KV)
        write_rows<DB, kOC>(p.dv, y2, obase, o0 + wr, n_own, oc, C, D, vec,
                            lane);
    }
    // the next pass's first copy overwrites the staged rows; K8's walk
    // starts again at t0, whose window the last pass may have moved past
    if (oc + kOC < DB) {
      __syncthreads();
      if (!KV && key0 != key0_t0) {
        key0 = key0_t0;
        load_window<NP, kT>(win, mrow, key0, Tk);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launches.

// Whether every stream can be copied in 16-byte chunks: d a multiple of
// 16 bytes' elements and every pointer 16-byte aligned.
template <typename E>
bool vector_copies(const Grads<E>& p) {
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
      reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.dout) |
      reinterpret_cast<uintptr_t>(p.dq) | reinterpret_cast<uintptr_t>(p.dk) |
      reinterpret_cast<uintptr_t>(p.dv);
  return p.D % (16 / (int)sizeof(E)) == 0 && (any & 15) == 0;
}

// One block of `threads` for each `rows` owner rows of a (batch, head).
template <typename E>
cudaError_t start(void (*kernel)(Grads<E>, int, bool), int rows, int threads,
                  size_t bytes, const Grads<E>& p, bool kv,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int n_own = kv ? p.Tk : p.Tq;
  const int row_tiles = (n_own + rows - 1) / rows;
  const long long blocks = (long long)p.B * p.H * row_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, bytes, stream>>>(p, row_tiles,
                                                       vector_copies(p));
  return cudaGetLastError();
}

// The fp32 instance of 16 TM owner rows a block.
template <int DB, int TM, bool KV>
cudaError_t launch(const Grads<float>& p, cudaStream_t stream) {
  using T = BwdTiles<DB, TM, KV>;
  return start(masked_attention_bwd_kernel<DB, TM, KV>, T::kRows,
               kThreads, T::kBytes, p, KV, stream);
}

// The bf16 instance of W warps, 16 owner rows each.
template <int DB, int W, bool KV>
cudaError_t launch_mma(const Grads<bf16>& p, cudaStream_t stream) {
  using T = MmaBwdTiles<DB, W, mma_tile(DB), KV>;
  return start(masked_attention_bwd_mma_kernel<DB, W, mma_tile(DB), KV>,
               T::kRows, T::kT, T::kBytes, p, KV, stream);
}

template <int DB, bool KV>
cudaError_t launch_rows(int rows, const Grads<bf16>& p, cudaStream_t stream) {
  return rows == 16   ? launch_mma<DB, 1, KV>(p, stream)
         : rows == 32 ? launch_mma<DB, 2, KV>(p, stream)
                      : launch_mma<DB, 4, KV>(p, stream);
}

template <bool KV>
cudaError_t launch_bucket(int rows, int bucket, const Grads<float>& p,
                          cudaStream_t stream) {
  switch (bucket) {
    case 32:
      return rows == 16 ? launch<32, 1, KV>(p, stream)
                        : launch<32, 4, KV>(p, stream);
    case 64:
      return rows == 16 ? launch<64, 1, KV>(p, stream)
                        : launch<64, 4, KV>(p, stream);
    case 128:
      return rows == 16 ? launch<128, 1, KV>(p, stream)
                        : launch<128, 2, KV>(p, stream);
    default:
      return launch<256, 1, KV>(p, stream);
  }
}

template <bool KV>
cudaError_t launch_bucket(int rows, int bucket, const Grads<bf16>& p,
                          cudaStream_t stream) {
  switch (bucket) {
    case 32: return launch_rows<32, KV>(rows, p, stream);
    case 64: return launch_rows<64, KV>(rows, p, stream);
    case 128: return launch_rows<128, KV>(rows, p, stream);
    default: return launch_rows<256, KV>(rows, p, stream);
  }
}

// The instance for n_own owner rows (Tq for dQ, Tk for dK and dV) of head
// dim D in streams of elem_bytes-byte elements: the smallest head-dim
// bucket that holds D, the owner rows a block and the partner rows a tile.
// fp32 (the FMA body): 16 up to 16 owner rows, else 64 up to the 64
// bucket, 32 at 128 and 16 at 256; 32-row partner tiles. bf16 (the
// tensor-core kernel): 16, 32 or 64, the smallest that holds n_own (64 past
// it), a warp for each 16; partner tiles of mma_tile(bucket) rows.
void pick_backward(int n_own, int D, int elem_bytes, int* rows, int* bucket,
                   int* tile) {
  *bucket = D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
  if (elem_bytes == 4) {
    *rows = n_own <= 16 ? 16 : *bucket <= 64 ? 64 : *bucket == 128 ? 32 : 16;
    *tile = kTile;
  } else {
    *rows = n_own <= 16 ? 16 : n_own <= 32 ? 32 : 64;
    *tile = mma_tile(*bucket);
  }
}

template <bool KV, typename E>
int backward(const Grads<E>& p, void* stream) {
  if (p.B < 1 || p.Tq < 1 || p.Tk < 1 || p.H < 1 || p.D < 1 || p.D > kMaxD)
    return (int)cudaErrorInvalidValue;
  int rows, bucket, tile;
  pick_backward(KV ? p.Tk : p.Tq, p.D, (int)sizeof(E), &rows, &bucket, &tile);
  return (int)launch_bucket<KV>(rows, bucket, p, (cudaStream_t)stream);
}

template <typename E>
int run_dq(const E* q, const E* k, const E* v, const unsigned char* mask,
           const float* lse, const float* dr, const E* dout, E* dq, int B,
           int Tq, int Tk, int H, int D, float scale, void* stream) {
  const Grads<E> p{q,  k,  v, mask, lse, dr, dout, dq, nullptr, nullptr,
                   B,  Tq, Tk, H,   D,   scale};
  return backward<false>(p, stream);
}

template <typename E>
int run_dkv(const E* q, const E* k, const E* v, const unsigned char* mask,
            const float* lse, const float* dr, const E* dout, E* dk, E* dv,
            int B, int Tq, int Tk, int H, int D, float scale, void* stream) {
  const Grads<E> p{q,  k,  v, mask, lse, dr, dout, nullptr, dk, dv,
                   B,  Tq, Tk, H,   D,   scale};
  return backward<true>(p, stream);
}

}  // namespace

// `scale` is 1/sqrt(D), rounded to fp32 by the caller; lse is K7's, dr =
// rowsum(dout * out) in fp32. Each returns the CUDA error code of the
// launch (0 on success), does not synchronise and runs on `stream`.
extern "C" int masked_attention_backward_dq(
    const float* q, const float* k, const float* v, const unsigned char* mask,
    const float* lse, const float* dr, const float* dout, float* dq_out, int B,
    int Tq, int Tk, int H, int D, float scale, void* stream) {
  return run_dq(q, k, v, mask, lse, dr, dout, dq_out, B, Tq, Tk, H, D, scale,
            stream);
}

// The same with bf16 streams (q, k, v, dout and the gradients), on the
// tensor cores.
extern "C" int masked_attention_backward_dq_bf16(
    const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask,
    const float* lse, const float* dr, const bf16* dout, bf16* dq_out, int B,
    int Tq, int Tk, int H, int D, float scale, void* stream) {
  return run_dq(q, k, v, mask, lse, dr, dout, dq_out, B, Tq, Tk, H, D, scale,
            stream);
}

extern "C" int masked_attention_backward_dkv(
    const float* q, const float* k, const float* v, const unsigned char* mask,
    const float* lse, const float* dr, const float* dout, float* dk_out,
    float* dv_out, int B, int Tq, int Tk, int H, int D, float scale,
    void* stream) {
  return run_dkv(q, k, v, mask, lse, dr, dout, dk_out, dv_out, B, Tq, Tk, H, D,
             scale, stream);
}

extern "C" int masked_attention_backward_dkv_bf16(
    const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask,
    const float* lse, const float* dr, const bf16* dout, bf16* dk_out,
    bf16* dv_out, int B, int Tq, int Tk, int H, int D, float scale,
    void* stream) {
  return run_dkv(q, k, v, mask, lse, dr, dout, dk_out, dv_out, B, Tq, Tk, H, D,
             scale, stream);
}

// The instance a launch takes for n_own owner rows (Tq for dQ, Tk for dK
// and dV) of head dim D in streams of elem_bytes-byte elements (4: the fp32
// entry points, 2: their bf16 twins): owner rows a block, head-dim bucket
// and partner rows a tile, for the wrapper's tests.
extern "C" int masked_attention_backward_instance(int n_own, int D,
                                                  int elem_bytes, int* rows,
                                                  int* bucket, int* tile) {
  if (n_own < 1 || D < 1 || D > kMaxD || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  pick_backward(n_own, D, elem_bytes, rows, bucket, tile);
  return 0;
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* masked_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
