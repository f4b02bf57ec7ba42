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
// bf16 streams follow the library backward's rounding points: the scores
// and dP are fp32 sums of the bf16 operands, the score scaled after the dot,
// P and dS (scaled) fp32, then P rounded to bf16 before P^T.dO and dS
// rounded to bf16 before dS.K and dS^T.Q, every sum fp32, each gradient
// rounded to bf16 once. fp32 streams round nowhere.
//
// What bounds it on this card. K8 does 6 and K9 8 flops a (query, valid
// key) pair a channel (three and four products). At the VidOR train step's
// S/O cross-attention (B*H = 48*8, 512 x 512, d = 64, every key valid) that
// is 39 and 52 GFLOP, 0.58 and 0.77 ms on the fp32 FMA pipes (67 TFLOP/s),
// against 0.08 and 0.09 ms for their bytes: the operations bound both
// kernels in fp32. In bf16
// the operations' rate is the tensor cores' (989 TFLOP/s), and these
// kernels do not use them: they run the fp32 body on widened operands, on
// the FMA pipes. A tensor-core (mma.sync or wgmma) instance is later work.
//
// The design, one body for both kernels (masked_attention_bwd_kernel<..,
// KV>): a block owns kRows rows of one (batch, head) -- query rows for K8,
// key rows for K9 -- and walks the partner rows (keys for K8, queries for
// K9) in tiles of 32.
// - The owner tile's two streams (K8: Q and dO; K9: K and V) are read once
//   into shared memory as fp32, zero past the rows, past d and (K9) at an
//   invalid key. The partner tile's two streams (K8: K and V; K9: Q and dO)
//   come in with cp.async, 16 bytes a thread, double-buffered, in the
//   element type, zero past the rows, past d and (K8) at an invalid key.
//   K8 skips a key tile with no valid key before its copy, as K7 does; a K9
//   block whose owner keys are all invalid writes zeros and stops.
// - Register micro-tiles as in K7's fp32 body: each of the 128 threads owns
//   TM owner rows x 4 partners of the 32-partner tile, and takes s and dP
//   for them at once, from TM owner and 4 partner 4-channel loads of each
//   stream a step (2 x 16 TM FMAs).
// - P (K9) and dS go to shared memory partner-major, rounded to the element
//   type, and the tile's products accumulate into TM owner rows x d/8
//   channels a thread: dQ += dS.K (K8); dK += dS^T.Q and dV += P^T.dO (K9).
// - kRows = 16 TM: 64 rows (TM 4) up to d = 64, 32 at the 128 bucket and 16
//   at 256, which keeps K9's two accumulators at 64 registers a thread and
//   the tiles within shared memory; 16 wherever there are at most 16 owner
//   rows (the predictor's 9 queries in K8, 9 keys in K9). The rule is
//   pick_backward, which ops/full_attention.py::backward_instance reports.
// - d % (16 / element size) != 0 or a stream that is not 16-byte aligned:
//   the same body with element-wise copies.

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
using warp_mma::cp_async_commit;
using warp_mma::cp_async_wait;

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

// Shared-memory tiles of an instance (K9 with KV) whose streams are E.
template <int DB, int TM, typename E, bool KV>
struct BwdTiles {
  static constexpr int kRows = 16 * TM;  // 4 warps x 4 row groups x TM
  static constexpr int kAS = DB + 4;     // owner row stride (floats)
  // partner row stride (elements): 16 bytes past the row, so rows stay
  // 16-byte aligned for cp.async and a quarter-warp's loads hit distinct
  // banks
  static constexpr int kBS = DB + 16 / (int)sizeof(E);
  static constexpr int kPS = kRows + 4;  // P / dS row stride (floats)
  static constexpr int kA = kRows * kAS;
  static constexpr int kB = kTile * kBS;
  static constexpr int kP = kTile * kPS;
  static constexpr int kNP = KV ? 2 : 1;  // P and dS (K9), dS (K8)
  // owner streams, P / dS, 2 stages of the partners' lse and Dr (K9), then
  // 2 stages of each partner stream
  static constexpr size_t kBytes =
      sizeof(float) * (2 * kA + kNP * kP + 4 * kTile) + sizeof(E) * 4 * kB;
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

// kRows owner rows first .. of src (row stride C past base) into dst as
// fp32 at stride DB + 4; rows at or past `end`, with a mask rows whose byte
// is 0, and channels past D are 0.
template <int DB, int kRows, typename E>
__device__ __forceinline__ void load_owner(float* dst, const E* src,
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
                             ? element::to_f32(src[base + (size_t)j * C + c])
                             : 0.f;
    }
  }
}

// One partner tile, rows j0 .. j0 + kTile - 1 of src1 and src2, into d1 and
// d2 (stride DB + 16 / sizeof(E)); rows at or past `end`, with a mask rows
// whose byte is 0, and channels past D are 0.
template <int DB, typename E>
__device__ __forceinline__ void load_partners(E* d1, E* d2, const E* src1,
                                              const E* src2, size_t base,
                                              int j0, int end,
                                              const unsigned char* mrow,
                                              int C, int D, bool vec) {
  constexpr int kBS = DB + 16 / (int)sizeof(E);
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(E);  // elements a 16-byte copy
    constexpr int kChunks = DB / kPer;         // copies a row
#pragma unroll
    for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int n = idx / kChunks;
      const int c = kPer * (idx - n * kChunks);
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
      d1[n * kBS + c] = live ? src1[off] : element::from_f32<E>(0.f);
      d2[n * kBS + c] = live ? src2[off] : element::from_f32<E>(0.f);
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

template <int DB, int TM, typename E, bool KV>
__global__ void __launch_bounds__(kThreads)
masked_attention_bwd_kernel(const Grads<E> p, int row_tiles, bool vec) {
  using T = BwdTiles<DB, TM, E, KV>;
  extern __shared__ __align__(16) float smem[];
  float* a1 = smem;                    // K8: Q; K9: K (kRows x kAS, fp32)
  float* a2 = a1 + T::kA;              // K8: dO; K9: V
  float* ps = a2 + T::kA;              // K9: P (kTile x kPS, partner-major)
  float* dss = ps + (KV ? T::kP : 0);  // dS, partner-major
  float* stats = ps + T::kNP * T::kP;  // K9: 2 x (lse, Dr) of kTile queries
  E* b1s = reinterpret_cast<E*>(stats + 4 * kTile);  // 2 stages, K8: K; K9: Q
  E* b2s = b1s + 2 * T::kB;                          // K8: V; K9: dO

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
          p.dk[off] = element::from_f32<E>(0.f);
          p.dv[off] = element::from_f32<E>(0.f);
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
    const E* b1 = b1s + stage * T::kB;
    const E* b2 = b2s + stage * T::kB;

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

    // P = exp(s * scale - lse) at valid pairs, dS = P (dP - Dr) scale, each
    // stored rounded to E
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
        dss[n * T::kPS + pslot + i] = element::round_to<E>(dsij);
        if constexpr (KV)
          ps[n * T::kPS + pslot + i] = element::round_to<E>(pij);
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

  // each gradient rounded to E once; an invalid owner key's are 0
  E* g1 = KV ? p.dk : p.dq;
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
            g1[off + e] = element::from_f32<E>(y[e]);
            if constexpr (KV) p.dv[off + e] = element::from_f32<E>(z[e]);
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launches.

// TM (owner rows a block / 16) and head-dim bucket for n_own owner rows of
// head dim D: 1 up to 16 owner rows, else 4 up to the 64 bucket, 2 at 128
// and 1 at 256.
void pick_backward(int n_own, int D, int* tm, int* bucket) {
  *bucket = D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
  *tm = n_own <= 16 ? 1 : *bucket <= 64 ? 4 : *bucket == 128 ? 2 : 1;
}

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

template <int DB, int TM, typename E, bool KV>
cudaError_t launch(const Grads<E>& p, cudaStream_t stream) {
  using T = BwdTiles<DB, TM, E, KV>;
  auto kernel = masked_attention_bwd_kernel<DB, TM, E, KV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int n_own = KV ? p.Tk : p.Tq;
  const int row_tiles = (n_own + T::kRows - 1) / T::kRows;
  const long long blocks = (long long)p.B * p.H * row_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kThreads, T::kBytes, stream>>>(p, row_tiles,
                                                            vector_copies(p));
  return cudaGetLastError();
}

template <bool KV, typename E>
int backward(const Grads<E>& p, void* stream) {
  if (p.B < 1 || p.Tq < 1 || p.Tk < 1 || p.H < 1 || p.D < 1 || p.D > kMaxD)
    return (int)cudaErrorInvalidValue;
  int tm, bucket;
  pick_backward(KV ? p.Tk : p.Tq, p.D, &tm, &bucket);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bucket) {
    case 32:
      return (int)(tm == 1 ? launch<32, 1, E, KV>(p, s)
                           : launch<32, 4, E, KV>(p, s));
    case 64:
      return (int)(tm == 1 ? launch<64, 1, E, KV>(p, s)
                           : launch<64, 4, E, KV>(p, s));
    case 128:
      return (int)(tm == 1 ? launch<128, 1, E, KV>(p, s)
                           : launch<128, 2, E, KV>(p, s));
    default:
      return (int)launch<256, 1, E, KV>(p, s);
  }
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
// and dV) of head dim D: owner rows a block and head-dim bucket, for the
// wrapper's tests.
extern "C" int masked_attention_backward_instance(int n_own, int D,
                                                  int* rows, int* bucket) {
  if (n_own < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  int tm;
  pick_backward(n_own, D, &tm, bucket);
  *rows = 16 * tm;
  return 0;
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* masked_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
