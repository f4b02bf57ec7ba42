// Key-masked full attention forward for Hopper (sm_90a), fp32 and bf16,
// with each row's log-sum-exp on request (the input of the backward, K8 and
// K9 in masked_attention_bwd.cu).
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
// Two kernels share the problem, the cp.async helpers and the launch:
// masked_attention_fwd_kernel for fp32 streams (the FMA pipes; its element
// type parameter now only ever float) and masked_attention_mma_kernel for
// bf16 streams (the tensor cores).
//
// fp32: what bounds it on this card. The inputs are fp32 and TF32 is off (the
// parity setting), so there are no tensor cores to use and the 4*Tq*Tk*d
// flops of a (batch, head) run on the fp32 FMA pipes (67 TFLOP/s). At the
// eval forward's 96x96, d=128, B*H=128*4 the least time is set by the bytes
// (q, k, v read once, out written once: 100 MB, 0.030 ms); at 384x384 and
// above, and at VidOR's 512x512, d=64, by the operations. Short of either
// bound, a kernel of this kind is held back by shared-memory bandwidth (the
// one-key-a-lane design did one 4-byte shared load per FMA), by re-reading K
// and V from L2 once per block, and by latency at the few warps an SM that
// the tiles' shared memory leaves room for.
//
// The fp32 design:
// - A block owns kRows query rows of one (batch, head): 64, or 48 where
//   that pads strictly fewer rows (Tq = 96 takes two full 48-row tiles
//   where 64 rows would leave the second half empty), and 16 for Tq <= 16
//   (the predictor's 9 queries). It walks the keys in tiles of kTile = 32, and
//   each K/V tile is read from device memory once for all its rows. The
//   query tile is copied once, scaled in place, and stays in shared memory.
// - Register micro-tiles. Each of the 128 threads owns TM rows x 4 keys of
//   the scores (TM = kRows / 16): at each step of 4 channels it loads TM
//   query and 4 key float4s (16-byte loads) for 16*TM FMAs, 8 FMAs a shared
//   load at TM = 4. The 8 lanes of a row group (a warp holds 4) own all 32
//   keys of the tile, so the online softmax's row max and sum are 3-step
//   shuffles inside the warp; a thread's rows are 4 apart, so the 4 row
//   groups of a warp read 4 neighbouring query rows, in distinct banks. P
//   goes to shared memory, key-major, and P.V accumulates into TM rows x d/8
//   output channels a thread (64 registers at d = 128), from one P and d/32
//   V float4 loads a key. exp is the hardware's ex2 (__expf); every shape
//   the tests and chip_smoke.py take stays within 2e-5 of the plain version.
// - K/V tiles come in with cp.async, 16 bytes a thread, double-buffered: the
//   next tile's copy is issued before the current tile is computed. Keys
//   past Tk, invalid keys and channels past d are zero-filled by the copy
//   itself (src-size 0), so an invalid value never enters the sum. A tile
//   with no valid key is skipped before its copy and before any exp. When d
//   is not a multiple of 4 or a pointer is not 16-byte aligned, the same
//   kernel takes a scalar load path instead.
// - Shared-memory layout: Q and K rows at a stride of d + 4 floats and P rows
//   at kRows + 4, so the 8 lanes of a quarter-warp hit 32 distinct banks.
// - One template per head-dim bucket (32, 64, 128, 256; channels past d are
//   zero). At d = 128 and 64 rows a block takes 106.5 KB of shared memory
//   and 168 registers a thread: 2 blocks (8 warps) an SM.
// - What still holds it back (PERF.md): a warp's 16-byte shared load
//   delivers 512 bytes and seems to take 4 cycles of the SM's shared-memory
//   bandwidth however many lanes share an address, so at 8 FMAs a load the
//   score product takes about twice the cycles of its FMAs, and P.V (12.8
//   FMAs a load) more than its. Larger register tiles need more rows a
//   block, and their shared memory then leaves one block an SM: 128-row
//   blocks of 8 x 4 tiles were slower.
//
// bf16 (masked_attention_forward_bf16, the bf16 serving path): what bounds
// it. The bytes halve (q, k, v and out in bf16: 50 MB, 0.015 ms at 96x96,
// d=128, B*H=128*4) and the products run on the tensor cores at 989
// TFLOP/s, so the bytes bound every serving shape (512x512, d=64, B*H=16*8:
// 0.010 ms); only at the 768 eval bucket with most keys valid do the
// operations pass them (0.156 ms with every key valid, the bytes 0.120).
// The numbers follow JAX's dense form in bf16: the scores in fp32 from the
// bf16 operands, scaled in fp32 by 1/sqrt(d) (JAX scales q by a numpy
// float, which promotes; a bf16 q*scale would move every score by up to
// 2^-9 of its size), the softmax in fp32, and, as the Pallas flash kernels
// do, the unnormalised exp(s - m) rounded to bf16 before P.V while l sums
// the unrounded values; the output is rounded to bf16 once. The design,
// FlashAttention-2's forward on mma.sync:
// - A warp owns MT row tiles of 16 query rows, the m16 of
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, so every K and V
//   fragment it reads from shared memory serves MT tiles. A block holds
//   the fp32 rule's rows (16, 48 or 64: 1, 3 or 4 warps of one tile) up to
//   Tq = 64 and at d = 256, else 96 or 128 rows (3 or 4 warps of two
//   tiles), whichever pads fewer. The query tile is copied once, bf16 and
//   unscaled; while its A fragments take at most 32 registers (one tile
//   up to d = 128, two up to d = 64) a warp keeps them, else it reads them
//   again from shared memory for every key tile.
// - Keys come in tiles of 32, copied as in fp32 (cp.async, 16 bytes,
//   double-buffered, zero-filled past Tk, at invalid keys and past d; a
//   tile with no valid key is skipped before its copy). Zero-filled values
//   are needed, not only tidy: P is 0 at an invalid key, but 0 * NaN is NaN
//   in the tensor core too. Q, K and V rows sit at a stride of d + 8 bf16,
//   so the 8 row addresses of an ldmatrix fall in distinct banks. The
//   block reads the key mask once into shared memory as bits (a window of
//   4096 keys, read again only past it), so the tile walk, the copies and
//   the softmax take a tile's valid keys from one word instead of from
//   device memory.
// - S = Q.K^T on the tensor cores: K's B fragments are ldmatrix'ed without
//   a transpose (a K row is contiguous along the reduction). The fp32
//   accumulators are scaled by log2(e)/sqrt(d), invalid columns set to
//   -inf, and the online softmax runs on ex2 in registers: in the
//   accumulator layout a row's columns sit on the 4 lanes of a quad, so its
//   max is 2 shuffles; l is summed a lane at a time and reduced once at
//   the end.
// - P stays in registers: two adjacent n8 accumulator tiles, rounded with
//   cvt.rn.bf16x2.f32, are the A fragment of one k16 step of P.V. V's B
//   fragments load with ldmatrix.x4.trans (V is key-major); O accumulates
//   in fp32 registers, MT * d/2 a lane.
// - The epilogue scales O by 1/l (0 where l = 0), rounds once to bf16,
//   stages the warp's rows in its own rows of the query tile and writes
//   them out in 16-byte stores; rows past Tq are not written.
// - d % 8 != 0 or a stream that is not 16-byte aligned: the same body, its
//   tiles copied with 2-byte loads. Channels past d are zero, so every
//   head-dim bucket (32, 64, 128, 256) is whole k16 steps.
// - At d = 128 and 128 rows a block takes 69.6 KB of shared memory and 254
//   registers a thread with no spills: 2 blocks (8 warps) an SM. What it
//   leaves on the table: one barrier and one burst of copies a 32-key tile
//   (mma.sync, not wgmma and TMA: at 96 and 512 keys a (batch, head) has
//   too little work for a warpgroup pipeline to pay back).

// Layout: q and out are (B, Tq, H*d), k and v (B, Tk, H*d), contiguous, all
// four fp32 or all four bf16 (the _bf16 entry point), heads
// split head-major along the channels as the JAX package's _split_heads lays
// them out. mask is (B, Tk) bool (one byte each). Takes any Tq and Tk and
// 1 <= d <= 256; the Python wrapper rejects anything else before the launch.
// The instance (rows a block, head-dim bucket) is chosen by pick_instance,
// the rule of vrdone_tpu_torch/ops/full_attention.py::_variant.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "element.cuh"
#include "warp_mma.cuh"

namespace {

using element::bf16;
using warp_mma::cp_async16;
using warp_mma::cp_async_commit;
using warp_mma::cp_async_wait;
using warp_mma::ex2;
using warp_mma::ldmatrix_x4;
using warp_mma::ldmatrix_x4_trans;
using warp_mma::mma_bf16;

constexpr int kThreads = 128;  // 4 warps, each 4 row groups of 8 lanes
constexpr int kTile = 32;      // keys a tile: 8 lanes x 4 keys
constexpr int kMaxD = 256;

// Shared-memory tiles of an instance whose K/V elements are E; the query
// tile and P are fp32 in both.
template <int DB, int TM, typename E>
struct Tiles {
  static constexpr int kRows = 16 * TM;  // 4 warps x 4 row groups x TM
  static constexpr int kQS = DB + 4;     // Q row stride (floats)
  // K row stride (elements): 16 bytes past the row, so rows stay 16-byte
  // aligned for cp.async and a quarter-warp's K loads hit distinct banks
  static constexpr int kKS = DB + 16 / (int)sizeof(E);
  static constexpr int kPS = kRows + 4;  // P row stride (floats)
  static constexpr int kQ = kRows * kQS;
  static constexpr int kK = kTile * kKS;
  static constexpr int kV = kTile * DB;
  static constexpr int kP = kTile * kPS;
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + kP) + sizeof(E) * (2 * kK + 2 * kV);
};

// The first tile at or after t that holds a valid key (n_tiles if none).
// Block-uniform; every test is a barrier, and there is at least one.
__device__ __forceinline__ int next_tile(const unsigned char* mrow, int t,
                                         int n_tiles, int Tk) {
  for (;; ++t) {
    const int j = t * kTile + (threadIdx.x & (kTile - 1));
    if (__syncthreads_or(t < n_tiles && j < Tk && mrow[j]) || t >= n_tiles)
      return t;
  }
}

// The problem a launch solves (the kernels' one argument), its streams of
// element type E.
template <typename E>
struct Problem {
  const E* q;
  const E* k;
  const E* v;
  const unsigned char* mask;
  E* out;
  float* lse;  // (B, H, Tq) fp32, or null
  int B, Tq, Tk, H, D;
  float scale;
};

// One K/V tile of keys j0 .. j0 + kTile - 1 into ks (stride kKS) and vs
// (stride DB); keys past Tk, invalid keys and channels past D are 0.
template <int DB, typename E>
__device__ __forceinline__ void load_kv(E* ks, E* vs, const Problem<E> p,
                                        const unsigned char* mrow,
                                        size_t kbase, int j0, bool vec) {
  constexpr int kKS = DB + 16 / (int)sizeof(E);
  const int C = p.H * p.D;
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(E);  // elements a 16-byte copy
    constexpr int kChunks = DB / kPer;         // copies a row
#pragma unroll
    for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int n = idx / kChunks;
      const int c = kPer * (idx - n * kChunks);
      const int j = j0 + n;
      const bool live = j < p.Tk && c < p.D && mrow[j];
      const size_t off = live ? kbase + (size_t)j * C + c : 0;
      cp_async16(ks + n * kKS + c, p.k + off, live);
      cp_async16(vs + n * DB + c, p.v + off, live);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kTile * DB / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int n = idx / DB;
      const int c = idx - n * DB;
      const int j = j0 + n;
      const bool live = j < p.Tk && c < p.D && mrow[j];
      const size_t off = kbase + (size_t)j * C + c;
      ks[n * kKS + c] = live ? p.k[off] : element::from_f32<E>(0.f);
      vs[n * DB + c] = live ? p.v[off] : element::from_f32<E>(0.f);
    }
  }
}

template <int DB, int TM, typename E>
__global__ void __launch_bounds__(kThreads)
masked_attention_fwd_kernel(const Problem<E> p, int row_tiles, bool vec) {
  using T = Tiles<DB, TM, E>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                 // kRows x kQS, scaled
  E* ks = reinterpret_cast<E*>(qs + T::kQ);         // 2 stages, kTile x kKS
  E* vs = ks + 2 * T::kK;                           // 2 stages, kTile x DB
  float* ps = reinterpret_cast<float*>(vs + 2 * T::kV);  // kTile x kPS,
                                                         // key-major

  const int bh = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x - bh * row_tiles) * T::kRows;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int Tq = p.Tq, Tk = p.Tk, D = p.D, C = p.H * p.D;
  const size_t qbase = (size_t)b * Tq * C + (size_t)h * D;
  const size_t kbase = (size_t)b * Tk * C + (size_t)h * D;
  const unsigned char* mrow = p.mask + (size_t)b * Tk;
  const int n_tiles = (Tk + kTile - 1) / kTile;

  // the query tile and the first K/V tile are copied together; an fp32
  // query tile is scaled in place once it has landed, a bf16 one is widened
  // and scaled on its way in
  constexpr bool kF32 = std::is_same_v<E, float>;
  if (vec && kF32) {
#pragma unroll
    for (int it = 0; it < T::kRows * DB / 4 / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int r = idx / (DB / 4);
      const int c = 4 * (idx - r * (DB / 4));
      const bool live = i0 + r < Tq && c < D;
      cp_async16(qs + r * T::kQS + c,
                 p.q + (live ? qbase + (size_t)(i0 + r) * C + c : 0), live);
    }
  } else if (vec) {
    for (int idx = threadIdx.x; idx < T::kRows * DB / 4; idx += kThreads) {
      const int r = idx / (DB / 4);
      const int c = 4 * (idx - r * (DB / 4));
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (i0 + r < Tq && c < D)
        element::load<4>(p.q + qbase + (size_t)(i0 + r) * C + c, x);
      *reinterpret_cast<float4*>(qs + r * T::kQS + c) = make_float4(
          x[0] * p.scale, x[1] * p.scale, x[2] * p.scale, x[3] * p.scale);
    }
  } else {
    for (int idx = threadIdx.x; idx < T::kRows * DB; idx += kThreads) {
      const int r = idx / DB;
      const int c = idx - r * DB;
      const int i = i0 + r;
      qs[r * T::kQS + c] =
          i < Tq && c < D
              ? element::to_f32(p.q[qbase + (size_t)i * C + c]) * p.scale
              : 0.f;
    }
  }
  cp_async_commit();
  int t = next_tile(mrow, 0, n_tiles, Tk);
  if (t < n_tiles) load_kv<DB>(ks, vs, p, mrow, kbase, t * kTile, vec);
  cp_async_commit();
  if (vec && kF32) {
    cp_async_wait<1>();  // this thread's part of the query tile
#pragma unroll
    for (int it = 0; it < T::kRows * DB / 4 / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int r = idx / (DB / 4);
      float4* x = reinterpret_cast<float4*>(
          qs + r * T::kQS + 4 * (idx - r * (DB / 4)));
      float4 y = *x;
      y.x *= p.scale;
      y.y *= p.scale;
      y.z *= p.scale;
      y.w *= p.scale;
      *x = y;
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // this thread's keys of a tile are col + 8 * jn, its rows of the block
  // row0 + 4 * i (so the 4 row groups of a warp read 4 neighbouring query
  // rows, in distinct banks); its P of a key sits at pslot + i
  const int col = lane & 7;
  const int row0 = warp * 4 * TM + (lane >> 3);
  const int pslot = warp * 4 * TM + (lane >> 3) * TM;

  float m[TM], l[TM], acc[TM][DB / 8];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DB / 8; ++c) acc[i][c] = 0.f;
  }

  int stage = 0;
  while (t < n_tiles) {
    // the barrier of next_tile tells both that this tile (and the query
    // tile) landed for every thread and that every thread is done with the
    // other stage, which the next copy overwrites while this tile is used
    cp_async_wait<0>();
    const int t_next = next_tile(mrow, t + 1, n_tiles, Tk);
    if (t_next < n_tiles)
      load_kv<DB>(ks + (stage ^ 1) * T::kK, vs + (stage ^ 1) * T::kV, p,
                  mrow, kbase, t_next * kTile, vec);
    cp_async_commit();
    const E* kt = ks + stage * T::kK;
    const E* vt = vs + stage * T::kV;
    const int j0 = t * kTile;

    float s[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) s[i][jn] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DB; c += 4) {
      float4 qv[TM];
      float kv[4][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qs + (row0 + 4 * i) * T::kQS + c);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        element::load<4>(kt + (col + 8 * jn) * T::kKS + c, kv[jn]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {
          float a = s[i][jn];
          a = fmaf(qv[i].x, kv[jn][0], a);
          a = fmaf(qv[i].y, kv[jn][1], a);
          a = fmaf(qv[i].z, kv[jn][2], a);
          a = fmaf(qv[i].w, kv[jn][3], a);
          s[i][jn] = a;
        }
    }

    // online softmax; the tile holds a valid key, so every row max is
    // finite. l sums exp(s - m) unrounded; P is stored rounded to E
    bool valid[4];
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      const int j = j0 + col + 8 * jn;
      valid[jn] = j < Tk && mrow[j];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
        if (valid[jn]) mx = fmaxf(mx, s[i][jn]);
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = __expf(m[i] - m_new);  // 0 while m is still -inf
      float psum = 0.f;
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        s[i][jn] = valid[jn] ? __expf(s[i][jn] - m_new) : 0.f;
        psum += s[i][jn];
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DB / 8; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int jn = 0; jn < 4; ++jn) {
      float* prow = ps + (col + 8 * jn) * T::kPS + pslot;
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4)
          *reinterpret_cast<float4*>(prow + i) = make_float4(
              element::round_to<E>(s[i][jn]),
              element::round_to<E>(s[i + 1][jn]),
              element::round_to<E>(s[i + 2][jn]),
              element::round_to<E>(s[i + 3][jn]));
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) prow[i] = element::round_to<E>(s[i][jn]);
      }
    }
    __syncthreads();  // P of the whole tile is in shared memory

    const E* vcol = vt + 4 * col;
#pragma unroll 4
    for (int n = 0; n < kTile; ++n) {
      float pn[TM];
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(ps + n * T::kPS + pslot + i);
          pn[i] = p4.x;
          pn[i + 1] = p4.y;
          pn[i + 2] = p4.z;
          pn[i + 3] = p4.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TM; ++i) pn[i] = ps[n * T::kPS + pslot + i];
      }
#pragma unroll
      for (int jc = 0; jc < DB / 32; ++jc) {
        float x[4];
        element::load<4>(vcol + n * DB + 32 * jc, x);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][4 * jc + 0] = fmaf(pn[i], x[0], acc[i][4 * jc + 0]);
          acc[i][4 * jc + 1] = fmaf(pn[i], x[1], acc[i][4 * jc + 1]);
          acc[i][4 * jc + 2] = fmaf(pn[i], x[2], acc[i][4 * jc + 2]);
          acc[i][4 * jc + 3] = fmaf(pn[i], x[3], acc[i][4 * jc + 3]);
        }
      }
    }
    t = t_next;
    stage ^= 1;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = i0 + row0 + 4 * i;
    if (row >= Tq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    if (p.lse != nullptr && col == 0)
      p.lse[(size_t)bh * Tq + row] =
          l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    E* orow = p.out + qbase + (size_t)row * C;
#pragma unroll
    for (int jc = 0; jc < DB / 32; ++jc) {
      const int c = 4 * col + 32 * jc;
      const float y[4] = {acc[i][4 * jc] * inv, acc[i][4 * jc + 1] * inv,
                          acc[i][4 * jc + 2] * inv, acc[i][4 * jc + 3] * inv};
      if (vec) {
        if (c < D) element::store<4>(orow + c, y);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (c + x < D) orow[c + x] = element::from_f32<E>(y[x]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 kernel, on the tensor cores.

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DB, int W, int MT>
struct MmaTiles {
  static constexpr int kThreads = 32 * W;  // a warp for MT x 16 query rows
  static constexpr int kRows = 16 * MT * W;
  // row stride of the Q, K and V tiles (bf16): 16 bytes past the row, so
  // rows stay 16-byte aligned and an ldmatrix's 8 rows hit distinct banks
  static constexpr int kS = DB + 8;
  static constexpr int kQ = kRows * kS;
  static constexpr int kKV = kTile * kS;  // one K or V tile
  static constexpr size_t kBytes = sizeof(bf16) * (kQ + 4 * kKV);
};

// ROWS rows of a tile (DB channels at stride kS) from the stream's rows
// first .. first + ROWS - 1 (row stride C past base), copied by kT threads;
// a row at or past `end`, with kMask a row r whose bit in `rows` is clear
// (ROWS <= 32), and channels past D are 0. 16-byte cp.async copies (vec)
// or 2-byte loads.
template <int ROWS, int DB, int kS, int kT, bool kMask>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           size_t base, int first, int end,
                                           uint32_t rows, int C, int D,
                                           bool vec) {
  static_assert(!kMask || ROWS <= 32, "one mask bit a row");
  if (vec) {
    constexpr int kChunks = DB / 8;  // 8 bf16 a copy
    constexpr int kN = ROWS * kChunks;
#pragma unroll
    for (int it = 0; it < (kN + kT - 1) / kT; ++it) {
      const int idx = threadIdx.x + it * kT;
      if (idx >= kN) break;
      const int r = idx / kChunks;
      const int c = 8 * (idx - r * kChunks);
      const int j = first + r;
      const bool live = j < end && c < D && (!kMask || (rows >> r) & 1u);
      cp_async16(dst + r * kS + c,
                 src + (live ? base + (size_t)j * C + c : 0), live);
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < ROWS * DB; idx += kT) {
      const int r = idx / DB;
      const int c = idx - r * DB;
      const int j = first + r;
      const bool live = j < end && c < D && (!kMask || (rows >> r) & 1u);
      dst[r * kS + c] = live ? src[base + (size_t)j * C + c]
                             : element::from_f32<bf16>(0.f);
    }
  }
}

// Keys a block's window of valid-key bits holds: every serving and eval
// shape takes one window, read once a block.
constexpr int kWindow = 4096;

// The valid-key bits of keys key0 .. key0 + kWindow - 1 into win (one bit
// a key; 0 past Tk up to the end of the last tile), read by kT threads,
// then a barrier. Block-uniform; nobody may read win meanwhile.
template <int kT>
__device__ __forceinline__ void load_window(uint32_t* win,
                                            const unsigned char* mrow,
                                            int key0, int Tk) {
  const int n = min(kWindow, (Tk - key0 + kTile - 1) / kTile * kTile);
  for (int k0 = 0; k0 < n; k0 += kT) {
    const int k = k0 + threadIdx.x;
    const uint32_t word =
        __ballot_sync(0xffffffffu, k < n && key0 + k < Tk && mrow[key0 + k]);
    if ((threadIdx.x & 31) == 0 && k < n) win[k >> 5] = word;
  }
  __syncthreads();
}

// The first tile at or after t that holds a valid key (n_tiles if none),
// moving the window (key0) on where the tile lies past it. Block-uniform.
template <int kT>
__device__ __forceinline__ int next_valid_tile(uint32_t* win, int& key0,
                                               const unsigned char* mrow,
                                               int t, int n_tiles, int Tk) {
  for (; t < n_tiles; ++t) {
    if ((t + 1) * kTile > key0 + kWindow) {
      key0 = t * kTile;
      load_window<kT>(win, mrow, key0, Tk);
    }
    if (win[(t * kTile - key0) / 32]) return t;
  }
  return n_tiles;
}

template <int DB, int W, int MT>
__global__ void __launch_bounds__(32 * W)
masked_attention_mma_kernel(const Problem<bf16> p, int row_tiles, bool vec) {
  using T = MmaTiles<DB, W, MT>;
  constexpr int kS = T::kS, kT = T::kThreads;
  constexpr int kSteps = DB / 16;  // k16 steps of Q.K^T
  constexpr int kNT = kTile / 8;   // n8 key tiles of S
  constexpr int kOT = DB / 8;      // n8 channel tiles of O
  // the query's A fragments stay in registers while they take at most 32
  constexpr bool kQRegs = MT * DB <= 128;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // kRows x kS, unscaled
  bf16* ks = qs + T::kQ;                         // 2 stages, kTile x kS
  bf16* vs = ks + 2 * T::kKV;                    // 2 stages, kTile x kS
  __shared__ uint32_t win[kWindow / 32];  // valid keys from key0, a bit each

  const int bh = blockIdx.x / row_tiles;
  const int i0 = (blockIdx.x - bh * row_tiles) * T::kRows;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int Tq = p.Tq, Tk = p.Tk, D = p.D, C = p.H * p.D;
  const size_t qbase = (size_t)b * Tq * C + (size_t)h * D;
  const size_t kbase = (size_t)b * Tk * C + (size_t)h * D;
  const unsigned char* mrow = p.mask + (size_t)b * Tk;
  const int n_tiles = (Tk + kTile - 1) / kTile;

  // the query tile and the first K/V tile are copied together
  stage_tile<T::kRows, DB, kS, kT, false>(qs, p.q, qbase, i0, Tq, 0, C, D,
                                          vec);
  cp_async_commit();
  int key0 = 0;
  load_window<kT>(win, mrow, key0, Tk);
  int t = next_valid_tile<kT>(win, key0, mrow, 0, n_tiles, Tk);
  if (t < n_tiles) {
    const uint32_t keys = win[(t * kTile - key0) / 32];
    stage_tile<kTile, DB, kS, kT, true>(ks, p.k, kbase, t * kTile, Tk, keys,
                                        C, D, vec);
    stage_tile<kTile, DB, kS, kT, true>(vs, p.v, kbase, t * kTile, Tk, keys,
                                        C, D, vec);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bf16* qw = qs + warp * 16 * MT * kS;  // this warp's MT x 16 query rows
  const bool live_rows = i0 + warp * 16 * MT < Tq;  // warp-uniform
  // the rows this lane points at in an ldmatrix.x4: Q's A fragment of one
  // k16 step of m16 tile 0 (row lane % 16, channels from (lane / 16) * 8);
  // K's B fragments of two k16 steps of one n8 key tile (key lane % 8,
  // channels from (lane / 8) * 8); V's, transposed, of one k16 key step
  // for two n8 channel tiles (key lane % 16, channels from (lane / 16) * 8)
  const bf16* qa = qw + (lane & 15) * kS + (lane >> 4) * 8;
  const int koff = (lane & 7) * kS + (lane >> 3) * 8;
  const int voff = (lane & 15) * kS + (lane >> 4) * 8;
  // scores go to the log2 domain in fp32: ex2(s * scale * log2 e - m)
  const float sl2 = p.scale * kLog2e;

  uint32_t qf[kQRegs ? MT : 1][kQRegs ? kSteps : 1][4];
  float o[MT][kOT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ot = 0; ot < kOT; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][ot][e] = 0.f;
  // rows 16 mt + lane / 4 and 16 mt + lane / 4 + 8 of the warp's: the
  // running max (log2 domain) and this lane's part of the sum
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = 0.f;
    }
  bool first = true;

  int stage = 0;
  while (t < n_tiles) {
    // this tile's valid keys, read before the barrier below, after which
    // the window may move on
    const uint32_t valid = win[(t * kTile - key0) / 32];
    // the barrier tells both that this tile (and the query tile) landed
    // for every thread and that every warp is done with the other stage,
    // which the next copy overwrites while this tile is used
    cp_async_wait<0>();
    __syncthreads();
    const int t_next =
        next_valid_tile<kT>(win, key0, mrow, t + 1, n_tiles, Tk);
    if (t_next < n_tiles) {
      const uint32_t keys = win[(t_next * kTile - key0) / 32];
      stage_tile<kTile, DB, kS, kT, true>(ks + (stage ^ 1) * T::kKV, p.k,
                                          kbase, t_next * kTile, Tk, keys, C,
                                          D, vec);
      stage_tile<kTile, DB, kS, kT, true>(vs + (stage ^ 1) * T::kKV, p.v,
                                          kbase, t_next * kTile, Tk, keys, C,
                                          D, vec);
    }
    cp_async_commit();
    if (live_rows) {
      const bf16* kt = ks + stage * T::kKV;
      const bf16* vt = vs + stage * T::kKV;
      if constexpr (kQRegs) {
        if (first) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int kk = 0; kk < kSteps; ++kk)
              ldmatrix_x4(qf[mt][kk], qa + 16 * (mt * kS + kk));
        }
      }

      // S = Q.K^T: each K fragment serves the warp's MT row tiles
      float s[MT][kNT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][jn][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; kk += 2) {
        uint32_t a[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int k2 = 0; k2 < 2; ++k2) {
            if constexpr (kQRegs) {
#pragma unroll
              for (int x = 0; x < 4; ++x) a[mt][k2][x] = qf[mt][kk + k2][x];
            } else {
              ldmatrix_x4(a[mt][k2], qa + 16 * (mt * kS + kk + k2));
            }
          }
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kt + 8 * jn * kS + koff + 16 * kk);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][jn], a[mt][0], kf[0], kf[1]);
            mma_bf16(s[mt][jn], a[mt][1], kf[2], kf[3]);
          }
        }
      }

      // online softmax: s[mt][jn][e] is row 16 mt + lane / 4 + 8 (e / 2),
      // key 8 jn + 2 (lane % 4) + e % 2 of the tile; a row's keys sit on the
      // 4 lanes of a quad. The tile holds a valid key, so every max is
      // finite
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int bit = 8 * jn + 2 * (lane & 3) + (e & 1);
            s[mt][jn][e] =
                (valid >> bit) & 1u ? s[mt][jn][e] * sl2 : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[mt][jn][e]);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float alpha = ex2(m[mt][r] - mx[r]);  // 0 while m is -inf
          m[mt][r] = mx[r];
          l[mt][r] *= alpha;
#pragma unroll
          for (int ot = 0; ot < kOT; ++ot) {
            o[mt][ot][2 * r] *= alpha;
            o[mt][ot][2 * r + 1] *= alpha;
          }
        }
#pragma unroll
        for (int jn = 0; jn < kNT; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][jn][e] = ex2(s[mt][jn][e] - m[mt][e >> 1]);
            l[mt][e >> 1] += s[mt][jn][e];
          }
      }

      // O += P.V with P rounded to bf16 in registers: the accumulators of
      // n8 key tiles 2 kk and 2 kk + 1 are the A fragment of k16 step kk;
      // each V fragment serves the warp's MT row tiles
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = element::pack2(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = element::pack2(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] =
              element::pack2(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] =
              element::pack2(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int ot = 0; ot < kOT; ot += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vt + 16 * kk * kS + voff + 8 * ot);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(o[mt][ot], pa[mt], vf[0], vf[1]);
            mma_bf16(o[mt][ot + 1], pa[mt], vf[2], vf[3]);
          }
        }
      }
      first = false;
    }
    t = t_next;
    stage ^= 1;
  }

  // every copy into the query tile has landed (with no valid key the loop
  // never waited), and the warps overwrite only their own rows below
  cp_async_wait<0>();
  __syncthreads();
  if (!live_rows) return;
  // O / l, rounded once to bf16, staged in the warp's own query rows and
  // written out a row at a time
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      const int row = i0 + warp * 16 * MT + 16 * mt + (lane >> 2) + 8 * r;
      if (p.lse != nullptr && (lane & 3) == 0 && row < Tq)
        p.lse[(size_t)bh * Tq + row] =
            sum > 0.f ? m[mt][r] * kLn2 + logf(sum) : INFINITY;
      uint32_t* orow = reinterpret_cast<uint32_t*>(
          qw + (16 * mt + (lane >> 2) + 8 * r) * kS + 2 * (lane & 3));
#pragma unroll
      for (int ot = 0; ot < kOT; ++ot)
        orow[4 * ot] = element::pack2(o[mt][ot][2 * r] * inv,
                                      o[mt][ot][2 * r + 1] * inv);
    }
  __syncwarp();
  constexpr int kWarpRows = 16 * MT;
  const int r0 = i0 + warp * kWarpRows;
  bf16* out = p.out + qbase;
  if (vec) {
    constexpr int kChunks = DB / 8;
#pragma unroll
    for (int it = 0; it < kWarpRows * kChunks / 32; ++it) {
      const int idx = lane + 32 * it;
      const int r = idx / kChunks;
      const int c = 8 * (idx - r * kChunks);
      if (r0 + r < Tq && c < D)
        *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * C + c) =
            *reinterpret_cast<const uint4*>(qw + r * kS + c);
    }
  } else {
    for (int idx = lane; idx < kWarpRows * DB; idx += 32) {
      const int r = idx / DB;
      const int c = idx - r * DB;
      if (r0 + r < Tq && c < D) out[(size_t)(r0 + r) * C + c] = qw[r * kS + c];
    }
  }
}

// ---------------------------------------------------------------------------
// Launches.

// Whether every stream can be copied in 16-byte chunks (4 fp32 or 8 bf16
// channels each): d a multiple of that and every pointer 16-byte aligned.
template <typename E>
bool vector_copies(const Problem<E>& p) {
  return p.D % (16 / (int)sizeof(E)) == 0 &&
         ((reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
           reinterpret_cast<uintptr_t>(p.v) |
           reinterpret_cast<uintptr_t>(p.out)) & 15) == 0;
}

// One block of `threads` for each `rows` query rows of a (batch, head).
template <typename E>
cudaError_t start(void (*kernel)(Problem<E>, int, bool), int rows,
                  int threads, size_t bytes, const Problem<E>& p,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int row_tiles = (p.Tq + rows - 1) / rows;
  const long long blocks = (long long)p.B * p.H * row_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, threads, bytes, stream>>>(p, row_tiles,
                                                       vector_copies(p));
  return cudaGetLastError();
}

// The fp32 instance of R * 16 rows a block (TM = R).
template <int DB, int R>
cudaError_t launch(const Problem<float>& p, cudaStream_t stream) {
  using T = Tiles<DB, R, float>;
  return start(masked_attention_fwd_kernel<DB, R, float>, T::kRows, kThreads,
               T::kBytes, p, stream);
}

template <int R>
cudaError_t launch_bucket(int bucket, const Problem<float>& p,
                          cudaStream_t stream) {
  switch (bucket) {
    case 32: return launch<32, R>(p, stream);
    case 64: return launch<64, R>(p, stream);
    case 128: return launch<128, R>(p, stream);
    default: return launch<256, R>(p, stream);
  }
}

// The bf16 instance of W warps of MT row tiles each.
template <int DB, int W, int MT>
cudaError_t launch_mma(const Problem<bf16>& p, cudaStream_t stream) {
  using T = MmaTiles<DB, W, MT>;
  return start(masked_attention_mma_kernel<DB, W, MT>, T::kRows, T::kThreads,
               T::kBytes, p, stream);
}

template <int DB>
cudaError_t launch_rows(int rows, const Problem<bf16>& p,
                        cudaStream_t stream) {
  if constexpr (DB <= 128) {  // 2 row tiles a warp spill at d = 256
    if (rows == 96) return launch_mma<DB, 3, 2>(p, stream);
    if (rows == 128) return launch_mma<DB, 4, 2>(p, stream);
  }
  return rows == 16   ? launch_mma<DB, 1, 1>(p, stream)
         : rows == 48 ? launch_mma<DB, 3, 1>(p, stream)
                      : launch_mma<DB, 4, 1>(p, stream);
}

cudaError_t launch_bf16(int rows, int bucket, const Problem<bf16>& p,
                        cudaStream_t stream) {
  switch (bucket) {
    case 32: return launch_rows<32>(rows, p, stream);
    case 64: return launch_rows<64>(rows, p, stream);
    case 128: return launch_rows<128>(rows, p, stream);
    default: return launch_rows<256>(rows, p, stream);
  }
}

// Query rows a block of the fp32 kernel: 16 up to Tq = 16, else 48 where
// that pads fewer rows than 64.
int fp32_rows(int Tq) {
  return Tq <= 16 ? 16 : (48 - Tq % 48) % 48 < (64 - Tq % 64) % 64 ? 48 : 64;
}

// The instance for Tq queries of head dim D in streams of elem_bytes-byte
// elements (ops/full_attention.py::_variant): rows a block and the smallest
// head-dim bucket that holds D. fp32 takes fp32_rows; bf16 too up to Tq =
// 64 and at the 256 bucket, else 96 or 128 rows (3 or 4 warps of 32 rows),
// whichever pads fewer (128 on a tie). The choice of vector or scalar
// copies is made at the launch.
void pick_instance(int Tq, int D, int elem_bytes, int* rows, int* bucket) {
  *bucket = D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
  *rows = elem_bytes == 4 || Tq <= 64 || *bucket == 256 ? fp32_rows(Tq)
          : (96 - Tq % 96) % 96 < (128 - Tq % 128) % 128 ? 96
                                                         : 128;
}

template <typename E>
int forward(const E* q, const E* k, const E* v, const unsigned char* mask,
            E* out, float* lse, int B, int Tq, int Tk, int H, int D,
            float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  int rows, bucket;
  pick_instance(Tq, D, (int)sizeof(E), &rows, &bucket);
  const Problem<E> p{q, k, v, mask, out, lse, B, Tq, Tk, H, D, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (std::is_same_v<E, bf16>) {
    return (int)launch_bf16(rows, bucket, p, s);
  } else {
    return (int)(rows == 16   ? launch_bucket<1>(bucket, p, s)
                  : rows == 48 ? launch_bucket<3>(bucket, p, s)
                               : launch_bucket<4>(bucket, p, s));
  }
}

}  // namespace

// `scale` is 1/sqrt(D), rounded to fp32 by the caller as the JAX package
// rounds it. With a non-null `lse` it also writes each row's log-sum-exp of
// its scaled scores over the valid keys, (B, H, Tq) fp32, +inf for a row
// with no valid key (the backward, masked_attention_bwd.cu, reads it).
// Returns the CUDA error code of the launch (0 on success). Does not
// synchronise; runs on `stream`.
extern "C" int masked_attention_forward(const float* q, const float* k,
                                        const float* v,
                                        const unsigned char* mask,
                                        float* out, float* lse, int B, int Tq,
                                        int Tk, int H, int D, float scale,
                                        void* stream) {
  return forward(q, k, v, mask, out, lse, B, Tq, Tk, H, D, scale, stream);
}

// The same with bf16 streams (q, k, v and out), on the tensor cores.
extern "C" int masked_attention_forward_bf16(const bf16* q, const bf16* k,
                                             const bf16* v,
                                             const unsigned char* mask,
                                             bf16* out, float* lse, int B,
                                             int Tq, int Tk, int H, int D,
                                             float scale, void* stream) {
  return forward(q, k, v, mask, out, lse, B, Tq, Tk, H, D, scale, stream);
}

// The instance a launch takes for Tq queries of head dim D in streams of
// elem_bytes-byte elements (4: masked_attention_forward, 2: its bf16
// twin): rows a block and head-dim bucket, for the wrapper's tests.
extern "C" int masked_attention_instance(int Tq, int D, int elem_bytes,
                                         int* rows, int* bucket) {
  if (Tq < 1 || D < 1 || D > kMaxD || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  pick_instance(Tq, D, elem_bytes, rows, bucket);
  return 0;
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* masked_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
