// Key-masked full attention forward for Hopper (sm_90a), fp32 and bf16.
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
// What bounds it on this card. The inputs are fp32 and TF32 is off (the
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
// The design:
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
//
// The bf16 instances (masked_attention_forward_bf16, the bf16 serving path)
// are the same body with __nv_bfloat16 streams (E in the templates): K and V
// tiles are staged as bf16 (half the shared memory; a 16-byte cp.async
// carries 8 values, so the vector copies need d % 8 == 0, and the scalar
// instance, for any other d or an unaligned stream, copies with plain
// 2-byte loads, below cp.async's 4-byte least), the query tile is widened
// to fp32 and scaled in shared memory as in the fp32 instances, and every
// dot, the online softmax (m, l) and P.V accumulate in fp32. Where the
// dense form rounds the normalised P, this kernel rounds the unnormalised
// exp(s - m) to bf16 before P.V, as the Pallas flash kernels do (l sums the
// unrounded values), and writes the output once in bf16. At bf16 the bytes
// halve and SDPA can take its flash backend: this simple instance runs on
// the fp32 FMA pipes, not the tensor cores (ROADMAP queue 2).
//
// What still holds it back (PERF.md): a warp's 16-byte shared load delivers
// 512 bytes and seems to take 4 cycles of the SM's shared-memory bandwidth
// however many lanes share an address (the timings fit that, not the
// one-cycle broadcast), so at 8 FMAs a load the score product takes about
// twice the cycles of its FMAs, and P.V (12.8 FMAs a load) more than its.
// Larger register tiles need more rows a block, and their shared memory then
// leaves one block an SM: 128-row blocks of 8 x 4 tiles were slower.
//
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

namespace {

using element::bf16;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

template <int DB, int TM, typename E>
cudaError_t launch(const Problem<E>& p, cudaStream_t stream) {
  using T = Tiles<DB, TM, E>;
  auto kernel = masked_attention_fwd_kernel<DB, TM, E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int row_tiles = (p.Tq + T::kRows - 1) / T::kRows;
  const long long blocks = (long long)p.B * p.H * row_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  // 16-byte copies: 4 fp32 or 8 bf16 channels each
  const bool vec = p.D % (16 / (int)sizeof(E)) == 0 &&
                   ((reinterpret_cast<uintptr_t>(p.q) |
                     reinterpret_cast<uintptr_t>(p.k) |
                     reinterpret_cast<uintptr_t>(p.v) |
                     reinterpret_cast<uintptr_t>(p.out)) & 15) == 0;
  kernel<<<(unsigned)blocks, kThreads, T::kBytes, stream>>>(p, row_tiles,
                                                             vec);
  return cudaGetLastError();
}

template <int TM, typename E>
cudaError_t launch_bucket(int bucket, const Problem<E>& p,
                          cudaStream_t stream) {
  switch (bucket) {
    case 32: return launch<32, TM>(p, stream);
    case 64: return launch<64, TM>(p, stream);
    case 128: return launch<128, TM>(p, stream);
    default: return launch<256, TM>(p, stream);
  }
}

// The instance for Tq queries of head dim D: rows a block (16 up to Tq =
// 16, else 48 where it pads fewer rows than 64) and the smallest head-dim
// bucket that holds D (ops/full_attention.py::_variant). The same for
// both element types: only the choice of vector or scalar copies, made at
// the launch, depends on it.
void pick_instance(int Tq, int D, int* rows, int* bucket) {
  *rows = Tq <= 16 ? 16 : (48 - Tq % 48) % 48 < (64 - Tq % 64) % 64 ? 48 : 64;
  *bucket = D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

template <typename E>
int forward(const E* q, const E* k, const E* v, const unsigned char* mask,
            E* out, int B, int Tq, int Tk, int H, int D, float scale,
            void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || H < 1 || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  int rows, bucket;
  pick_instance(Tq, D, &rows, &bucket);
  const Problem<E> p{q, k, v, mask, out, B, Tq, Tk, H, D, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(rows == 16   ? launch_bucket<1>(bucket, p, s)
                : rows == 48 ? launch_bucket<3>(bucket, p, s)
                             : launch_bucket<4>(bucket, p, s));
}

}  // namespace

// `scale` is 1/sqrt(D), rounded to fp32 by the caller as the JAX package
// rounds it. Returns the CUDA error code of the launch (0 on success). Does
// not synchronise; runs on `stream`.
extern "C" int masked_attention_forward(const float* q, const float* k,
                                        const float* v,
                                        const unsigned char* mask,
                                        float* out, int B, int Tq, int Tk,
                                        int H, int D, float scale,
                                        void* stream) {
  return forward(q, k, v, mask, out, B, Tq, Tk, H, D, scale, stream);
}

// The same with bf16 streams (q, k, v and out).
extern "C" int masked_attention_forward_bf16(const bf16* q, const bf16* k,
                                             const bf16* v,
                                             const unsigned char* mask,
                                             bf16* out, int B, int Tq,
                                             int Tk, int H, int D,
                                             float scale, void* stream) {
  return forward(q, k, v, mask, out, B, Tq, Tk, H, D, scale, stream);
}

// The instance masked_attention_forward takes for Tq queries of head dim D
// (rows a block, head-dim bucket), for the wrapper's tests.
extern "C" int masked_attention_instance(int Tq, int D, int* rows,
                                         int* bucket) {
  if (Tq < 1 || D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  pick_instance(Tq, D, rows, bucket);
  return 0;
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* masked_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
