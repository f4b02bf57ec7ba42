// Banded (sliding-window) attention for Hopper (sm_90a), fp32: the forward
// with its per-row log-sum-exp, the forward with a relative-position bias,
// and the two backward kernels.
//
// Replaces the TPU kernels of vrdone_tpu/ops/pallas/band_attention.py:
//   * band_forward_kernel<.., kPE = false> (K1) <- _band_kernel (forward, no
//     relative-position bias), reached through _head_forward; with a
//     non-null `lse` it also writes lse = m + log(l) per query row, as
//     _head_forward does;
//   * band_forward_kernel<.., kPE = true> (K4) <- _band_kernel(with_pe=True),
//     reached through band_attention_pallas(rel_pe=...) and
//     masked._band_pallas_pe: the same forward with rel_pe[h, clip(j - i +
//     w, 0, window_size - 1)] added to each in-band score before the key
//     mask. The Pallas kernel adds host-built (H, 3, block, block) bias
//     tiles; here the lane that takes band offset n of a row holds the one
//     table entry rel_pe[h, min(n, window_size - 1)] in a register. The
//     clamp matters for an even window_size, where 2w + 1 > window_size.
//     K1 and K4 are one templated body, so a zero table gives K1's output
//     bit for bit. The JAX package pairs this forward with the dense
//     backward, and so does the port (no backward kernel);
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
// What bounds the forward on this card: each query row does 2 * (2w+1) * d
// multiply-adds against its own q, out and the 2w+1 rows of K and V it
// shares with its neighbours, so reading q, k, v once and writing out once
// is the least it can take (0.030 ms at the eval forward's B*H = 128*4,
// T = 96, d = 128; 0.015 ms at the stream's 8*8, 768, 64): bytes, not
// arithmetic. What the design does about it:
//   * Lanes over channels. A warp holds a query row across its 32 lanes, a
//     lane 16 bytes of it at d = 128 (8 at d = 64, 4 at d = 32, 2 x 16 at
//     d = 256), pre-scaled in registers. Every K and V row is read from
//     shared memory as one contiguous warp load.
//   * Register tiles over query rows. A warp owns kRT = 4 consecutive query
//     rows. Each of the kRT + 2w key rows of its slab is loaded once and
//     dotted with all four rows; one transposing butterfly (2 + 1 shuffles,
//     then 3) sums the four partial dots across the warp, so 8 lanes end
//     holding each row's score. The scores go to a per-warp scratch tile,
//     key-major, that is 0 outside the band; a softmax pass with lanes over
//     band offsets (segments of the next power of two >= 2w + 1 lanes, 4
//     rows a pass at w = 3) turns them into probabilities divided by the
//     row sum, 0 for keys outside the sequence and for invalid query rows.
//     P.V then reads each V row once with the four rows' probabilities as
//     one broadcast float4. The max and sum of a row are exact over its
//     band (no online rescaling); exp is expf, as in the plain version.
//   * Staging by cp.async. A block owns a tile of R query rows of one
//     (batch, head) and copies the slab of R + 2w key rows its bands reach,
//     K and V, 16 bytes a thread (4 in the scalar instance), zero-filled
//     outside [0, T) and past d by the copy itself; the query rows go
//     straight from device memory into the registers of the one warp that
//     uses them, and the slab's mask bytes into shared memory. Where a
//     block walks several row tiles of one (batch, head), the slab is
//     double-buffered: the next tile's copy, its mask bytes and its query
//     rows are issued before this tile is computed, and one barrier a tile
//     follows. An out-of-sequence key is excluded by its position (-inf),
//     never by the zeros the copy left there.
//   * The instance rule (pick_forward; band_attention_instance exposes it):
//     R is the one of 64, 48, 32 and 16 that stages the fewest slab rows,
//     ceil(T / R) * (R + 2w), ties to the larger (T = 96 and 48: 48 rows;
//     24: 32; 12: 16; 768, 384, 192: 64), among those whose slab fits
//     shared memory; a block walks as many consecutive tiles as makes the
//     grid about one wave of the card's block slots (the tiles over the
//     slots from the SM count and the kernel's occupancy, rounded to the
//     nearest), double-buffered when it walks more than one. On an H100
//     (2 blocks an SM at d = 128 and 64): the eval forward's T = 96 walks
//     both of its tiles, the stream's T = 768 three of its 12, 384 one.
//     Head dims are bucketed (32, 64, 128, 256; channels past d are 0); d
//     off a multiple of 4 or a pointer off 16 bytes takes the scalar
//     instance: the same design with 4-byte copies and loads.
//
// The backward kernels keep the first design: a block owns kRows = 16 rows,
// one warp each, and stages its slab with plain loads. A lane rebuilds its
// score as a serial fmaf chain over d, which sums in another order than the
// forward's butterfly, so P = exp(s - lse) agrees with the forward's
// probabilities to rounding (LSE_TOL and GRAD_TOL in chip_smoke.py hold the
// two together), not bit for bit.
//   * dq: a block owns kRows query rows and stages keys and values
//     [i0 - w, i0 + kRows + w); lane l of warp r rebuilds P and dS of key
//     i - w + l, then the warp sums dS . K over its band with lanes over the
//     channels.
//   * dkv: the mirror image. A block owns kRows key rows and stages queries,
//     upstream gradients, lse and Dr of rows [j0 - w, j0 + kRows + w);
//     lane l of warp r takes query j - w + l of key j's band.
// Backward math, with P = exp(S - lse) rebuilt from the saved lse and
// Dr = rowsum(dO * O) computed by the caller:
//   dS = P * (dO . V^T - Dr),  dQ = scale * dS . K,
//   dK = scale * dS^T . Q,     dV = P^T . dO.
//
// Layout: q, k, v, out, dout, dq, dk, dv are (B, T, H*d) contiguous with
// heads split head-major along the channels (channels [h*d, (h+1)*d) are
// head h), as the JAX package's _split_heads lays them out, so no transpose
// is needed around the calls. mask is (B, T) bool (one byte each); lse and
// Dr are (B, H, T) fp32; rel_pe is (H, window_size) fp32. Takes any T (no
// padding), 1 <= d <= 256 and 0 <= w <= 15; the Python wrapper rejects
// anything else before the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;         // backward: owned rows a block, a warp each
constexpr int kMaxD = 256;        // head dim bound (kMaxD / 32 floats a lane)
constexpr int kMaxW = 15;         // 2w + 1 <= 31: at most one warp of keys
constexpr int kChan = kMaxD / 32; // channels a lane owns in a row sum
constexpr float kNegBig = -1e4f;  // additive mask of an invalid in-band key

constexpr int kRT = 4;            // forward: query rows a warp owns
constexpr int kMaskStage = 128;   // forward: mask bytes a stage (R + 2w <= 94)
constexpr size_t kSmemMax = 232448;  // shared memory a block may take

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

// ---------------------------------------------------------------------------
// The forward (K1, K4)
// ---------------------------------------------------------------------------

// How a lane holds a row of a head-dim bucket DB: kNC runs of kVW
// consecutive channels, run c at channel c * 32 * kVW + lane * kVW.
template <int DB>
struct Lane {
  static constexpr int kVW = DB >= 128 ? 4 : DB / 32;
  static constexpr int kNC = DB / (32 * kVW);
  static constexpr int kN = kVW * kNC;  // channels a lane holds
};

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* x) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The problem a forward launch solves, with the instance pick_forward chose.
struct BandProblem {
  const float* q;
  const float* k;
  const float* v;
  const unsigned char* mask;
  const float* rel_pe;  // (H, npe), read by K4 only
  float* out;
  float* lse;           // (B, H, T) or null
  int T, H, D, w, npe;
  float scale;
  int rows;             // query rows a tile: 8 * rows threads a block
  int tiles;            // row tiles a (batch, head)
  int per_block;        // consecutive row tiles a block walks
};

// Copy the K and V rows [r0, r0 + n) of one head into ks and vs (row stride
// DB floats), zero outside [0, T) and past D.
template <int DB, bool kVec>
__device__ __forceinline__ void copy_slab(float* ks, float* vs,
                                          const BandProblem& p, size_t base,
                                          int r0, int n) {
  const int C = p.H * p.D;
  if constexpr (kVec) {
    constexpr unsigned kCh = DB / 4;  // 16-byte chunks a row
    for (unsigned idx = threadIdx.x; idx < n * kCh; idx += blockDim.x) {
      const unsigned r = idx / kCh;
      const int c = 4 * (int)(idx - r * kCh);
      const int t = r0 + (int)r;
      const bool live = t >= 0 && t < p.T && c < p.D;
      const size_t off = live ? base + (size_t)t * C + c : 0;
      cp_async16(ks + r * DB + c, p.k + off, live);
      cp_async16(vs + r * DB + c, p.v + off, live);
    }
  } else {
    for (unsigned idx = threadIdx.x; idx < n * DB; idx += blockDim.x) {
      const unsigned r = idx / DB;
      const int c = (int)(idx - r * DB);
      const int t = r0 + (int)r;
      const bool live = t >= 0 && t < p.T && c < p.D;
      const size_t off = live ? base + (size_t)t * C + c : 0;
      cp_async4(ks + r * DB + c, p.k + off, live);
      cp_async4(vs + r * DB + c, p.v + off, live);
    }
  }
}

// This lane's channels of the kRT query rows from i0, unscaled, 0 past T and
// past D. Issued ahead of their use, so nothing here waits for the loads.
template <int DB, bool kVec>
__device__ __forceinline__ void load_queries(float (&qr)[kRT][Lane<DB>::kN],
                                             const BandProblem& p,
                                             size_t base, int i0, int lane) {
  using L = Lane<DB>;
  const int C = p.H * p.D;
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const bool live = i0 + r < p.T;
    const float* row = p.q + base + (size_t)(i0 + r) * C;
#pragma unroll
    for (int c = 0; c < L::kNC; ++c) {
      const int ch = c * 32 * L::kVW + lane * L::kVW;
      if constexpr (kVec) {
        if (live && ch < p.D) {
          load_vec<L::kVW>(row + ch, qr[r] + c * L::kVW);
        } else {
#pragma unroll
          for (int e = 0; e < L::kVW; ++e) qr[r][c * L::kVW + e] = 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < L::kVW; ++e)
          qr[r][c * L::kVW + e] = live && ch + e < p.D ? row[ch + e] : 0.f;
      }
    }
  }
}

// Sums four per-lane partial dots (one a query row) across the warp: a
// transposing butterfly halves the values a lane carries at lanes 16 and 8
// apart, then three plain steps finish. Every lane of the 8 with
// (lane >> 3) & 3 == r returns the full dot of row r.
__device__ __forceinline__ float reduce_rows(const float (&s)[kRT],
                                             int lane) {
  const bool hi = lane & 16;
  float k0 = hi ? s[2] : s[0];
  float k1 = hi ? s[3] : s[1];
  k0 += __shfl_xor_sync(0xffffffffu, hi ? s[0] : s[2], 16);
  k1 += __shfl_xor_sync(0xffffffffu, hi ? s[1] : s[3], 16);
  const bool hi8 = lane & 8;
  float k = hi8 ? k1 : k0;
  k += __shfl_xor_sync(0xffffffffu, hi8 ? k0 : k1, 8);
  k += __shfl_xor_sync(0xffffffffu, k, 4);
  k += __shfl_xor_sync(0xffffffffu, k, 2);
  k += __shfl_xor_sync(0xffffffffu, k, 1);
  return k;
}

// The forward, K1 (kPE false) and K4 (kPE true). A block takes p.per_block
// consecutive row tiles of one (batch, head), warp `warp` rows
// warp * kRT .. + kRT - 1 of each. With kPE, the score of band offset n gets
// rel_pe[h, min(n, npe - 1)] between the scaled dot product and the key
// mask, the order of the dense form's additions.
template <int DB, bool kVec, bool kPE>
__global__ void __launch_bounds__(512)
band_forward_kernel(const BandProblem p) {
  using L = Lane<DB>;
  extern __shared__ __align__(16) float fwd_smem[];
  const int w = p.w, R = p.rows, T = p.T;
  const int slab = R + 2 * w;                   // key rows a tile reaches
  const int stages = p.per_block > 1 ? 2 : 1;
  const int xs = (kRT + 2 * w) * kRT;           // a warp's scores, key-major
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* ks = fwd_smem;                         // stages x slab x DB
  float* vs = ks + stages * slab * DB;          // stages x slab x DB
  float* x = vs + stages * slab * DB + warp * xs;
  unsigned char* ms = reinterpret_cast<unsigned char*>(
      vs + stages * slab * DB + (blockDim.x >> 5) * xs);  // stages x 128

  const int chunks = (p.tiles + p.per_block - 1) / p.per_block;
  const int bh = blockIdx.x / chunks;
  const int t_first = (blockIdx.x - bh * chunks) * p.per_block;
  const int t_end = min(t_first + p.per_block, p.tiles);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const size_t base = (size_t)b * T * p.H * p.D + (size_t)h * p.D;
  const unsigned char* mrow = p.mask + (size_t)b * T;

  // the softmax's lanes: segments of kseg lanes, lane n of a segment takes
  // band offset n of one row, 32 / kseg rows a pass
  int kseg = 1;
  while (kseg < 2 * w + 1) kseg <<= 1;
  const int n = lane & (kseg - 1);
  const int seg_row = lane / kseg;
  float pe = 0.f;
  if (kPE && n <= 2 * w) pe = p.rel_pe[h * p.npe + min(n, p.npe - 1)];

  copy_slab<DB, kVec>(ks, vs, p, base, t_first * R - w, slab);
  cp_async_commit();
  for (int j = threadIdx.x; j < slab; j += blockDim.x) {
    const int t = t_first * R - w + j;
    ms[j] = t >= 0 && t < T ? mrow[t] : 0;
  }
  for (int j = lane; j < xs; j += 32) x[j] = 0.f;  // 0 outside the band
  float qr[kRT][L::kN];
  load_queries<DB, kVec>(qr, p, base, t_first * R + warp * kRT, lane);
  cp_async_wait_all();
  __syncthreads();

  const int rl = (lane >> 3) & 3;  // the row whose score this lane ends with
  for (int t = t_first; t < t_end; ++t) {
    const int s = (t - t_first) & (stages - 1);
    const bool next = t + 1 < t_end;
    unsigned char mnext = 0;
    if (next) {  // the next tile's slab and mask bytes, under this tile
      const int r0 = (t + 1) * R - w;
      copy_slab<DB, kVec>(ks + (s ^ 1) * slab * DB, vs + (s ^ 1) * slab * DB,
                          p, base, r0, slab);
      cp_async_commit();
      if ((int)threadIdx.x < slab) {
        const int tt = r0 + threadIdx.x;
        mnext = tt >= 0 && tt < T ? mrow[tt] : 0;
      }
    }
    const int i0 = t * R + warp * kRT;  // this warp's first query row
    if (i0 < T) {
      // this warp's slab: key rows i0 - w .. i0 + kRT - 1 + w
      const float* kt = ks + (s * slab + warp * kRT) * DB;
      const float* vt = vs + (s * slab + warp * kRT) * DB;
      const unsigned char* mt = ms + s * kMaskStage + warp * kRT;

      // 1. scores: each key row once, dotted with all kRT query rows
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int e = 0; e < L::kN; ++e) qr[r][e] *= p.scale;
#pragma unroll 4
      for (int jj = 0; jj < kRT + 2 * w; ++jj) {
        float kx[L::kN];
#pragma unroll
        for (int c = 0; c < L::kNC; ++c)
          load_vec<L::kVW>(kt + jj * DB + c * 32 * L::kVW + lane * L::kVW,
                           kx + c * L::kVW);
        float part[kRT];
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < L::kN; ++e) a = fmaf(qr[r][e], kx[e], a);
          part[r] = a;
        }
        const float sc = reduce_rows(part, lane);
        if (jj - rl >= 0 && jj - rl <= 2 * w) x[jj * kRT + rl] = sc;
      }
      if (next)  // the query rows are used up: fetch the next tile's
        load_queries<DB, kVec>(qr, p, base, i0 + R, lane);
      __syncwarp();

      // 2. softmax over each row's band, lanes over band offsets
      for (int r0 = 0; r0 < kRT; r0 += 32 / kseg) {
        const int r = r0 + seg_row;
        const int i = i0 + r;
        const int j = i - w + n;
        const bool band = r < kRT && n <= 2 * w;
        const bool in = band && j >= 0 && j < T;
        float sv = -INFINITY;
        if (in) {
          sv = x[(r + n) * kRT + r];
          if (kPE) sv += pe;
          sv += mt[r + n] ? 0.f : kNegBig;
        }
        // a valid row's own key is in the sequence, so its max is finite
        float m = sv;
        for (int o = kseg >> 1; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        const float e = in ? expf(sv - m) : 0.f;
        float l = e;
        for (int o = kseg >> 1; o > 0; o >>= 1)
          l += __shfl_xor_sync(0xffffffffu, l, o);
        if (band) {
          const bool valid_row = i < T && mt[r + w];
          x[(r + n) * kRT + r] = valid_row ? e / l : 0.f;
          if (p.lse != nullptr && n == 0 && i < T)
            p.lse[(size_t)bh * T + i] = m + logf(l);
        }
      }
      __syncwarp();

      // 3. P.V: each value row once, with the kRT rows' probabilities
      float acc[kRT][L::kN];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int e = 0; e < L::kN; ++e) acc[r][e] = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < kRT + 2 * w; ++jj) {
        float vx[L::kN];
#pragma unroll
        for (int c = 0; c < L::kNC; ++c)
          load_vec<L::kVW>(vt + jj * DB + c * 32 * L::kVW + lane * L::kVW,
                           vx + c * L::kVW);
        const float4 pj = *reinterpret_cast<const float4*>(x + jj * kRT);
        const float pr[kRT] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
        for (int r = 0; r < kRT; ++r)
#pragma unroll
          for (int e = 0; e < L::kN; ++e)
            acc[r][e] = fmaf(pr[r], vx[e], acc[r][e]);
      }
      const int C = p.H * p.D;
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        if (i0 + r >= T) break;
        float* orow = p.out + base + (size_t)(i0 + r) * C;
#pragma unroll
        for (int c = 0; c < L::kNC; ++c) {
          const int ch = c * 32 * L::kVW + lane * L::kVW;
          if constexpr (kVec) {
            if (ch < p.D) store_vec<L::kVW>(orow + ch, acc[r] + c * L::kVW);
          } else {
#pragma unroll
            for (int e = 0; e < L::kVW; ++e)
              if (ch + e < p.D) orow[ch + e] = acc[r][c * L::kVW + e];
          }
        }
      }
    }
    if (next) {
      // every thread's share of the next slab has landed and every warp is
      // done with this stage (and its scores) before the next tile starts
      if ((int)threadIdx.x < slab)
        ms[(s ^ 1) * kMaskStage + threadIdx.x] = mnext;
      cp_async_wait_all();
      __syncthreads();
    }
  }
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

// Shared memory of a forward block: the K and V slabs of each stage, the
// warps' score tiles and the stages' mask bytes.
size_t forward_smem(int DB, int rows, int w, int stages) {
  return sizeof(float) * ((size_t)stages * 2 * (rows + 2 * w) * DB +
                          (size_t)(rows / kRT) * (kRT + 2 * w) * kRT) +
         (size_t)stages * kMaskStage;
}

// The forward's instance for B*H sequences of T rows, half window w, head
// bucket DB, launched as `kernel`: the rows a tile (the one of 64, 48, 32,
// 16 that stages the fewest slab rows, ceil(T / R) * (R + 2w), ties to the
// larger, whose single-stage slab fits) and the tiles a block walks (the
// B*H * tiles over the card's block slots at the occupancy of the
// double-buffered block, rounded to the nearest; 1 where that block does
// not fit). Sets p->rows, p->tiles, p->per_block and the block's shared
// memory.
template <typename Kernel>
cudaError_t pick_forward(Kernel kernel, int DB, int BH, BandProblem* p,
                         size_t* smem) {
  const int T = p->T, w = p->w;
  constexpr int kTileRows[] = {64, 48, 32, 16};
  long long best = LLONG_MAX;
  for (const int r : kTileRows) {
    const long long cost = (long long)((T + r - 1) / r) * (r + 2 * w);
    if (cost < best && forward_smem(DB, r, w, 1) <= kSmemMax) {
      best = cost;
      p->rows = r;
    }
  }
  p->tiles = (T + p->rows - 1) / p->rows;
  p->per_block = 1;
  *smem = forward_smem(DB, p->rows, w, 1);
  const size_t smem2 = forward_smem(DB, p->rows, w, 2);
  if (p->tiles == 1 || smem2 > kSmemMax) return cudaSuccess;
  cudaError_t err = allow_smem(kernel, smem2);
  if (err != cudaSuccess) return err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      8 * p->rows, smem2);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)sms * (per_sm > 1 ? per_sm : 1);
  long long walk = ((long long)BH * p->tiles + slots / 2) / slots;
  if (walk > p->tiles) walk = p->tiles;
  if (walk > 1) {
    const int chunks = (int)((p->tiles + walk - 1) / walk);
    p->per_block = (p->tiles + chunks - 1) / chunks;
    *smem = smem2;
  }
  return cudaSuccess;
}

// Picks the instance of the forward for *p and, with `launch`, launches it.
template <int DB, bool kVec, bool kPE>
cudaError_t run_forward(BandProblem* p, int B, cudaStream_t stream,
                        bool launch) {
  auto kernel = band_forward_kernel<DB, kVec, kPE>;
  size_t smem;
  cudaError_t err = pick_forward(kernel, DB, B * p->H, p, &smem);
  if (err != cudaSuccess || !launch) return err;
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  const long long blocks = (long long)B * p->H *
                           ((p->tiles + p->per_block - 1) / p->per_block);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 8 * p->rows, smem, stream>>>(*p);
  return cudaGetLastError();
}

template <bool kVec, bool kPE>
cudaError_t run_bucket(int bucket, BandProblem* p, int B,
                       cudaStream_t stream, bool launch) {
  switch (bucket) {
    case 32: return run_forward<32, kVec, kPE>(p, B, stream, launch);
    case 64: return run_forward<64, kVec, kPE>(p, B, stream, launch);
    case 128: return run_forward<128, kVec, kPE>(p, B, stream, launch);
    default: return run_forward<256, kVec, kPE>(p, B, stream, launch);
  }
}

// The smallest head-dim bucket that holds D, and whether the streams can be
// copied 16 bytes at a time (the vector instance) or not (the scalar one).
int head_bucket(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

bool vector_streams(const BandProblem& p) {
  return p.D % 4 == 0 && ((reinterpret_cast<uintptr_t>(p.q) |
                           reinterpret_cast<uintptr_t>(p.k) |
                           reinterpret_cast<uintptr_t>(p.v) |
                           reinterpret_cast<uintptr_t>(p.out)) & 15) == 0;
}

cudaError_t forward(BandProblem* p, int B, bool pe, cudaStream_t stream,
                    bool launch) {
  const int bucket = head_bucket(p->D);
  const bool vec = vector_streams(*p);
  if (pe)
    return vec ? run_bucket<true, true>(bucket, p, B, stream, launch)
               : run_bucket<false, true>(bucket, p, B, stream, launch);
  return vec ? run_bucket<true, false>(bucket, p, B, stream, launch)
             : run_bucket<false, false>(bucket, p, B, stream, launch);
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
  BandProblem p{q, k, v, mask, nullptr, out, lse, T, H, D, w, 1, scale,
                0, 0, 0};
  return (int)forward(&p, B, false, (cudaStream_t)stream, true);
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
  BandProblem p{q, k, v, mask, rel_pe, out, nullptr, T, H, D, w,
                window_size, scale, 0, 0, 0};
  return (int)forward(&p, B, true, (cudaStream_t)stream, true);
}

// The instance the forward (K1, or K4 with `pe`) takes on the current
// device for 16-byte-aligned streams of this shape: query rows a tile,
// row tiles a (batch, head), tiles a block walks and the head-dim bucket;
// `vec` is 1 for the vector instance (d % 4 == 0), 0 for the scalar one.
extern "C" int band_attention_instance(int B, int T, int H, int D, int w,
                                       int pe, int* rows, int* tiles,
                                       int* per_block, int* bucket,
                                       int* vec) {
  if (bad_shape(B, T, H, D, w)) return (int)cudaErrorInvalidValue;
  BandProblem p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, T, H, D, w, 2 * w + 1, 1.f, 0, 0, 0};
  const cudaError_t err = forward(&p, B, pe != 0, nullptr, false);
  *rows = p.rows;
  *tiles = p.tiles;
  *per_block = p.per_block;
  *bucket = head_bucket(D);
  *vec = vector_streams(p);
  return (int)err;
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
