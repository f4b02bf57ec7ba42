// Banded (sliding-window) attention for Hopper (sm_90a): the forward with
// its per-row log-sum-exp, the two backward kernels and the forward with a
// relative-position bias, each for fp32 and for bf16 streams.
//
// Replaces the TPU kernels of vrdone_tpu/ops/pallas/band_attention.py:
//   * band_forward_kernel<.., kPE = false, float> (K1 on fp32 streams) and
//     band_forward_mma_kernel<.., kPE = false, ..> (K1 on bf16 streams) <-
//     _band_kernel (forward, no relative-position bias), reached through
//     _head_forward; with a non-null `lse` they also write lse = m +
//     log(l) per query row, as _head_forward does;
//   * the same two with kPE = true (K4) <- _band_kernel(with_pe=True),
//     reached through band_attention_pallas(rel_pe=...) and
//     masked._band_pallas_pe: the same forward with rel_pe[h, clip(j - i +
//     w, 0, window_size - 1)] added to each in-band score before the key
//     mask. The Pallas kernel adds host-built (H, 3, block, block) bias
//     tiles; here the lane that takes band offset n of a row holds the one
//     table entry rel_pe[h, min(n, window_size - 1)] in a register. The
//     clamp matters for an even window_size, where 2w + 1 > window_size.
//     In each dtype K1 and K4 are one templated body, so a zero table
//     gives K1's output bit for bit. The JAX package pairs this forward with the dense
//     backward, and so does the port (no backward kernel);
//   * band_backward_kernel<.., kKV = false, .., float> (K2 on fp32 streams)
//     and band_backward_mma_kernel<.., kKV = false, ..> (K2 on bf16
//     streams) <- _dq_kernel (dQ), launched by _band_core_bwd;
//   * the same two with kKV = true (K3) <- _dkv_kernel (dK, dV), launched
//     by _band_core_bwd.
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
// The bf16 forward (band_attention_forward_bf16 and, with the bias,
// band_attention_pe_forward_bf16: K1 and K4 on the bf16 serving and
// training paths) is its own kernel on the tensor cores,
// band_forward_mma_kernel<DB, kVec, kPE, NT>. The numbers follow JAX's
// dense form in bf16: the scores in fp32 from the bf16 operands, the fp32
// dot scaled in fp32 (as the Pallas kernel scales it; the dense form scales
// q in fp32 first, one rounding apart, and q * scale is never rounded to
// bf16), the bias (a bf16 or fp32 table, widened exactly) and the key mask
// added in fp32, the softmax exact over the band in fp32 (expf, natural
// log, no online rescaling: the band fits one key tile), P divided by the
// row sum and only then rounded to bf16 as the dense form rounds it, P.V
// summed in fp32 and the output rounded to bf16 once; the lse stays fp32.
// What bounds it is the bytes, half of fp32's (0.015 ms at the eval
// forward's B*H = 128*4, T = 96, d = 128; 0.010 ms at VidOR's 16*8, 512,
// 64): its 4 * (2w + 1) * d operations a row are nothing at 989 TFLOP/s.
// The parent design, the FMA body on widened bf16, was issue-bound in the
// score pass's butterfly and ran at under half that bound. The design:
//   * A warp owns one 16-row query tile, the m16 of
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, and its band's
//     16 + 2w keys as NT n8 key tiles (3 up to w = 4: 24 keys, 12 score
//     registers a lane; 6 up to w = 15). S = Q.K^T takes Q's A fragments
//     and K's B fragments by ldmatrix from the staged tiles (a row address
//     a lane, so the band's start needs no 8-row alignment); most of each
//     16 x 8 NT score tile lies outside the band, tensor-core work that
//     costs nothing in a bytes-bound kernel.
//   * The scale, the bias (fixed per lane by its row and column, so held
//     in registers over a block's tiles), the key mask (the band's bits
//     from one ballot of the stage's mask bytes) and the band's and the
//     sequence's -inf are applied in registers. A row's columns sit on the
//     4 lanes of a quad: its max and sum take 2 shuffles each. No score
//     tile in shared memory and no butterfly remain.
//   * P, normalised and rounded with cvt.rn.bf16x2, stays in registers:
//     two adjacent n8 accumulator tiles are one k16 A fragment of P.V (2
//     k16 steps up to w = 4, 3 beyond; where NT is odd the last step's
//     second half is zeros, and its V fragments are taken from its first 8
//     keys only). V's
//     B fragments come from ldmatrix.x4.trans; O is fp32 in registers,
//     DB / 2 a lane (two passes of 128 channels at DB = 256). The output is
//     staged in the warp's own query rows and written in 16-byte stores.
//   * A block owns one tile of R = 16, 32 or 64 query rows of one (batch,
//     head), R / 16 of its 4 warps a 16-row tile each, and stages, with
//     16-byte cp.async from all 4 warps, the query tile and the slab of
//     R + 2w key rows, K and V, at a row stride of DB + 8 bf16 (an
//     ldmatrix's 8 rows in distinct banks), and the slab's mask bytes.
//     Padding is zeros from the copy itself: channels past d, rows outside
//     [0, T) and the slab rows past R + 2w up to the last warp's reach,
//     because 0 * NaN is NaN in the tensor cores; keys outside [0, T) are
//     excluded by position (-inf), never by those zeros. Rows past T are
//     computed on zeros (m taken as 0 where a row has no key), never
//     stored, and rows are independent in the mma.
//   * The instance rule (pick_mma): R the smallest of 16, 32, 64 that
//     holds T (64 past it), halved while the blocks would give the card's
//     SMs fewer than two each; no block walks several tiles. A sweep of
//     every R with 1, 2, 4 and 8 double-buffered tiles a block, at the
//     bf16 paths' shapes and at up to 8192 tiles, found walking slower
//     everywhere: it halves the blocks an SM holds, and their copies in
//     flight hide the load latency better than the double buffer. The
//     scalar instance (d % 8 != 0, or a stream off 16 bytes) copies with
//     2-byte loads into the same padded layout.
// Measured alone on an H100 SXM (700 W), against the FMA body on widened
// bf16 that it replaces: 0.0218 ms at the eval forward's B*H = 128*4,
// T = 96, d = 128 (was 0.0321), 0.0117-0.0118 at VidOR's 16*8, 512, 64
// (was 0.0289), K4 there 0.0121-0.0122 (was 0.0294). 90 registers at
// <128, true, false, 3>, 56 at <64, true, true, 3>, at most 127 at any
// instance; none spills.
//
// The fp32 backward, K2 (dQ) and K3 (dK, dV), is one templated body
// (band_backward_kernel<.., kKV, .., float>), built from the fp32
// forward's pieces. The two
// kernels are mirrors: a block owns R consecutive owner rows of one (batch,
// head) and stages the slab of R + 2w partner rows that their bands reach.
//   * K2: owners are queries, held in registers as q (pre-scaled) and dO;
//     partners are keys, staged as K and V. dQ += dS . k, times scale at
//     the store.
//   * K3: owners are keys, held as k (pre-scaled) and v; partners are
//     queries, staged as Q and dO. dK += dS . q (times scale at the store),
//     dV += P . dO.
// With P = exp(s - lse) rebuilt from the saved lse, s = q . k * scale
// (+ -1e4 for an in-band invalid key) and Dr = rowsum(dO * O) computed by
// the caller: dS = P * (dO . v - Dr), dQ = scale * dS . K,
// dK = scale * dS^T . Q, dV = P^T . dO. A pair whose query is invalid, or
// whose partner lies outside the band or the sequence, has P = dS = 0, so
// an invalid query row gets dQ = 0 and gives nothing to dK or dV.
// What bounds it: each kernel reads its four (B, T, H*d) streams, lse and
// Dr once and writes one (K2) or two (K3) streams: bytes again (0.0071 ms
// for K2, 0.0085 for K3 at the train step's B*H = 24*4, T = 96, d = 128).
// What the design does about it, step by step:
//   * Lanes over channels (Lane<DB>), a warp owning RT consecutive owner
//     rows (2 or 4, from the instance rule). Each partner row of the
//     warp's reach is loaded once from shared memory, both of its streams,
//     and dotted with all RT owner rows: 2 * RT partial dots, summed across
//     the warp by one transposing butterfly (reduce_rows<2 * RT>: 9
//     shuffles for 8 dots, where plain butterflies take 40). The dots go
//     to two per-warp tiles, partner-major, 0 outside the band.
//   * A pass with lanes over (owner, band offset) pairs turns them into P
//     and dS in place; the band test, the masks and the exclusion of
//     out-of-sequence partners (by position, never by the copy's zeros)
//     live there only. K2's s is the forward's score bit for bit.
//   * Accumulation rereads each partner row once and adds it into RT rows
//     of register accumulators with the owners' dS (and for K3 P) as one
//     broadcast vector.
//   * Staging as in the forward: cp.async slabs of both partner streams
//     (zero-filled outside [0, T) and past d), the slab rows' lse and Dr by
//     4-byte cp.async and their mask bytes into shared memory, the owner
//     rows straight into registers; double-buffered where a block walks
//     two row tiles.
//   * The instance rule (run_backward; band_attention_backward_instance
//     exposes it). A train step's problem is small (24 * 4 sequences of
//     96 rows: 2,304 warps of 4 rows against the card's 8,448 warp slots),
//     so the rule fills the card first: rows a tile are the smallest of
//     16, 32, 48, 64 that is at least 4w (16 at w = 3), and of (2 rows a
//     warp, 1 tile a block), (4, 1), (2, 2), (4, 2) it takes the first
//     whose blocks all fit the card's block slots at once, at that
//     instance's occupancy; (4, 1) where none does. On an H100 at the
//     train shape K2 takes (4, 1) and K3, whose 4-row instance holds 126
//     registers a thread, (2, 2); T = 48, 24, 12 take (2, 1).
// Measured alone by chip_smoke.py on an H100 SXM (700 W) at B*H = 24*4,
// d = 128, w = 3: K2 0.0097-0.0098 ms at T = 96 (the first design's one
// warp a row, a lane a key: 0.0299-0.0300), 0.0072, 0.0059, 0.0050 at
// T = 48, 24, 12; K3 0.0129-0.0130 (0.0348-0.0353), 0.0078, 0.0064,
// 0.0052. No instance spills.
//
// The bf16 backward (band_attention_backward_{dq,dkv}_bf16, K2 and K3 of
// the bf16 train steps) is its own kernel on the tensor cores,
// band_backward_mma_kernel<DB, kVec, kKV, NT>, built from the bf16
// forward's pieces. It takes bf16 q, k, v and dO, as the Pallas kernels do
// (_dq_kernel, _dkv_kernel), and keeps their promotions: S and dP in fp32
// from the bf16 operands (a bf16 x bf16 product is exact in fp32), P =
// exp(s - lse) and dS = P * (dP - Dr) in fp32 (never rounded to bf16, where
// the forward rounds P before P.V), lse and Dr fp32, and each gradient
// rounded to bf16 once, at the store. What bounds it is the bytes, half of
// fp32's streams (0.0035 ms for K2, 0.0042 for K3 at the train step's
// B*H = 24*4, T = 96, d = 128; 0.0380 and 0.0455 at the bf16 rel-PE train
// step's 48*8, 512, 64): its tensor-core work, split products included,
// is 8 (2w + 1) d operations a row in K2 and 12 (2w + 1) d in K3, nothing
// at 989 TFLOP/s. The
// parent design, the FMA body above on widened bf16, summed every product
// on the fp32 pipes through its butterflies and ran at 2.7 to 3 times that
// bound. The design:
//   * The mirror of the forward's tiles. A warp owns one m16 tile of 16
//     owner rows (K2: queries; K3: keys) and their band's 16 + 2w partners
//     as NT n8 tiles (3 up to w = 4, 6 up to w = 15), and computes both
//     products of every pair with the owners as the m16 operand: K2 S =
//     Q.K^T and dP = dO.V^T, K3 S^T = K.Q^T and dP^T = V.dO^T, the A
//     fragments from the owner tiles and the B fragments from the partner
//     slabs by ldmatrix, so nothing is transposed through shared memory.
//     K2's S is built in the forward's fragment and k-step order (two
//     accumulator chains, even and odd k16 steps) and its fp32 dot is
//     scaled in fp32 (never q * scale in bf16), so its s is the bf16
//     forward's bit for bit and P sums to 1 against that forward's lse.
//   * P and dS are formed in registers. The band test, the key mask (-1e4
//     for an in-band invalid key, from one ballot of the slab's mask
//     bytes), the exclusion of partners outside [0, T) by position (never
//     by the copy's zeros or a zero-filled lse) and of invalid queries
//     (P = dS = 0 by selection, so a NaN there goes nowhere) live there
//     only. K2 reads its rows' lse and Dr, K3 its columns', from the
//     staged slab stats.
//   * The accumulations take the [owner x partner] tiles as A fragments,
//     two adjacent n8 accumulator tiles a k16 step, as the forward feeds P
//     to P.V: K2 dQ = dS.K, K3 dV = P^T.dO and dK = dS^T.Q, with the
//     partner rows' B fragments from ldmatrix.trans. P and dS are not
//     rounded to bf16 for the tensor cores: each is split into hi =
//     bf16(x) and lo = bf16(x - hi), and every product takes two mma, hi
//     and lo (the fp16 recipe of the position-bias kernel, in bf16), which
//     holds P and dS to about 2^-16 of their size where hi alone holds
//     2^-8. The sums are fp32, kOC = 128 channels a pass (two at DB =
//     256); dQ and dK are scaled once, at the store. K3 runs dV, then dK,
//     so only one accumulator tile of 64 registers a lane is live. In K3 a
//     partner row whose query is invalid is masked out of the B fragments
//     (P = dS = 0 meet it, and 0 * NaN is NaN in the tensor cores), so an
//     invalid query gives nothing to dK or dV whatever its q and dO hold.
//   * Staging as in the bf16 forward: one 4-warp block a tile of R = 16,
//     32 or 64 owner rows of one (batch, head), the owner tiles of both
//     owner streams and the slab of R + 2w partner rows of both partner
//     streams by 16-byte cp.async at a row stride of DB + 8, zero-filled
//     outside [0, T), past d and past R + 2w, the slab rows' lse and Dr by
//     4-byte cp.async and their mask bytes. Each warp stages its gradients
//     in its own owner rows and writes them in 16-byte stores.
//   * The instance rule is the bf16 forward's (pick_mma; exposed by
//     band_attention_backward_instance): R the smallest of 16, 32, 64 that
//     holds T (64 past it), halved while the blocks would give the card's
//     SMs fewer than two each, one tile a block, R / 16 of the 4 warps
//     owning rows. The scalar instance (d % 8 != 0, or a stream off 16
//     bytes) copies with 2-byte loads into the same padded layout.
// Measured alone on an H100 SXM (700 W), against the FMA body on widened
// bf16 that it replaces: K2 0.0071 ms and K3 0.0082-0.0084 at the train
// step's B*H = 24*4, T = 96, d = 128 (were 0.0093 and 0.0129), 0.0218 and
// 0.0278-0.0281 at 96*4 (0.0339-0.0342, 0.0392-0.0394), 0.0468-0.0470 and
// 0.0559-0.0561 at the rel-PE step's 48*8, 512, 64 (0.1090-0.1092,
// 0.1221-0.1223). 108 registers at <128, true, false, 3>, 136 at
// <128, true, true, 3>, at most 182 (<128, true, true, 6>); none spills.
//
// Layout: q, k, v, out, dout, dq, dk, dv are (B, T, H*d) contiguous with
// heads split head-major along the channels (channels [h*d, (h+1)*d) are
// head h), as the JAX package's _split_heads lays them out, so no transpose
// is needed around the calls; q, k, v, out, dout and the gradients are
// all fp32 or all bf16. mask is (B, T) bool (one byte each); lse and Dr
// are (B, H, T) fp32; rel_pe is (H, window_size), fp32 (or bf16 beside bf16
// streams). Takes any T (no
// padding), 1 <= d <= 256 and 0 <= w <= 15; the Python wrapper rejects
// anything else before the launch.

#include <cuda_runtime.h>
#include <initializer_list>
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
using warp_mma::cp_async4;
using warp_mma::cp_async_commit;
using warp_mma::cp_async_wait;
using warp_mma::ldmatrix_x4;
using warp_mma::ldmatrix_x4_trans;
using warp_mma::mma_bf16;

constexpr int kMaxD = 256;        // head dim bound
constexpr int kMaxW = 15;         // 2w + 1 <= 31: at most one warp of keys
constexpr float kNegBig = -1e4f;  // additive mask of an invalid in-band key

constexpr int kRT = 4;            // forward: query rows a warp owns
constexpr int kStage = 128;       // mask bytes (backward: and lse, Dr) a
                                  // stage; R + 2w <= 94
constexpr size_t kSmemMax = 232448;  // shared memory a block may take

// Threads a backward block may have: 256 at d bucket 256, where a thread
// of K3 holds 2 x 4 owner rows and 2 x 4 accumulator rows of 8 channels.
template <int DB>
constexpr int kBwdThreads = DB >= 256 ? 256 : 512;

// How a lane holds a row of a head-dim bucket DB: kNC runs of kVW
// consecutive channels, run c at channel c * 32 * kVW + lane * kVW.
template <int DB>
struct Lane {
  static constexpr int kVW = DB >= 128 ? 4 : DB / 32;
  static constexpr int kNC = DB / (32 * kVW);
  static constexpr int kN = kVW * kNC;  // channels a lane holds
};

// One head of a (B, T, H*d) stream: rows of C = H*d floats, the head's
// channels [0, D) from `base`.
struct Head {
  size_t base;
  int T, C, D;
};

// Copy rows [r0, r0 + n) of one head of the streams a and b into as and bs
// (row stride DB elements), zero outside [0, T) and past D. The scalar bf16
// instance copies with plain loads (cp.async copies at least 4 bytes).
template <int DB, bool kVec, typename E>
__device__ __forceinline__ void copy_slab(E* as, E* bs, const E* a,
                                          const E* b, const Head& hd, int r0,
                                          int n) {
  constexpr unsigned kW = kVec ? 16 / sizeof(E) : 1;  // elements a copy
  constexpr unsigned kCh = DB / kW;                   // copies a row
  for (unsigned idx = threadIdx.x; idx < n * kCh; idx += blockDim.x) {
    const unsigned r = idx / kCh;
    const int c = kW * (int)(idx - r * kCh);
    const int t = r0 + (int)r;
    const bool live = t >= 0 && t < hd.T && c < hd.D;
    const size_t off = live ? hd.base + (size_t)t * hd.C + c : 0;
    if constexpr (kVec) {
      cp_async16(as + r * DB + c, a + off, live);
      cp_async16(bs + r * DB + c, b + off, live);
    } else if constexpr (std::is_same_v<E, float>) {
      cp_async4(as + r * DB + c, a + off, live);
      cp_async4(bs + r * DB + c, b + off, live);
    } else {
      as[r * DB + c] = live ? a[off] : element::from_f32<E>(0.f);
      bs[r * DB + c] = live ? b[off] : element::from_f32<E>(0.f);
    }
  }
}

// This lane's channels of the RT rows of stream x from i0, unscaled, 0 past
// T and past D. Issued ahead of their use, so nothing here waits for the
// loads.
template <int DB, bool kVec, int RT, typename E>
__device__ __forceinline__ void load_rows(float (&xr)[RT][Lane<DB>::kN],
                                          const E* x, const Head& hd,
                                          int i0, int lane) {
  using L = Lane<DB>;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const bool live = i0 + r < hd.T;
    const E* row = x + hd.base + (size_t)(i0 + r) * hd.C;
#pragma unroll
    for (int c = 0; c < L::kNC; ++c) {
      const int ch = c * 32 * L::kVW + lane * L::kVW;
      if constexpr (kVec) {
        if (live && ch < hd.D) {
          element::load<L::kVW>(row + ch, xr[r] + c * L::kVW);
        } else {
#pragma unroll
          for (int e = 0; e < L::kVW; ++e) xr[r][c * L::kVW + e] = 0.f;
        }
      } else {
#pragma unroll
        for (int e = 0; e < L::kVW; ++e)
          xr[r][c * L::kVW + e] =
              live && ch + e < hd.D ? element::to_f32(row[ch + e]) : 0.f;
      }
    }
  }
}

// Write this lane's channels of RT rows from i0 into stream x, each times
// `mul` (rounded to E), the rows below T and the channels below D only.
template <int DB, bool kVec, int RT, typename E>
__device__ __forceinline__ void store_rows(E* x,
                                           const float (&xr)[RT][Lane<DB>::kN],
                                           float mul, const Head& hd, int i0,
                                           int lane) {
  using L = Lane<DB>;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (i0 + r >= hd.T) break;
    E* row = x + hd.base + (size_t)(i0 + r) * hd.C;
#pragma unroll
    for (int c = 0; c < L::kNC; ++c) {
      const int ch = c * 32 * L::kVW + lane * L::kVW;
      float y[L::kVW];
#pragma unroll
      for (int e = 0; e < L::kVW; ++e) y[e] = xr[r][c * L::kVW + e] * mul;
      if constexpr (kVec) {
        if (ch < hd.D) element::store<L::kVW>(row + ch, y);
      } else {
#pragma unroll
        for (int e = 0; e < L::kVW; ++e)
          if (ch + e < hd.D) row[ch + e] = element::from_f32<E>(y[e]);
      }
    }
  }
}

// One transposing step of reduce_rows and the ones after it: a lane keeps
// the upper half of its n values if (lane & o), else the lower half, and
// adds to each the lane o apart's copy of it.
template <int N, int n, int o>
__device__ __forceinline__ void halve_rows(float (&v)[N], int lane) {
  if constexpr (n > 1) {
    const bool hi = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float keep = hi ? v[n / 2 + i] : v[i];
      const float send = hi ? v[i] : v[n / 2 + i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    halve_rows<N, n / 2, o / 2>(v, lane);
  }
}

// Sums N per-lane partial dots across the warp (N a power of two <= 32): a
// transposing butterfly halves the values a lane carries at lanes 16, 8,
// ... apart until one is left, then plain steps finish. Every lane with
// (lane >> (5 - log2 N)) & (N - 1) == n returns the full dot of value n.
// Each sum is taken over the lanes in the same order whatever N is.
template <int N>
__device__ __forceinline__ float reduce_rows(float (&v)[N], int lane) {
  halve_rows<N, N, 16>(v, lane);
  float k = v[0];
#pragma unroll
  for (int o = 16 / N; o > 0; o >>= 1)
    k += __shfl_xor_sync(0xffffffffu, k, o);
  return k;
}

// ---------------------------------------------------------------------------
// The forward (K1, K4)
// ---------------------------------------------------------------------------

// The problem a forward launch solves, its streams of element type E, with
// the instance pick_forward (fp32) or pick_mma (bf16) chose.
template <typename E>
struct BandProblem {
  const E* q;
  const E* k;
  const E* v;
  const unsigned char* mask;
  const void* rel_pe;   // (H, npe), read by K4 only: fp32, or bf16 where
  int pe_elem;          // pe_elem is 2
  E* out;
  float* lse;           // (B, H, T) or null
  int T, H, D, w, npe;
  float scale;
  int rows;             // query rows a tile: 8 * rows threads a block in
                        // fp32; in bf16 kMmaThreads, a warp a 16-row tile
  int tiles;            // row tiles a (batch, head)
  int per_block;        // consecutive row tiles a block walks (1 in bf16)
};

// The fp32 forward, K1 (kPE false) and K4 (kPE true), on the FMA pipes; E
// is float (bf16 streams take band_forward_mma_kernel). A block takes
// p.per_block consecutive row tiles of one (batch, head), warp `warp` rows
// warp * kRT .. + kRT - 1 of each. With kPE, the score of band offset n gets
// rel_pe[h, min(n, npe - 1)] between the scaled dot product and the key
// mask, the order of the dense form's additions.
template <int DB, bool kVec, bool kPE, typename E>
__global__ void __launch_bounds__(512)
band_forward_kernel(const BandProblem<E> p) {
  static_assert(std::is_same_v<E, float>, "bf16 runs the tensor-core body");
  using L = Lane<DB>;
  extern __shared__ __align__(16) float fwd_smem[];
  const int w = p.w, R = p.rows, T = p.T;
  const int slab = R + 2 * w;                   // key rows a tile reaches
  const int stages = p.per_block > 1 ? 2 : 1;
  const int xs = (kRT + 2 * w) * kRT;           // a warp's scores, key-major
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  E* ks = reinterpret_cast<E*>(fwd_smem);       // stages x slab x DB
  E* vs = ks + stages * slab * DB;              // stages x slab x DB
  float* xw = reinterpret_cast<float*>(vs + stages * slab * DB);
  float* x = xw + warp * xs;
  unsigned char* ms = reinterpret_cast<unsigned char*>(
      xw + (blockDim.x >> 5) * xs);             // stages x kStage

  const int chunks = (p.tiles + p.per_block - 1) / p.per_block;
  const int bh = blockIdx.x / chunks;
  const int t_first = (blockIdx.x - bh * chunks) * p.per_block;
  const int t_end = min(t_first + p.per_block, p.tiles);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const Head hd{(size_t)b * T * p.H * p.D + (size_t)h * p.D, T, p.H * p.D,
                p.D};
  const unsigned char* mrow = p.mask + (size_t)b * T;

  // the softmax's lanes: segments of kseg lanes, lane n of a segment takes
  // band offset n of one row, 32 / kseg rows a pass
  int kseg = 1;
  while (kseg < 2 * w + 1) kseg <<= 1;
  const int n = lane & (kseg - 1);
  const int seg_row = lane / kseg;
  float pe = 0.f;
  if (kPE && n <= 2 * w)
    pe = static_cast<const float*>(p.rel_pe)[h * p.npe + min(n, p.npe - 1)];

  copy_slab<DB, kVec>(ks, vs, p.k, p.v, hd, t_first * R - w, slab);
  cp_async_commit();
  for (int j = threadIdx.x; j < slab; j += blockDim.x) {
    const int t = t_first * R - w + j;
    ms[j] = t >= 0 && t < T ? mrow[t] : 0;
  }
  for (int j = lane; j < xs; j += 32) x[j] = 0.f;  // 0 outside the band
  float qr[kRT][L::kN];
  load_rows<DB, kVec, kRT>(qr, p.q, hd, t_first * R + warp * kRT, lane);
  cp_async_wait<0>();
  __syncthreads();

  const int rl = (lane >> 3) & 3;  // the row whose score this lane ends with
  for (int t = t_first; t < t_end; ++t) {
    const int s = (t - t_first) & (stages - 1);
    const bool next = t + 1 < t_end;
    unsigned char mnext = 0;
    if (next) {  // the next tile's slab and mask bytes, under this tile
      const int r0 = (t + 1) * R - w;
      copy_slab<DB, kVec>(ks + (s ^ 1) * slab * DB, vs + (s ^ 1) * slab * DB,
                          p.k, p.v, hd, r0, slab);
      cp_async_commit();
      if ((int)threadIdx.x < slab) {
        const int tt = r0 + threadIdx.x;
        mnext = tt >= 0 && tt < T ? mrow[tt] : 0;
      }
    }
    const int i0 = t * R + warp * kRT;  // this warp's first query row
    if (i0 < T) {
      // this warp's slab: key rows i0 - w .. i0 + kRT - 1 + w
      const E* kt = ks + (s * slab + warp * kRT) * DB;
      const E* vt = vs + (s * slab + warp * kRT) * DB;
      const unsigned char* mt = ms + s * kStage + warp * kRT;

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
          element::load<L::kVW>(
              kt + jj * DB + c * 32 * L::kVW + lane * L::kVW,
              kx + c * L::kVW);
        float part[kRT];
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < L::kN; ++e) a = fmaf(qr[r][e], kx[e], a);
          part[r] = a;
        }
        const float sc = reduce_rows<kRT>(part, lane);
        if (jj - rl >= 0 && jj - rl <= 2 * w) x[jj * kRT + rl] = sc;
      }
      if (next)  // the query rows are used up: fetch the next tile's
        load_rows<DB, kVec, kRT>(qr, p.q, hd, i0 + R, lane);
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
          element::load<L::kVW>(
              vt + jj * DB + c * 32 * L::kVW + lane * L::kVW,
              vx + c * L::kVW);
        const float4 pj = *reinterpret_cast<const float4*>(x + jj * kRT);
        const float pr[kRT] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
        for (int r = 0; r < kRT; ++r)
#pragma unroll
          for (int e = 0; e < L::kN; ++e)
            acc[r][e] = fmaf(pr[r], vx[e], acc[r][e]);
      }
      store_rows<DB, kVec, kRT>(p.out, acc, 1.f, hd, i0, lane);
    }
    if (next) {
      // every thread's share of the next slab has landed and every warp is
      // done with this stage (and its scores) before the next tile starts
      if ((int)threadIdx.x < slab)
        ms[(s ^ 1) * kStage + threadIdx.x] = mnext;
      cp_async_wait<0>();
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores (K1, K4 on bf16 streams)
// ---------------------------------------------------------------------------

// n8 key tiles of a warp's scores: 3 (24 keys, the band of 16 rows at
// w <= 4) or 6 (48 keys, up to w = 15). One instance of each, so the main
// path's windows 7, 8 and 9 pay for no empty tiles.
int mma_key_tiles(int w) { return w <= 4 ? 3 : 6; }

constexpr int kMmaThreads = 128;  // a block of the tensor-core forward

// K or V rows a block of the tensor-core forward stages for a tile of
// `rows` query rows and nt key tiles a warp: the last warp's scores and
// P.V reach slab row rows - 16 + 8 nt - 1.
__host__ __device__ constexpr int mma_slab_rows(int rows, int nt) {
  return rows - 16 + 8 * nt;
}

// Shared memory of a block of the tensor-core forward: the query tile and
// the K and V slabs (bf16 rows at a stride of DB + 8) and the slab's mask
// bytes.
size_t mma_forward_smem(int DB, int rows, int nt) {
  return sizeof(bf16) * (DB + 8) * (rows + 2 * mma_slab_rows(rows, nt)) +
         kStage;
}

// Copy row tile t of a sequence into shared memory at st: its R query rows
// (zero past T), then the slab rows t R - w + r, K and V, for r below
// R + 2w (zero outside [0, T)) and zeros from there to the slab's end;
// channels past D are zero. 16-byte cp.async copies, or plain 2-byte ones
// in the scalar instance.
template <int DB, bool kVec>
__device__ __forceinline__ void stage_forward_tile(bf16* st,
                                                   const BandProblem<bf16>& p,
                                                   const Head& hd, int t,
                                                   int R, int slab) {
  constexpr int kS = DB + 8;
  constexpr int kW = kVec ? 8 : 1;    // channels a copy
  constexpr int kCh = DB / kW;        // copies a row
  bf16* ks = st + R * kS;
  bf16* vs = ks + slab * kS;
  const int q0 = t * R, k0 = t * R - p.w, live = R + 2 * p.w;
  for (int idx = threadIdx.x; idx < (R + slab) * kCh; idx += blockDim.x) {
    const int r = idx / kCh;
    const int c = kW * (idx - r * kCh);
    // the query row r, or the slab row r - R
    const bool query = r < R;
    const int rr = query ? r : r - R;
    const int j = query ? q0 + r : k0 + rr;
    const bool ok = (query || rr < live) && j >= 0 && j < hd.T && c < hd.D;
    const size_t off = ok ? hd.base + (size_t)j * hd.C + c : 0;
    if constexpr (kVec) {
      if (query) {
        cp_async16(st + r * kS + c, p.q + off, ok);
      } else {
        cp_async16(ks + rr * kS + c, p.k + off, ok);
        cp_async16(vs + rr * kS + c, p.v + off, ok);
      }
    } else {
      const bf16 zero = element::from_f32<bf16>(0.f);
      if (query) {
        st[r * kS + c] = ok ? p.q[off] : zero;
      } else {
        ks[rr * kS + c] = ok ? p.k[off] : zero;
        vs[rr * kS + c] = ok ? p.v[off] : zero;
      }
    }
  }
}

// Write the 16 rows a warp staged at st (row stride DB + 8) to rows i0 ..
// i0 + 15 of one head of stream x, the rows below T and the channels below
// D only: 16-byte stores, or 2-byte ones in the scalar instance.
template <int DB, bool kVec>
__device__ __forceinline__ void write_tile(bf16* x, const bf16* st,
                                           const Head& hd, int i0, int lane) {
  constexpr int kS = DB + 8;
  bf16* out = x + hd.base;
  if constexpr (kVec) {
    constexpr int kChunks = DB / 8;
#pragma unroll
    for (int it = 0; it < 16 * kChunks / 32; ++it) {
      const int idx = lane + 32 * it;
      const int r = idx / kChunks;
      const int c = 8 * (idx - r * kChunks);
      if (i0 + r < hd.T && c < hd.D)
        *reinterpret_cast<uint4*>(out + (size_t)(i0 + r) * hd.C + c) =
            *reinterpret_cast<const uint4*>(st + r * kS + c);
    }
  } else {
    for (int idx = lane; idx < 16 * DB; idx += 32) {
      const int r = idx / DB;
      const int c = idx - r * DB;
      if (i0 + r < hd.T && c < hd.D)
        out[(size_t)(i0 + r) * hd.C + c] = st[r * kS + c];
    }
  }
}

// The bf16 forward, K1 (kPE false) and K4 (kPE true), on the tensor cores.
// A block of kMmaThreads takes one row tile of p.rows = 16, 32 or 64 query
// rows of one (batch, head); warp `warp` < p.rows / 16 owns the 16 query
// rows i0 = t R + 16 warp .. i0 + 15, an m16 tile, and their band's keys
// i0 - w .. i0 - w + 8 NT - 1, NT n8 tiles (3 up to w = 4, 6 up to w =
// 15), which are the slab rows 16 warp .. 16 warp + 8 NT - 1; the other
// warps only copy. A lane holds the scores of rows g = lane / 4 and g + 8
// at columns 8 jn + 2 (lane % 4) + 0 and 1 (mma.sync's accumulator
// layout): column c is key i0 - w + c, at band offset c - row. The bias a
// lane adds to each score (rel_pe[h, min(offset, npe - 1)] with kPE, 0
// without, in the band; -inf outside it) is fixed by its row and column;
// K1 adding 0.0f where K4 adds the table makes a zero table give K1's
// output bit for bit.
template <int DB, bool kVec, bool kPE, int NT>
__global__ void __launch_bounds__(kMmaThreads)
band_forward_mma_kernel(const BandProblem<bf16> p) {
  constexpr int kS = DB + 8;          // row stride of the tiles (bf16)
  constexpr int KT = (NT + 1) / 2;    // k16 steps of P.V
  constexpr int kOC = DB > 128 ? 128 : DB;  // channels of O a pass
  extern __shared__ __align__(16) unsigned char band_mma_smem[];
  const int w = p.w, R = p.rows, T = p.T;
  const int slab = mma_slab_rows(R, NT);
  bf16* qs = reinterpret_cast<bf16*>(band_mma_smem);
  unsigned char* ms = band_mma_smem + sizeof(bf16) * (R + 2 * slab) * kS;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;

  const int bh = blockIdx.x / p.tiles;
  const int t = blockIdx.x - bh * p.tiles;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const Head hd{(size_t)b * T * p.H * p.D + (size_t)h * p.D, T, p.H * p.D,
                p.D};
  const unsigned char* mrow = p.mask + (size_t)b * T;

  stage_forward_tile<DB, kVec>(qs, p, hd, t, R, slab);
  cp_async_commit();
  for (int j = threadIdx.x; j < slab; j += blockDim.x) {
    const int k = t * R - w + j;
    ms[j] = j < R + 2 * w && k >= 0 && k < T ? mrow[k] : 0;
  }
  const int i0 = t * R + 16 * warp;  // this warp's first query row
  const bool rows = 16 * warp < R && i0 < T;  // warp-uniform

  // the bias of each of this lane's scores, by its band offset, read while
  // the copies land
  float bias[NT][4];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * jn + 2 * qd + (e & 1) - g - 8 * (e >> 1);
      float x = -INFINITY;
      if (n >= 0 && n <= 2 * w) {
        x = 0.f;
        if constexpr (kPE) {
          // a bf16 table is widened exactly, as rel_pe.astype(float32)
          const int at = h * p.npe + min(n, p.npe - 1);
          x = p.pe_elem == 2
                  ? element::to_f32(static_cast<const bf16*>(p.rel_pe)[at])
                  : static_cast<const float*>(p.rel_pe)[at];
        }
      }
      bias[jn][e] = x;
    }
  cp_async_wait<0>();
  __syncthreads();
  if (!rows) return;

  bf16* qw = qs + 16 * warp * kS;                    // the warp's queries
  const bf16* kw = qs + (R + 16 * warp) * kS;        // and its band's keys
  const bf16* vw = kw + slab * kS;
  const unsigned char* mw = ms + 16 * warp;
  // the key mask over the warp's band, a bit a column (bits past the
  // band's 8 NT columns are never read)
  const uint64_t valid =
      __ballot_sync(0xffffffffu, mw[lane]) |
      (uint64_t)__ballot_sync(0xffffffffu, NT > 4 && mw[32 + lane]) << 32;

  // the rows this lane points at in an ldmatrix.x4: Q's A fragment of one
  // k16 step (row lane % 16, channels from (lane / 16) * 8); K's B
  // fragments of two k16 steps of one n8 key tile (key lane % 8, channels
  // from (lane / 8) * 8); V's, transposed, of one k16 key step for two n8
  // channel tiles (key lane % 16, channels from (lane / 16) * 8), and of
  // its first 8 keys only where the step's second half has no score tile
  const int qoff = (lane & 15) * kS + (lane >> 4) * 8;
  const int koff = (lane & 7) * kS + (lane >> 3) * 8;
  const int voff = (lane & 15) * kS + (lane >> 4) * 8;
  const int voff8 = (lane & 7) * kS + (lane >> 4) * 8;

  // S = Q.K^T: each Q fragment serves the warp's NT key tiles; even and
  // odd k16 steps sum into two accumulators, halving the chain of
  // dependent products, and meet at the end
  float sc[NT][4], s2[NT][4];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[jn][e] = s2[jn][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DB / 16; kk += 2) {
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, qw + qoff + 16 * kk);
    ldmatrix_x4(a1, qw + qoff + 16 * (kk + 1));
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      uint32_t kf[4];
      ldmatrix_x4(kf, kw + 8 * jn * kS + koff + 16 * kk);
      mma_bf16(sc[jn], a0, kf[0], kf[1]);
      mma_bf16(s2[jn], a1, kf[2], kf[3]);
    }
  }

  // the scaled scores with the bias and the key mask; keys outside [0, T)
  // and the band -inf. A row's columns sit on the 4 lanes of a quad: its
  // max and sum take 2 shuffles each. A row below T has its own key in the
  // band, so its max is finite; a row past T (never stored) may have
  // none, and takes m = 0 so that it stays free of NaN
  const int jb = i0 - w;  // the key of column 0
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * jn + 2 * qd + (e & 1);
      const bool in = (unsigned)(jb + c) < (unsigned)T;
      const float x = (sc[jn][e] + s2[jn][e]) * p.scale + bias[jn][e] +
                      ((valid >> c) & 1u ? 0.f : kNegBig);
      sc[jn][e] = in ? x : -INFINITY;
      m[e >> 1] = fmaxf(m[e >> 1], sc[jn][e]);
    }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    if (m[r] == -INFINITY) m[r] = 0.f;
  }
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[jn][e] = __expf(sc[jn][e] - m[e >> 1]);
      l[e >> 1] += sc[jn][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = i0 + g + 8 * r;
    if (p.lse != nullptr && qd == 0 && i < T)
      p.lse[(size_t)bh * T + i] = m[r] + logf(l[r]);
    // P = e / l, 0 on an invalid query row and past T
    const bool vq = i < T && (valid >> (w + g + 8 * r)) & 1u;
    const float il = vq ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      sc[jn][2 * r] *= il;
      sc[jn][2 * r + 1] *= il;
    }
  }

  // P rounded to bf16 in registers: the accumulators of n8 key tiles 2 kk
  // and 2 kk + 1 are the A fragment of k16 step kk (the second half zero
  // where NT is odd)
  uint32_t pa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    pa[kk][0] = element::pack2(sc[2 * kk][0], sc[2 * kk][1]);
    pa[kk][1] = element::pack2(sc[2 * kk][2], sc[2 * kk][3]);
    if (2 * kk + 1 < NT) {
      pa[kk][2] = element::pack2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = element::pack2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    } else {
      pa[kk][2] = pa[kk][3] = 0u;
    }
  }

  // O = P.V in fp32, kOC channels a pass, each rounded once to bf16 into
  // the warp's own query rows (read no more)
  __syncwarp();
#pragma unroll
  for (int oc = 0; oc < DB; oc += kOC) {
    float o[kOC / 8][4];
#pragma unroll
    for (int ot = 0; ot < kOC / 8; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[ot][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      // keys 16 kk + 8 .. 16 kk + 15 have no score tile where NT is odd:
      // their B fragments are zeros, and no slab row past the last tile's
      // reach is read
      const bool half = 2 * kk + 1 >= NT;
#pragma unroll
      for (int ot = 0; ot < kOC / 8; ot += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vw + 16 * kk * kS + (half ? voff8 : voff) +
                                  oc + 8 * ot);
        if (half) vf[1] = vf[3] = 0u;
        mma_bf16(o[ot], pa[kk], vf[0], vf[1]);
        mma_bf16(o[ot + 1], pa[kk], vf[2], vf[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t* orow =
          reinterpret_cast<uint32_t*>(qw + (g + 8 * r) * kS + oc + 2 * qd);
#pragma unroll
      for (int ot = 0; ot < kOC / 8; ++ot)
        orow[4 * ot] = element::pack2(o[ot][2 * r], o[ot][2 * r + 1]);
    }
  }
  __syncwarp();
  write_tile<DB, kVec>(p.out, qw, hd, i0, lane);
}

// ---------------------------------------------------------------------------
// The backward (K2, K3)
// ---------------------------------------------------------------------------

// The problem a backward launch solves, its streams of element type E
// (lse and Dr fp32 whatever E is), with the instance run_backward chose.
template <typename E>
struct BandBwdProblem {
  const E* q;
  const E* k;
  const E* v;
  const unsigned char* mask;
  const float* lse;     // (B, H, T)
  const float* dr;      // (B, H, T): rowsum(dout * out), in fp32
  const E* dout;
  E* da;                // dQ (K2) or dK (K3)
  E* db;                // dV (K3); null for K2
  int T, H, D, w;
  float scale;
  int rows_warp;        // owner rows a warp: 32 * rows / rows_warp threads
                        // in fp32; in bf16 16, kMmaThreads a block
  int rows;             // owner rows a tile
  int tiles;            // row tiles a (batch, head)
  int per_block;        // consecutive row tiles a block walks (1 in bf16)
};

// Copy the lse and Dr of rows [r0, r0 + n) of sequence bh into ls and ds,
// 0 outside [0, T).
template <typename E>
__device__ __forceinline__ void copy_row_stats(float* ls, float* ds,
                                               const BandBwdProblem<E>& p,
                                               size_t row0, int r0, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int t = r0 + j;
    const bool live = t >= 0 && t < p.T;
    const size_t off = live ? row0 + t : 0;
    cp_async4(ls + j, p.lse + off, live);
    cp_async4(ds + j, p.dr + off, live);
  }
}

// The fp32 backward, K2 (kKV false: owners are queries, partners keys) and
// K3 (kKV true: owners are keys, partners queries), on the FMA pipes; E is
// float (bf16 streams take band_backward_mma_kernel). A block takes
// p.per_block consecutive row tiles of one (batch, head), warp `warp` owner
// rows warp * RT .. + RT - 1 of each; the warp's partners are the slab rows
// warp * RT .. warp * RT + RT - 1 + 2w, so owner r and partner slab row jj
// (both from the warp's first) are a band pair when 0 <= jj - r <= 2w.
// K2's score is the fp32 forward's bit for bit: the query's channels times
// the scale, each product with the key's channel, summed in the forward's
// order. K3 scales its owner (key) rows, one rounding apart.
template <int DB, bool kVec, bool kKV, int RT, typename E>
__global__ void __launch_bounds__(kBwdThreads<DB>)
band_backward_kernel(const BandBwdProblem<E> p) {
  static_assert(std::is_same_v<E, float>, "bf16 runs the tensor-core body");
  using L = Lane<DB>;
  constexpr int kSh = RT == 4 ? 2 : 3;  // 5 - log2(2 * RT)
  extern __shared__ __align__(16) float bwd_smem[];
  const int w = p.w, R = p.rows, T = p.T;
  const int slab = R + 2 * w;                   // partner rows a tile reaches
  const int stages = p.per_block > 1 ? 2 : 1;
  const int xs = (RT + 2 * w) * RT;             // a warp's tile, partner-major
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  E* as = reinterpret_cast<E*>(bwd_smem);       // stages x slab x DB
  E* bs = as + stages * slab * DB;              // stages x slab x DB
  float* ls = reinterpret_cast<float*>(bs + stages * slab * DB);
                                                // stages x kStage: lse
  float* ds = ls + stages * kStage;             // stages x kStage: Dr
  float* xp = ds + stages * kStage + warp * 2 * xs;  // s, then P
  float* xd = xp + xs;                               // dO . v, then dS
  unsigned char* ms = reinterpret_cast<unsigned char*>(
      ds + stages * kStage + (blockDim.x >> 5) * 2 * xs);  // stages x kStage

  // owner streams in registers, partner streams in the slab
  const E* own_a = kKV ? p.k : p.q;
  const E* own_b = kKV ? p.v : p.dout;
  const E* part_a = kKV ? p.q : p.k;
  const E* part_b = kKV ? p.dout : p.v;

  const int chunks = (p.tiles + p.per_block - 1) / p.per_block;
  const int bh = blockIdx.x / chunks;
  const int t_first = (blockIdx.x - bh * chunks) * p.per_block;
  const int t_end = min(t_first + p.per_block, p.tiles);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const Head hd{(size_t)b * T * p.H * p.D + (size_t)h * p.D, T, p.H * p.D,
                p.D};
  const size_t row0 = (size_t)bh * T;
  const unsigned char* mrow = p.mask + (size_t)b * T;

  // the pair pass's lanes: segments of kseg lanes, lane n of a segment
  // takes band offset n of one owner row, 32 / kseg owner rows a pass
  int kseg = 1;
  while (kseg < 2 * w + 1) kseg <<= 1;
  const int n = lane & (kseg - 1);
  const int seg_row = lane / kseg;

  copy_slab<DB, kVec>(as, bs, part_a, part_b, hd, t_first * R - w, slab);
  copy_row_stats(ls, ds, p, row0, t_first * R - w, slab);
  cp_async_commit();
  for (int j = threadIdx.x; j < slab; j += blockDim.x) {
    const int t = t_first * R - w + j;
    ms[j] = t >= 0 && t < T ? mrow[t] : 0;
  }
  for (int j = lane; j < 2 * xs; j += 32) xp[j] = 0.f;  // 0 outside the band
  float oa[RT][L::kN], ob[RT][L::kN];
  load_rows<DB, kVec, RT>(oa, own_a, hd, t_first * R + warp * RT, lane);
  load_rows<DB, kVec, RT>(ob, own_b, hd, t_first * R + warp * RT, lane);
  cp_async_wait<0>();
  __syncthreads();

  // the value this lane ends the butterfly with: the first dot of owner
  // row vl & (RT - 1) when vl < RT, else its second
  const int vl = (lane >> kSh) & (2 * RT - 1);
  float* const xv = vl < RT ? xp : xd;
  const int rl = vl & (RT - 1);
  for (int t = t_first; t < t_end; ++t) {
    const int s = (t - t_first) & (stages - 1);
    const bool next = t + 1 < t_end;
    unsigned char mnext = 0;
    if (next) {  // the next tile's slab, row stats and mask bytes
      const int r0 = (t + 1) * R - w;
      copy_slab<DB, kVec>(as + (s ^ 1) * slab * DB, bs + (s ^ 1) * slab * DB,
                          part_a, part_b, hd, r0, slab);
      copy_row_stats(ls + (s ^ 1) * kStage, ds + (s ^ 1) * kStage, p, row0,
                     r0, slab);
      cp_async_commit();
      if ((int)threadIdx.x < slab) {
        const int tt = r0 + threadIdx.x;
        mnext = tt >= 0 && tt < T ? mrow[tt] : 0;
      }
    }
    const int i0 = t * R + warp * RT;  // this warp's first owner row
    if (i0 < T) {
      const E* at = as + (s * slab + warp * RT) * DB;
      const E* bt = bs + (s * slab + warp * RT) * DB;
      const float* lt = ls + s * kStage + warp * RT;
      const float* dt = ds + s * kStage + warp * RT;
      const unsigned char* mt = ms + s * kStage + warp * RT;

      // 1. both dots of every band pair: each partner row once, dotted
      // with all RT owner rows, s = a_own . a_part and dO . v
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int e = 0; e < L::kN; ++e) oa[r][e] *= p.scale;
#pragma unroll 2
      for (int jj = 0; jj < RT + 2 * w; ++jj) {
        float ax[L::kN], bx[L::kN];
#pragma unroll
        for (int c = 0; c < L::kNC; ++c) {
          const int ch = jj * DB + c * 32 * L::kVW + lane * L::kVW;
          element::load<L::kVW>(at + ch, ax + c * L::kVW);
          element::load<L::kVW>(bt + ch, bx + c * L::kVW);
        }
        float part[2 * RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float a = 0.f, d = 0.f;
#pragma unroll
          for (int e = 0; e < L::kN; ++e) {
            a = fmaf(oa[r][e], ax[e], a);
            d = fmaf(ob[r][e], bx[e], d);
          }
          part[r] = a;
          part[RT + r] = d;
        }
        const float val = reduce_rows<2 * RT>(part, lane);
        if (jj - rl >= 0 && jj - rl <= 2 * w) xv[jj * RT + rl] = val;
      }
      if (next) {  // the owner rows are used up: fetch the next tile's
        load_rows<DB, kVec, RT>(oa, own_a, hd, i0 + R, lane);
        load_rows<DB, kVec, RT>(ob, own_b, hd, i0 + R, lane);
      }
      __syncwarp();

      // 2. P and dS of each band pair, lanes over (owner, band offset);
      // the owner sits at slab row r + w of the warp's, the partner at
      // r + n. A partner outside the sequence is out by its position.
      for (int r0 = 0; r0 < RT; r0 += 32 / kseg) {
        const int r = r0 + seg_row;
        if (r < RT && n <= 2 * w) {
          const int own = r + w, prt = r + n;
          const int qi = kKV ? prt : own;   // the pair's query
          const int ki = kKV ? own : prt;   // and its key
          const int tp = i0 - w + prt;
          float pv = 0.f, dv = 0.f;
          if (tp >= 0 && tp < T && mt[qi]) {
            const float sc = xp[prt * RT + r] + (mt[ki] ? 0.f : kNegBig);
            pv = expf(sc - lt[qi]);
            dv = pv * (xd[prt * RT + r] - dt[qi]);
          }
          xp[prt * RT + r] = pv;
          xd[prt * RT + r] = dv;
        }
      }
      __syncwarp();

      // 3. accumulate: each partner row once, with the RT owners' dS (K3:
      // and P) as one broadcast
      float acc_a[RT][L::kN], acc_b[kKV ? RT : 1][L::kN];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int e = 0; e < L::kN; ++e) acc_a[r][e] = 0.f;
      if constexpr (kKV) {
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int e = 0; e < L::kN; ++e) acc_b[r][e] = 0.f;
      }
#pragma unroll 2
      for (int jj = 0; jj < RT + 2 * w; ++jj) {
        float ax[L::kN], cd[RT];
#pragma unroll
        for (int c = 0; c < L::kNC; ++c)
          element::load<L::kVW>(
              at + jj * DB + c * 32 * L::kVW + lane * L::kVW,
              ax + c * L::kVW);
        element::load<RT>(xd + jj * RT, cd);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int e = 0; e < L::kN; ++e)
            acc_a[r][e] = fmaf(cd[r], ax[e], acc_a[r][e]);
        if constexpr (kKV) {
          float bx[L::kN], pc[RT];
#pragma unroll
          for (int c = 0; c < L::kNC; ++c)
            element::load<L::kVW>(
                bt + jj * DB + c * 32 * L::kVW + lane * L::kVW,
                bx + c * L::kVW);
          element::load<RT>(xp + jj * RT, pc);
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int e = 0; e < L::kN; ++e)
              acc_b[r][e] = fmaf(pc[r], bx[e], acc_b[r][e]);
        }
      }
      // the partner stream a is unscaled: dQ and dK take the scale here
      store_rows<DB, kVec, RT>(p.da, acc_a, p.scale, hd, i0, lane);
      if constexpr (kKV) store_rows<DB, kVec, RT>(p.db, acc_b, 1.f, hd, i0,
                                                  lane);
    }
    if (next) {
      // every thread's share of the next slab has landed and every warp is
      // done with this stage (and its tiles) before the next tile starts
      if ((int)threadIdx.x < slab)
        ms[(s ^ 1) * kStage + threadIdx.x] = mnext;
      cp_async_wait<0>();
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward on the tensor cores (K2, K3 on bf16 streams)
// ---------------------------------------------------------------------------

// Shared memory of a block of the tensor-core backward: the tiles of both
// owner streams and the slabs of both partner streams (bf16 rows at a
// stride of DB + 8), the slab rows' fp32 lse and Dr and their mask bytes.
size_t mma_backward_smem(int DB, int rows, int nt) {
  return sizeof(bf16) * (DB + 8) * 2 * (rows + mma_slab_rows(rows, nt)) +
         (2 * sizeof(float) + 1) * kStage;
}

// Copy rows j0 .. j0 + n - 1 of one head of the streams a and b into as and
// bs at a row stride of DB + 8, zero where a row lies outside [0, T) or
// `live` or more rows from j0, and past D: 16-byte cp.async copies, or
// plain 2-byte ones in the scalar instance.
template <int DB, bool kVec>
__device__ __forceinline__ void stage_rows(bf16* as, bf16* bs, const bf16* a,
                                           const bf16* b, const Head& hd,
                                           int j0, int n, int live) {
  constexpr int kS = DB + 8;
  constexpr int kW = kVec ? 8 : 1;    // channels a copy
  constexpr int kCh = DB / kW;        // copies a row
  for (int idx = threadIdx.x; idx < n * kCh; idx += blockDim.x) {
    const int r = idx / kCh;
    const int c = kW * (idx - r * kCh);
    const int j = j0 + r;
    const bool ok = r < live && j >= 0 && j < hd.T && c < hd.D;
    const size_t off = ok ? hd.base + (size_t)j * hd.C + c : 0;
    if constexpr (kVec) {
      cp_async16(as + r * kS + c, a + off, ok);
      cp_async16(bs + r * kS + c, b + off, ok);
    } else {
      const bf16 zero = element::from_f32<bf16>(0.f);
      as[r * kS + c] = ok ? a[off] : zero;
      bs[r * kS + c] = ok ? b[off] : zero;
    }
  }
}

// x0 and x1 as bf16 pairs hi = bf16(x) and lo = bf16(x - hi), element 0 in
// the low halves: hi + lo holds each to about 2^-16 of its size, where hi
// alone holds it to 2^-8 (x - hi is exact in fp32).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = element::pack2(x0, x1);
  lo = element::pack2(x0 - element::lo_f32(hi), x1 - element::hi_f32(hi));
}

// The A fragments of a warp's [owner x partner] tile x (NT n8 accumulator
// tiles; those of tiles 2 kk and 2 kk + 1 are k16 step kk, the second half
// zero where NT is odd), split into hi and lo.
template <int NT>
__device__ __forceinline__ void split_tiles(const float (&x)[NT][4],
                                            uint32_t (&hi)[(NT + 1) / 2][4],
                                            uint32_t (&lo)[(NT + 1) / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < (NT + 1) / 2; ++kk) {
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[kk][0], lo[kk][0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[kk][1], lo[kk][1]);
    if (2 * kk + 1 < NT) {
      split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
      split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
    } else {
      hi[kk][2] = hi[kk][3] = lo[kk][2] = lo[kk][3] = 0u;
    }
  }
}

// Y = X . Z for a warp's 16 owner rows: X the [owner x partner] tile as hi
// and lo A fragments (two mma a product), Z the band's partner rows of one
// stream from zw (slab rows, stride DB + 8), each k16 step's B fragments
// ANDed with keep[kk] (a mask word for its first and its second 8 partner
// rows); Y summed in fp32, kOC channels a pass, each times `mul` and
// rounded once to bf16 into the warp's rows at yw.
template <int DB, int NT>
__device__ __forceinline__ void band_product(
    bf16* yw, const uint32_t (&xh)[(NT + 1) / 2][4],
    const uint32_t (&xl)[(NT + 1) / 2][4],
    const uint32_t (&keep)[(NT + 1) / 2][2], const bf16* zw, float mul,
    int lane) {
  constexpr int kS = DB + 8;
  constexpr int kOC = DB > 128 ? 128 : DB;
  const int g = lane >> 2, qd = lane & 3;
  // the rows this lane points at in an ldmatrix.x4.trans: Z's B fragments
  // of one k16 partner step for two n8 channel tiles (partner lane % 16,
  // channels from (lane / 16) * 8), or of its first 8 partners only where
  // the step's second half has no tile (no slab row past the last tile's
  // reach is read)
  const int zoff = (lane & 15) * kS + (lane >> 4) * 8;
  const int zoff8 = (lane & 7) * kS + (lane >> 4) * 8;
#pragma unroll
  for (int oc = 0; oc < DB; oc += kOC) {
    float o[kOC / 8][4];
#pragma unroll
    for (int ot = 0; ot < kOC / 8; ++ot)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[ot][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < (NT + 1) / 2; ++kk) {
      const bool half = 2 * kk + 1 >= NT;
#pragma unroll
      for (int ot = 0; ot < kOC / 8; ot += 2) {
        uint32_t f[4];
        ldmatrix_x4_trans(f, zw + 16 * kk * kS + (half ? zoff8 : zoff) + oc +
                                 8 * ot);
        f[0] &= keep[kk][0];
        f[1] &= keep[kk][1];
        f[2] &= keep[kk][0];
        f[3] &= keep[kk][1];
        mma_bf16(o[ot], xh[kk], f[0], f[1]);
        mma_bf16(o[ot + 1], xh[kk], f[2], f[3]);
        mma_bf16(o[ot], xl[kk], f[0], f[1]);
        mma_bf16(o[ot + 1], xl[kk], f[2], f[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t* orow =
          reinterpret_cast<uint32_t*>(yw + (g + 8 * r) * kS + oc + 2 * qd);
#pragma unroll
      for (int ot = 0; ot < kOC / 8; ++ot)
        orow[4 * ot] =
            element::pack2(o[ot][2 * r] * mul, o[ot][2 * r + 1] * mul);
    }
  }
}

// The bf16 backward on the tensor cores, K2 (kKV false: owners are queries,
// partners keys) and K3 (kKV true: owners are keys, partners queries). A
// block of kMmaThreads takes one tile of p.rows = 16, 32 or 64 owner rows
// of one (batch, head); warp `warp` < p.rows / 16 owns the 16 rows i0 =
// t R + 16 warp .. i0 + 15, an m16 tile, and their band's partners i0 - w
// .. i0 - w + 8 NT - 1, NT n8 tiles (3 up to w = 4, 6 up to w = 15), which
// are the slab rows 16 warp .. 16 warp + 8 NT - 1; the other warps only
// copy. A lane holds the pairs of owner rows g = lane / 4 and g + 8 with
// partner columns 8 jn + 2 (lane % 4) + 0 and 1 (mma.sync's accumulator
// layout): column c is partner i0 - w + c, at band offset c - row, and
// owner row r is column r + w of the same band.
template <int DB, bool kVec, bool kKV, int NT>
__global__ void __launch_bounds__(kMmaThreads)
band_backward_mma_kernel(const BandBwdProblem<bf16> p) {
  constexpr int kS = DB + 8;          // row stride of the tiles (bf16)
  constexpr int KT = (NT + 1) / 2;    // k16 partner steps of the products
  extern __shared__ __align__(16) unsigned char band_bwd_smem[];
  const int w = p.w, R = p.rows, T = p.T;
  const int slab = mma_slab_rows(R, NT);
  bf16* oas = reinterpret_cast<bf16*>(band_bwd_smem);  // owner tiles
  bf16* obs = oas + R * kS;
  bf16* pas = obs + R * kS;                            // partner slabs
  bf16* pbs = pas + slab * kS;
  float* ls = reinterpret_cast<float*>(pbs + slab * kS);  // slab rows' lse
  float* ds = ls + kStage;                                // and Dr
  unsigned char* ms = reinterpret_cast<unsigned char*>(ds + kStage);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, qd = lane & 3;

  const int bh = blockIdx.x / p.tiles;
  const int t = blockIdx.x - bh * p.tiles;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const Head hd{(size_t)b * T * p.H * p.D + (size_t)h * p.D, T, p.H * p.D,
                p.D};
  const unsigned char* mrow = p.mask + (size_t)b * T;
  // the A operands of S and dP (owners) and their B operands (partners)
  const bf16* own_a = kKV ? p.k : p.q;
  const bf16* own_b = kKV ? p.v : p.dout;
  const bf16* part_a = kKV ? p.q : p.k;
  const bf16* part_b = kKV ? p.dout : p.v;

  stage_rows<DB, kVec>(oas, obs, own_a, own_b, hd, t * R, R, R);
  stage_rows<DB, kVec>(pas, pbs, part_a, part_b, hd, t * R - w, slab,
                       R + 2 * w);
  copy_row_stats(ls, ds, p, (size_t)bh * T, t * R - w, slab);
  cp_async_commit();
  for (int j = threadIdx.x; j < slab; j += blockDim.x) {
    const int k = t * R - w + j;
    ms[j] = j < R + 2 * w && k >= 0 && k < T ? mrow[k] : 0;
  }
  const int i0 = t * R + 16 * warp;  // this warp's first owner row
  const bool rows = 16 * warp < R && i0 < T;  // warp-uniform
  cp_async_wait<0>();
  __syncthreads();
  if (!rows) return;

  bf16* aw = oas + 16 * warp * kS;         // the warp's owner rows
  bf16* bw = obs + 16 * warp * kS;
  const bf16* paw = pas + 16 * warp * kS;  // and its band's partners
  const bf16* pbw = pbs + 16 * warp * kS;
  const unsigned char* mw = ms + 16 * warp;
  const float* lw = ls + 16 * warp;
  const float* dw = ds + 16 * warp;
  // the mask over the warp's band, a bit a column (bits past the band's
  // 8 NT columns are never read)
  const uint64_t valid =
      __ballot_sync(0xffffffffu, mw[lane]) |
      (uint64_t)__ballot_sync(0xffffffffu, NT > 4 && mw[32 + lane]) << 32;

  // the rows this lane points at in an ldmatrix.x4: an owner tile's A
  // fragment of one k16 step (row lane % 16, channels from (lane / 16) *
  // 8), a partner slab's B fragments of two k16 steps of one n8 tile
  // (partner lane % 8, channels from (lane / 8) * 8)
  const int aoff = (lane & 15) * kS + (lane >> 4) * 8;
  const int boff = (lane & 7) * kS + (lane >> 3) * 8;

  // S = a_own . a_part^T and dP = b_own . b_part^T, each partner fragment
  // serving its n8 tile; even and odd k16 steps sum into two accumulators
  // that meet at the end, as the forward sums S
  float sc[NT][4], s2[NT][4], dp[NT][4], d2[NT][4];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[jn][e] = s2[jn][e] = dp[jn][e] =
        d2[jn][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DB / 16; kk += 2) {
    uint32_t a0[4], a1[4], b0[4], b1[4];
    ldmatrix_x4(a0, aw + aoff + 16 * kk);
    ldmatrix_x4(a1, aw + aoff + 16 * (kk + 1));
    ldmatrix_x4(b0, bw + aoff + 16 * kk);
    ldmatrix_x4(b1, bw + aoff + 16 * (kk + 1));
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      uint32_t f[4];
      ldmatrix_x4(f, paw + 8 * jn * kS + boff + 16 * kk);
      mma_bf16(sc[jn], a0, f[0], f[1]);
      mma_bf16(s2[jn], a1, f[2], f[3]);
      ldmatrix_x4(f, pbw + 8 * jn * kS + boff + 16 * kk);
      mma_bf16(dp[jn], b0, f[0], f[1]);
      mma_bf16(d2[jn], b1, f[2], f[3]);
    }
  }

  // P = exp(s - lse) and dS = P (dP - Dr) of every band pair in place of S
  // and dP, s the scaled fp32 dot with -1e4 for an invalid key (the
  // forward's expression; __fmul_rn keeps the product from fusing with the
  // mask). A pair outside the band, whose partner lies outside [0, T) or
  // whose query is invalid has P = dS = 0, selected (never multiplied) so
  // that nothing of such a row or column reaches the sums.
  const int jb = i0 - w;  // the partner of column 0
  float lr[2] = {0.f, 0.f}, dr[2] = {0.f, 0.f};  // K2: the rows' lse, Dr
  if constexpr (!kKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lr[r] = lw[w + g + 8 * r];
      dr[r] = dw[w + g + 8 * r];
    }
  }
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    float2 lc = make_float2(0.f, 0.f), dc = lc;  // K3: the columns' lse, Dr
    if constexpr (kKV) {
      lc = *reinterpret_cast<const float2*>(lw + 8 * jn + 2 * qd);
      dc = *reinterpret_cast<const float2*>(dw + 8 * jn + 2 * qd);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * jn + 2 * qd + (e & 1);
      const int r = g + 8 * (e >> 1);
      const int qc = kKV ? c : w + r;  // the pair's query and key, as
      const int kc = kKV ? w + r : c;  // columns of the band
      const bool live = c - r >= 0 && c - r <= 2 * w &&
                        (unsigned)(jb + c) < (unsigned)T &&
                        ((valid >> qc) & 1u);
      const float s = __fmul_rn(sc[jn][e] + s2[jn][e], p.scale) +
                      ((valid >> kc) & 1u ? 0.f : kNegBig);
      const float lse = kKV ? (e & 1 ? lc.y : lc.x) : lr[e >> 1];
      const float drv = kKV ? (e & 1 ? dc.y : dc.x) : dr[e >> 1];
      const float pv = live ? expf(s - lse) : 0.f;
      sc[jn][e] = pv;
      dp[jn][e] = live ? pv * (dp[jn][e] + d2[jn][e] - drv) : 0.f;
    }
  }

  // which partner rows of each k16 step the sums read: none of the second
  // 8 where NT is odd and, in K3, the valid queries only (an invalid
  // query's q and dO meet P = dS = 0 there, and 0 * NaN is NaN in the
  // tensor cores); in K2 the partners are keys, and an in-band invalid key
  // counts, with its -1e4
  uint32_t keep[KT][2];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = 16 * kk + 8 * hf + 2 * qd;
      uint32_t m = 2 * kk + hf < NT ? 0xffffffffu : 0u;
      if constexpr (kKV)
        m &= ((valid >> c) & 1u ? 0x0000ffffu : 0u) |
             ((valid >> (c + 1)) & 1u ? 0xffff0000u : 0u);
      keep[kk][hf] = m;
    }

  // the sums into the warp's own owner rows (read no more): K2 dQ = dS.K,
  // K3 dV = P^T.dO, then dK = dS^T.Q; dQ and dK take the scale here
  __syncwarp();
  {
    uint32_t xh[KT][4], xl[KT][4];
    if constexpr (kKV) {
      split_tiles<NT>(sc, xh, xl);
      band_product<DB, NT>(bw, xh, xl, keep, pbw, 1.f, lane);
    }
    split_tiles<NT>(dp, xh, xl);
    band_product<DB, NT>(aw, xh, xl, keep, paw, p.scale, lane);
  }
  __syncwarp();
  write_tile<DB, kVec>(p.da, aw, hd, i0, lane);
  if constexpr (kKV) write_tile<DB, kVec>(p.db, bw, hd, i0, lane);
}

// ---------------------------------------------------------------------------
// Instances and launches
// ---------------------------------------------------------------------------

bool bad_shape(int B, int T, int H, int D, int w) {
  return B < 1 || T < 1 || H < 1 || D < 1 || D > kMaxD || w < 0 ||
         w > kMaxW;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

cudaError_t sm_count(int* sms) {
  int dev;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// The card's block slots for `kernel` at `threads` threads and `smem` bytes
// of shared memory a block: the SM count times the blocks an SM holds
// (at least 1).
template <typename Kernel>
cudaError_t block_slots(Kernel kernel, int threads, size_t smem,
                        long long* slots) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int sms, per_sm;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  *slots = (long long)sms * (per_sm > 1 ? per_sm : 1);
  return cudaSuccess;
}

// Shared memory of a forward block: the K and V slabs of each stage (of
// `elem`-byte elements), the warps' fp32 score tiles and the stages' mask
// bytes.
size_t forward_smem(int DB, int elem, int rows, int w, int stages) {
  return (size_t)elem * stages * 2 * (rows + 2 * w) * DB +
         sizeof(float) * (size_t)(rows / kRT) * (kRT + 2 * w) * kRT +
         (size_t)stages * kStage;
}

// Shared memory of a backward block: the two partner slabs of each stage
// (of `elem`-byte elements), the stages' fp32 lse and Dr, the warps' two
// fp32 tiles and the stages' mask bytes.
size_t backward_smem(int DB, int elem, int rows, int rows_warp, int w,
                     int stages) {
  return (size_t)elem * stages * 2 * (rows + 2 * w) * DB +
         sizeof(float) * ((size_t)stages * 2 * kStage +
                          (size_t)(rows / rows_warp) * 2 *
                              (rows_warp + 2 * w) * rows_warp) +
         (size_t)stages * kStage;
}

// Blocks of a launch: one a run of per_block tiles of each sequence.
long long grid_blocks(int B, int H, int tiles, int per_block) {
  return (long long)B * H * ((tiles + per_block - 1) / per_block);
}

// The forward's instance for B*H sequences of T rows, half window w, head
// bucket DB, launched as `kernel`: the rows a tile (the one of 64, 48, 32,
// 16 that stages the fewest slab rows, ceil(T / R) * (R + 2w), ties to the
// larger, whose single-stage slab fits) and the tiles a block walks (the
// B*H * tiles over the card's block slots at the occupancy of the
// double-buffered block, rounded to the nearest; 1 where that block does
// not fit). Sets p->rows, p->tiles, p->per_block and the block's shared
// memory.
template <typename Kernel, typename E>
cudaError_t pick_forward(Kernel kernel, int DB, int BH, BandProblem<E>* p,
                         size_t* smem) {
  const int T = p->T, w = p->w;
  constexpr int kElem = sizeof(E);
  constexpr int kTileRows[] = {64, 48, 32, 16};
  long long best = LLONG_MAX;
  for (const int r : kTileRows) {
    const long long cost = (long long)((T + r - 1) / r) * (r + 2 * w);
    if (cost < best && forward_smem(DB, kElem, r, w, 1) <= kSmemMax) {
      best = cost;
      p->rows = r;
    }
  }
  p->tiles = (T + p->rows - 1) / p->rows;
  p->per_block = 1;
  *smem = forward_smem(DB, kElem, p->rows, w, 1);
  const size_t smem2 = forward_smem(DB, kElem, p->rows, w, 2);
  if (p->tiles == 1 || smem2 > kSmemMax) return cudaSuccess;
  long long slots;
  const cudaError_t err = block_slots(kernel, 8 * p->rows, smem2, &slots);
  if (err != cudaSuccess) return err;
  long long walk = ((long long)BH * p->tiles + slots / 2) / slots;
  if (walk > p->tiles) walk = p->tiles;
  if (walk > 1) {
    const int chunks = (int)((p->tiles + walk - 1) / walk);
    p->per_block = (p->tiles + chunks - 1) / chunks;
    *smem = smem2;
  }
  return cudaSuccess;
}

// The tensor-core kernels' instance (forward and backward) for B*H
// sequences of T rows: the rows a tile, R = 16, 32 or 64, the smallest
// that holds T (64 past it), halved while the B*H * ceil(T / R) blocks
// would give the card's SMs fewer than two each; one tile a block. A block
// of kMmaThreads always: where R < 64 its warps past R / 16 only help
// copy. Walking several tiles a block (double-buffered, as the fp32
// forward does) lost at every shape measured for the forward, the problems
// up to 8192 blocks included: it halves the blocks an SM holds, and their
// copies in flight hide the load latency better. Sets *p's rows, tiles and
// per_block (1).
template <typename Problem>
cudaError_t pick_mma(int BH, Problem* p) {
  int sms;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int T = p->T;
  int r = T <= 16 ? 16 : T <= 32 ? 32 : 64;
  while (r > 16 && (long long)BH * ((T + r - 1) / r) < 2LL * sms) r /= 2;
  p->rows = r;
  p->tiles = (T + r - 1) / r;
  p->per_block = 1;
  return cudaSuccess;
}

// The tensor-core forward's instance for *p (bf16 streams, NT key tiles a
// warp) and, with `launch`, its launch.
template <int DB, bool kVec, bool kPE, int NT>
cudaError_t run_mma(BandProblem<bf16>* p, int B, cudaStream_t stream,
                    bool launch) {
  cudaError_t err = pick_mma(B * p->H, p);
  if (err != cudaSuccess || !launch) return err;
  auto kernel = band_forward_mma_kernel<DB, kVec, kPE, NT>;
  const size_t smem = mma_forward_smem(DB, p->rows, NT);
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  const long long blocks = grid_blocks(B, p->H, p->tiles, 1);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kMmaThreads, smem, stream>>>(*p);
  return cudaGetLastError();
}

// Picks the instance of the forward for *p and, with `launch`, launches
// it: fp32 streams take band_forward_kernel, bf16 ones
// band_forward_mma_kernel with the key tiles their w needs.
template <int DB, bool kVec, bool kPE, typename E>
cudaError_t run_forward(BandProblem<E>* p, int B, cudaStream_t stream,
                        bool launch) {
  if constexpr (std::is_same_v<E, bf16>) {
    return mma_key_tiles(p->w) == 3
               ? run_mma<DB, kVec, kPE, 3>(p, B, stream, launch)
               : run_mma<DB, kVec, kPE, 6>(p, B, stream, launch);
  } else {
    auto kernel = band_forward_kernel<DB, kVec, kPE, E>;
    size_t smem;
    cudaError_t err = pick_forward(kernel, DB, B * p->H, p, &smem);
    if (err != cudaSuccess || !launch) return err;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    const long long blocks = grid_blocks(B, p->H, p->tiles, p->per_block);
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, 8 * p->rows, smem, stream>>>(*p);
    return cudaGetLastError();
  }
}

// Sets *p to the backward's instance of RT owner rows a warp and at most
// `walk` tiles a block, its rows a tile the smallest of 16, 32, 48, 64 that
// is at least 4w (the slab rereads at most half a row a row), or the most
// a block of RT rows a warp takes; *slots receives the card's block slots
// for it (0 where its shared memory does not fit) and *smem its shared
// memory.
template <int DB, bool kVec, bool kKV, int RT, typename E>
cudaError_t set_backward(BandBwdProblem<E>* p, int walk, long long* slots,
                         size_t* smem) {
  int rows = 16;
  while (rows < 4 * p->w && rows < 64) rows += 16;
  p->rows_warp = RT;
  p->rows = min(rows, RT * kBwdThreads<DB> / 32);
  p->tiles = (p->T + p->rows - 1) / p->rows;
  p->per_block = min(walk, p->tiles);
  *smem = backward_smem(DB, sizeof(E), p->rows, RT, p->w,
                        p->per_block > 1 ? 2 : 1);
  *slots = 0;
  if (*smem > kSmemMax) return cudaSuccess;
  return block_slots(band_backward_kernel<DB, kVec, kKV, RT, E>,
                     32 * p->rows / RT, *smem, slots);
}

template <int DB, bool kVec, bool kKV, int RT, typename E>
cudaError_t launch_backward(const BandBwdProblem<E>& p, int B, size_t smem,
                            cudaStream_t stream) {
  auto kernel = band_backward_kernel<DB, kVec, kKV, RT, E>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = grid_blocks(B, p.H, p.tiles, p.per_block);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * p.rows / RT, smem, stream>>>(p);
  return cudaGetLastError();
}

// The tensor-core backward's instance for *p (bf16 streams, NT partner
// tiles a warp; 16 owner rows a warp) and, with `launch`, its launch.
template <int DB, bool kVec, bool kKV, int NT>
cudaError_t run_backward_mma(BandBwdProblem<bf16>* p, int B,
                             cudaStream_t stream, bool launch) {
  cudaError_t err = pick_mma(B * p->H, p);
  p->rows_warp = 16;
  if (err != cudaSuccess || !launch) return err;
  auto kernel = band_backward_mma_kernel<DB, kVec, kKV, NT>;
  const size_t smem = mma_backward_smem(DB, p->rows, NT);
  if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
  const long long blocks = grid_blocks(B, p->H, p->tiles, 1);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kMmaThreads, smem, stream>>>(*p);
  return cudaGetLastError();
}

// Picks the instance of the backward (K2, or K3 with kKV) for *p and, with
// `launch`, launches it: bf16 streams take band_backward_mma_kernel with
// the partner tiles their w needs, fp32 ones band_backward_kernel. The
// fp32 rule: the first of (2 owner rows a warp, one tile a block), (4, 1),
// (2, 2), (4, 2) whose blocks all fit the card's block slots at once, at
// that instance's occupancy; (4, 1) where none does. Fewer rows a warp
// make more and shorter warps, which a problem of a few thousand rows
// needs to fill the card; more rows a warp and tiles a block reread less
// once it is full.
template <int DB, bool kVec, bool kKV, typename E>
cudaError_t run_backward(BandBwdProblem<E>* p, int B, cudaStream_t stream,
                         bool launch) {
  if constexpr (std::is_same_v<E, bf16>) {
    return mma_key_tiles(p->w) == 3
               ? run_backward_mma<DB, kVec, kKV, 3>(p, B, stream, launch)
               : run_backward_mma<DB, kVec, kKV, 6>(p, B, stream, launch);
  } else {
    constexpr int kChoices[][2] = {{2, 1}, {4, 1}, {2, 2}, {4, 2}};
    size_t smem = 0;
    bool fits = false;
    for (const auto& c : kChoices) {
      long long slots;
      const cudaError_t err =
          c[0] == 2 ? set_backward<DB, kVec, kKV, 2>(p, c[1], &slots, &smem)
                    : set_backward<DB, kVec, kKV, 4>(p, c[1], &slots, &smem);
      if (err != cudaSuccess) return err;
      if ((fits = grid_blocks(B, p->H, p->tiles, p->per_block) <= slots))
        break;
    }
    if (!fits) {
      long long slots;
      const cudaError_t err =
          set_backward<DB, kVec, kKV, 4>(p, 1, &slots, &smem);
      if (err != cudaSuccess) return err;
    }
    if (!launch) return cudaSuccess;
    return p->rows_warp == 2
               ? launch_backward<DB, kVec, kKV, 2>(*p, B, smem, stream)
               : launch_backward<DB, kVec, kKV, 4>(*p, B, smem, stream);
  }
}

// The smallest head-dim bucket that holds D.
int head_bucket(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// Whether D and every stream of `elem`-byte elements allow 16-byte copies
// (the vector instance: 4 fp32 or 8 bf16 channels a copy) or not (the
// scalar one).
bool vector_streams(int D, int elem,
                    std::initializer_list<const void*> streams) {
  uintptr_t bits = 0;
  for (const void* s : streams) bits |= reinterpret_cast<uintptr_t>(s);
  return D % (16 / elem) == 0 && (bits & 15) == 0;
}

template <bool kVec, bool kPE, typename E>
cudaError_t run_bucket(int bucket, BandProblem<E>* p, int B,
                       cudaStream_t stream, bool launch) {
  switch (bucket) {
    case 32: return run_forward<32, kVec, kPE>(p, B, stream, launch);
    case 64: return run_forward<64, kVec, kPE>(p, B, stream, launch);
    case 128: return run_forward<128, kVec, kPE>(p, B, stream, launch);
    default: return run_forward<256, kVec, kPE>(p, B, stream, launch);
  }
}

// K1, or K4 with `pe`.
template <typename E>
cudaError_t forward(BandProblem<E>* p, int B, bool pe, cudaStream_t stream,
                    bool launch) {
  const int bucket = head_bucket(p->D);
  const bool vec =
      vector_streams(p->D, sizeof(E), {p->q, p->k, p->v, p->out});
  if (pe)
    return vec ? run_bucket<true, true>(bucket, p, B, stream, launch)
               : run_bucket<false, true>(bucket, p, B, stream, launch);
  return vec ? run_bucket<true, false>(bucket, p, B, stream, launch)
             : run_bucket<false, false>(bucket, p, B, stream, launch);
}

template <bool kVec, bool kKV, typename E>
cudaError_t run_backward_bucket(int bucket, BandBwdProblem<E>* p, int B,
                                cudaStream_t stream, bool launch) {
  switch (bucket) {
    case 32: return run_backward<32, kVec, kKV>(p, B, stream, launch);
    case 64: return run_backward<64, kVec, kKV>(p, B, stream, launch);
    case 128: return run_backward<128, kVec, kKV>(p, B, stream, launch);
    default: return run_backward<256, kVec, kKV>(p, B, stream, launch);
  }
}

template <bool kKV, typename E>
cudaError_t backward(BandBwdProblem<E>* p, int B, cudaStream_t stream,
                     bool launch) {
  const int bucket = head_bucket(p->D);
  const bool vec = vector_streams(
      p->D, sizeof(E), {p->q, p->k, p->v, p->dout, p->da, p->db});
  return vec ? run_backward_bucket<true, kKV>(bucket, p, B, stream, launch)
             : run_backward_bucket<false, kKV>(bucket, p, B, stream, launch);
}

// The forward's instance for streams of element type E (no launch): warps
// a block, and for bf16 the n8 key tiles a warp (0 for fp32).
template <typename E>
cudaError_t forward_instance(int B, int T, int H, int D, int w, bool pe,
                             int* rows, int* tiles, int* per_block,
                             int* warps, int* key_tiles) {
  BandProblem<E> p{nullptr, nullptr, nullptr, nullptr, nullptr, 4, nullptr,
                   nullptr, T, H, D, w, 2 * w + 1, 1.f, 0, 0, 0};
  const cudaError_t err = forward(&p, B, pe, nullptr, false);
  constexpr bool kMma = std::is_same_v<E, bf16>;
  *rows = p.rows;
  *tiles = p.tiles;
  *per_block = p.per_block;
  *warps = kMma ? kMmaThreads / 32 : p.rows / kRT;
  *key_tiles = kMma ? mma_key_tiles(w) : 0;
  return err;
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
  BandProblem<float> p{q, k, v, mask, nullptr, 4, out, lse, T, H, D, w, 1,
                       scale, 0, 0, 0};
  return (int)forward(&p, B, false, (cudaStream_t)stream, true);
}

// The same forward with bf16 streams (q, k, v and out); lse stays fp32.
extern "C" int band_attention_forward_bf16(const bf16* q, const bf16* k,
                                           const bf16* v,
                                           const unsigned char* mask,
                                           bf16* out, float* lse, int B,
                                           int T, int H, int D, int w,
                                           float scale, void* stream) {
  if (bad_shape(B, T, H, D, w)) return (int)cudaErrorInvalidValue;
  BandProblem<bf16> p{q, k, v, mask, nullptr, 4, out, lse, T, H, D, w, 1,
                      scale, 0, 0, 0};
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
  BandProblem<float> p{q, k, v, mask, rel_pe, 4, out, nullptr, T, H, D, w,
                       window_size, scale, 0, 0, 0};
  return (int)forward(&p, B, true, (cudaStream_t)stream, true);
}

// The same forward with bf16 streams (q, k, v and out), K4 on the bf16
// path; `rel_pe` is a bf16 table where `pe_elem` is 2, an fp32 one where it
// is 4.
extern "C" int band_attention_pe_forward_bf16(const bf16* q, const bf16* k,
                                              const bf16* v,
                                              const unsigned char* mask,
                                              const void* rel_pe, int pe_elem,
                                              bf16* out, int B, int T, int H,
                                              int D, int w, int window_size,
                                              float scale, void* stream) {
  if (bad_shape(B, T, H, D, w) || window_size < 1 ||
      (pe_elem != 2 && pe_elem != 4))
    return (int)cudaErrorInvalidValue;
  BandProblem<bf16> p{q, k, v, mask, rel_pe, pe_elem, out, nullptr, T, H, D,
                      w, window_size, scale, 0, 0, 0};
  return (int)forward(&p, B, true, (cudaStream_t)stream, true);
}

// The instance the forward (K1, or K4 with `pe`) takes on the current
// device for 16-byte-aligned streams of this shape and `elem`-byte elements
// (4 for fp32, 2 for bf16): query rows a tile, row tiles a (batch, head),
// tiles a block walks, the head-dim bucket, `vec` (1 for the vector
// instance: d % 4 == 0 in fp32, d % 8 == 0 in bf16; 0 for the scalar one),
// warps a block and, for bf16 (band_forward_mma_kernel), the n8 key tiles
// a warp's scores take (its last template argument; 0 for fp32).
extern "C" int band_attention_instance(int B, int T, int H, int D, int w,
                                       int pe, int elem, int* rows,
                                       int* tiles, int* per_block,
                                       int* bucket, int* vec, int* warps,
                                       int* key_tiles) {
  if (bad_shape(B, T, H, D, w) || (elem != 4 && elem != 2))
    return (int)cudaErrorInvalidValue;
  *bucket = head_bucket(D);
  *vec = vector_streams(D, elem, {});
  return (int)(elem == 4
                   ? forward_instance<float>(B, T, H, D, w, pe != 0, rows,
                                             tiles, per_block, warps,
                                             key_tiles)
                   : forward_instance<bf16>(B, T, H, D, w, pe != 0, rows,
                                            tiles, per_block, warps,
                                            key_tiles));
}

namespace {

// dQ (K2), or with kKV dK and dV (K3), for streams of element type E.
template <bool kKV, typename E>
int backward_launch(const E* q, const E* k, const E* v,
                    const unsigned char* mask, const float* lse,
                    const float* dr, const E* dout, E* da, E* db, int B,
                    int T, int H, int D, int w, float scale, void* stream) {
  if (bad_shape(B, T, H, D, w)) return (int)cudaErrorInvalidValue;
  BandBwdProblem<E> p{q, k, v, mask, lse, dr, dout, da, db, T, H, D, w,
                      scale, 0, 0, 0, 0};
  return (int)backward<kKV>(&p, B, (cudaStream_t)stream, true);
}

// The backward's instance for streams of element type E (no launch): as
// forward_instance, and the owner rows a warp.
template <typename E>
cudaError_t backward_instance(int B, int T, int H, int D, int w, bool dkv,
                              int* rows_warp, int* rows, int* tiles,
                              int* per_block, int* warps, int* key_tiles) {
  BandBwdProblem<E> p{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                      nullptr, nullptr, nullptr, T, H, D, w, 1.f, 0, 0, 0,
                      0};
  const cudaError_t err = dkv ? backward<true>(&p, B, nullptr, false)
                              : backward<false>(&p, B, nullptr, false);
  constexpr bool kMma = std::is_same_v<E, bf16>;
  *rows_warp = p.rows_warp;
  *rows = p.rows;
  *tiles = p.tiles;
  *per_block = p.per_block;
  *warps = kMma ? kMmaThreads / 32 : p.rows / max(p.rows_warp, 1);
  *key_tiles = kMma ? mma_key_tiles(w) : 0;
  return err;
}

}  // namespace

// dQ from the forward's inputs, its lse, Dr = rowsum(dout * out) and dout.
extern "C" int band_attention_backward_dq(
    const float* q, const float* k, const float* v,
    const unsigned char* mask, const float* lse, const float* dr,
    const float* dout, float* dq, int B, int T, int H, int D, int w,
    float scale, void* stream) {
  return backward_launch<false>(q, k, v, mask, lse, dr, dout, dq,
                                (float*)nullptr, B, T, H, D, w, scale,
                                stream);
}

// dK and dV from the same inputs as band_attention_backward_dq.
extern "C" int band_attention_backward_dkv(
    const float* q, const float* k, const float* v,
    const unsigned char* mask, const float* lse, const float* dr,
    const float* dout, float* dk, float* dv, int B, int T, int H, int D,
    int w, float scale, void* stream) {
  return backward_launch<true>(q, k, v, mask, lse, dr, dout, dk, dv, B, T,
                               H, D, w, scale, stream);
}

// The same two with bf16 streams (q, k, v, dout and the gradients); lse and
// Dr stay fp32.
extern "C" int band_attention_backward_dq_bf16(
    const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask,
    const float* lse, const float* dr, const bf16* dout, bf16* dq, int B,
    int T, int H, int D, int w, float scale, void* stream) {
  return backward_launch<false>(q, k, v, mask, lse, dr, dout, dq,
                                (bf16*)nullptr, B, T, H, D, w, scale,
                                stream);
}

extern "C" int band_attention_backward_dkv_bf16(
    const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask,
    const float* lse, const float* dr, const bf16* dout, bf16* dk, bf16* dv,
    int B, int T, int H, int D, int w, float scale, void* stream) {
  return backward_launch<true>(q, k, v, mask, lse, dr, dout, dk, dv, B, T,
                               H, D, w, scale, stream);
}

// The instance the dQ kernel (K2), or with `dkv` the dK/dV kernel (K3),
// takes on the current device for 16-byte-aligned streams of this shape
// and `elem`-byte elements (4 for fp32, 2 for bf16): owner rows a warp (2
// or 4 in fp32, 16 in bf16), owner rows a tile, row tiles a (batch, head),
// tiles a block walks and the head-dim bucket; `vec`, warps a block and
// key tiles (for bf16, band_backward_mma_kernel's n8 partner tiles a warp,
// its last template argument; 0 for fp32) as for the forward.
extern "C" int band_attention_backward_instance(
    int B, int T, int H, int D, int w, int dkv, int elem, int* rows_warp,
    int* rows, int* tiles, int* per_block, int* bucket, int* vec, int* warps,
    int* key_tiles) {
  if (bad_shape(B, T, H, D, w) || (elem != 4 && elem != 2))
    return (int)cudaErrorInvalidValue;
  *bucket = head_bucket(D);
  *vec = vector_streams(D, elem, {});
  return (int)(elem == 4
                   ? backward_instance<float>(B, T, H, D, w, dkv != 0,
                                              rows_warp, rows, tiles,
                                              per_block, warps, key_tiles)
                   : backward_instance<bf16>(B, T, H, D, w, dkv != 0,
                                             rows_warp, rows, tiles,
                                             per_block, warps, key_tiles));
}

// The message of a code returned above, for the Python wrapper's error.
extern "C" const char* band_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
