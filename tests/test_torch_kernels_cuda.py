"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: they skip where no CUDA device is present. Run
them on a machine with a card (this file imports neither JAX nor the JAX
package, so the repository's JAX conftest is left out):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerance 2e-5 in fp32 with TF32 off: the kernel and cuBLAS sum the same
products in different orders (K4, the band kernel with the relative-position
bias, adds the bias in the plain version's order). The backward kernels are held to 1e-5 of the
gradient's largest magnitude (sums over the 2w+1 keys of a band and d
channels), the lse to 1e-5 of 1 + |lse|. MEGA's position bias is compared
in gate space (rtol 2e-5, atol 1e-5: the log magnifies rounding near the
relu's zero, and the kernel folds dw/dh through angle identities where the
plain version embeds them), and in log space where it is above -8; the
fused set-attention to 1e-4 of 1 + max |out| (its bias against the plain
bias, then a softmax over up to 3750 keys). The bf16 instances of the band
kernels with and without the bias (K4, K1) and of the full-attention kernel
are held to their bf16 plain versions within
1e-2 of 1 + max |plain| (``BF16_TOL``, ``chip_smoke.py``'s
``BF16_KERNEL_TOL``): both round P and the output to bf16, K7 its
unnormalised P, the plain version the normalised one. The bf16 instances
of the backward kernels (K2, K3: the tensor-core kernel
``band_backward_mma_kernel``) are held to ``band_backward_plain`` on the
same bf16 streams, lse and Dr within the same limit: the same promotions
(P and dS in fp32, which the kernel feeds to the tensor cores as bf16
hi/lo pairs), each gradient rounded to bf16 once, sums taken in another
order. K7's lse and the full attention's backward kernels (K8: dQ, K9: dK
and dV; bf16 on the tensor cores, ``masked_attention_bwd_mma_kernel``) are
held to ``full_attention_lse_plain`` and ``full_attention_backward_plain``
on the same streams, lse and Dr: 1e-5 of 1 + |lse|, 1e-5 of max(1, max
|grad|) in fp32, ``BF16_TOL`` in bf16 (the same rounding points: P and dS
rounded to bf16 before their products, sums in another order).
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from vrdone_tpu_torch.config import ModelConfig, PredictorConfig
from vrdone_tpu_torch.models.layers import AffineDropPath
from vrdone_tpu_torch.models.maskvrd import MaskVRD
from vrdone_tpu_torch.ops import band_attention as ba
from vrdone_tpu_torch.ops import full_attention as fa
from vrdone_tpu_torch.ops import masked as mops
from vrdone_tpu_torch.ops import mega_attention as ma
from vrdone_tpu_torch.ops import position_bias as pb
from vrdone_tpu_torch.utils.precision import cast_floating

pytestmark = pytest.mark.cuda

TOL = 2e-5
BF16_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def streams(seed, b, tq, tk, c, lens, device):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, tq, c)).astype(np.float32)
    k = rng.standard_normal((b, tk, c)).astype(np.float32)
    v = rng.standard_normal((b, tk, c)).astype(np.float32)
    mask = np.arange(tk)[None] < np.asarray(lens)[:, None]
    return [torch.from_numpy(a).to(device) for a in (q, k, v, mask)]


def max_err(a, b):
    return (a - b).abs().max().item()


def shifted(x):
    """A contiguous copy of x whose data start one element (4 bytes in
    fp32, 2 in bf16) past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("t,w,d", [
    (96, 3, 128), (48, 3, 128), (24, 3, 128), (12, 3, 128), (768, 3, 128),
    (300, 4, 64), (37, 9, 32), (5, 3, 128), (3, 9, 16), (1, 3, 8),
    (100, 15, 256), (64, 0, 64)])
def test_band_kernel_matches_plain(cuda, t, w, d):
    """Slice shapes (d 128, w 3), T off the row tile, T < 2w + 1, the
    widest band and head dim the kernel takes, and w = 0."""
    b, h = 4, 4
    q, k, v, mask = streams(t * 31 + w, b, t, t, h * d,
                            [t, max(1, t // 2), 1, 0], cuda)
    mask[0, t // 3] = False  # an invalid key inside a valid stretch
    before = ba.launches
    out = ba.band_attention_cuda(q, k, v, mask, n_head=h,
                                 window_size=2 * w + 1)
    torch.cuda.synchronize()
    assert ba.launches == before + 1
    ref = ba.band_attention_plain(q, k, v, mask, n_head=h,
                                  window_size=2 * w + 1)
    assert max_err(out, ref) <= TOL
    assert (out[3] == 0).all()  # no valid query (and no valid key)


@pytest.mark.parametrize("tq,tk,d,h", [
    (96, 96, 128, 4), (96, 96, 64, 4), (9, 9, 64, 4), (9, 12, 64, 4),
    (384, 384, 128, 4), (384, 384, 64, 4), (5, 100, 32, 4),
    (40, 33, 256, 4), (1, 1, 8, 4),
    # the tiles' edges: 64 or 48 query rows a block (16 up to Tq = 16), 32
    # keys a tile, head dims off their bucket and off a multiple of 4
    (63, 31, 128, 4), (64, 32, 64, 4), (65, 33, 32, 4), (97, 65, 40, 4),
    (129, 31, 30, 4), (16, 65, 40, 4), (17, 32, 30, 4), (33, 64, 256, 4),
    (48, 96, 128, 4), (49, 33, 64, 4), (144, 20, 256, 4),
    # the largest eval bucket, VidOR's S/O cross-attention
    (768, 768, 128, 4), (512, 512, 64, 8)])
def test_full_kernel_matches_plain(cuda, tq, tk, d, h):
    """Slice shapes, Tq != Tk, Tk off the 32-key tile, and a batch row with
    no valid key, which both versions write as 0."""
    b = 4
    q, k, v, mask = streams(tq * 7 + tk, b, tq, tk, h * d,
                            [tk, max(1, tk // 3), 1, 0], cuda)
    before = fa.launches
    out = fa.full_attention_cuda(q, k, v, mask, n_head=h)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.full_attention_plain(q, k, v, mask, n_head=h)
    assert torch.isfinite(out).all()
    assert max_err(out, ref) <= TOL
    assert (out[3] == 0).all()


@pytest.mark.parametrize("tq,d", [(96, 128), (9, 32)])
def test_full_kernel_skips_a_tile_without_valid_keys(cuda, tq, d):
    """A key tile in the middle of a row with no valid key (skipped before
    its copy and any exp), valid keys only in the last, ragged tile, and
    values at invalid keys that are not finite (they never enter the
    sum)."""
    b, h, tk = 3, 4, 100
    q, k, v, mask = streams(tq + d, b, tq, tk, h * d, [tk, tk, tk], cuda)
    mask[0, 32:64] = False        # the second of four tiles
    mask[1, :96] = False          # only keys 96..99
    mask[2, 5:96] = False         # tiles 1 and 2 empty, 0 and 3 not
    v[~mask] = float("nan")
    out = fa.full_attention_cuda(q, k, v, mask, n_head=h)
    v[~mask] = 0.0
    ref = fa.full_attention_plain(q, k, v, mask, n_head=h)
    assert torch.isfinite(out).all()
    assert max_err(out, ref) <= TOL


def test_full_kernel_unaligned_streams_take_the_scalar_path(cuda):
    """Streams whose data start 4 bytes past a 16-byte boundary cannot be
    copied in 16-byte chunks: the same kernel loads them element by
    element."""
    b, tq, tk, h, d = 2, 70, 40, 4, 64
    q, k, v, mask = streams(5, b, tq, tk, h * d, [tk, 17], cuda)
    qs, ks, vs = shifted(q), shifted(k), shifted(v)
    assert qs.data_ptr() % 16 and qs.is_contiguous()
    out = fa.full_attention_cuda(qs, ks, vs, mask, n_head=h)
    assert max_err(out, fa.full_attention_plain(q, k, v, mask, n_head=h)) \
        <= TOL


def test_full_kernel_instance_is_variant(cuda):
    """The built kernel picks the instance that ``_variant`` names, for
    fp32 and for bf16 streams."""
    lib = fa._kernel()
    rows, bucket = ctypes.c_int(), ctypes.c_int()
    for dtype, size in ((torch.float32, 4), (torch.bfloat16, 2)):
        for tq in (1, 9, 16, 17, 48, 64, 65, 96, 97, 192, 384, 512, 768):
            for d in (1, 8, 30, 32, 33, 64, 100, 128, 129, 256):
                assert lib.masked_attention_instance(
                    tq, d, size, ctypes.byref(rows),
                    ctypes.byref(bucket)) == 0
                assert (rows.value, bucket.value) == \
                    fa._variant(tq, d, dtype)


@pytest.mark.parametrize("t,w,d", [
    (96, 3, 128), (48, 3, 128), (12, 3, 128), (768, 3, 128), (37, 9, 32),
    (5, 3, 128), (1, 3, 8), (100, 15, 256), (64, 0, 64)])
def test_band_backward_kernels_match_plain_autograd(cuda, t, w, d):
    """K1's lse, and K2 (dQ) and K3 (dK, dV) through ``BandAttention``
    against autograd of the plain version, with a nonzero upstream gradient
    on the invalid query rows (which must pass nothing back)."""
    b, h = 4, 4
    q, k, v, mask = streams(t * 17 + w, b, t, t, h * d,
                            [t, max(1, t // 2), 1, 0], cuda)
    mask[0, t // 3] = False
    kw = dict(n_head=h, window_size=2 * w + 1)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(t)
                       ).to(cuda)
    with torch.no_grad():
        _, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True, **kw)
        ref_lse = ba.band_lse_plain(q, k, mask, **kw)
    assert ((lse - ref_lse).abs() / (1 + ref_lse.abs())).max() <= 1e-5

    counts = (ba.launches, ba.dq_launches, ba.dkv_launches)
    qk = [x.clone().requires_grad_() for x in (q, k, v)]
    out = mops.band_attention(*qk, mask, **kw)
    got = torch.autograd.grad(out, qk, dout)
    torch.cuda.synchronize()
    assert (ba.launches, ba.dq_launches, ba.dkv_launches) == tuple(
        c + 1 for c in counts)
    qp = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ba.band_attention_plain(*qp, mask, **kw), qp,
                               dout)
    for name, g, r in zip("qkv", got, want):
        assert max_err(g, r) <= 1e-5 * max(1.0, r.abs().max().item()), name
    assert (got[0][3] == 0).all()  # a batch row with no valid query


def pe_table(seed, h, window_size, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((h, window_size))
                            .astype(np.float32)).to(device)


@pytest.mark.parametrize("t,window_size,d", [
    (768, 9, 64), (768, 8, 64), (300, 7, 64), (37, 9, 64), (37, 8, 32),
    (96, 6, 128), (5, 9, 64), (1, 7, 8), (100, 31, 128), (64, 1, 64)])
def test_band_pe_kernel_matches_plain(cuda, t, window_size, d):
    """K4 at the streamed stem's shape (T 768, w 4, d 64), even windows
    (the bias index clamps), T off the row tile, T < 2w + 1, the widest
    band and w = 0, with invalid keys and queries."""
    b, h = 4, 8
    q, k, v, mask = streams(t * 13 + window_size, b, t, t, h * d,
                            [t, max(1, t // 2), 1, 0], cuda)
    mask[0, t // 3] = False  # an invalid key inside a valid stretch
    pe = pe_table(t + window_size, h, window_size, cuda)
    kw = dict(n_head=h, window_size=window_size)
    before = (ba.launches, ba.pe_launches)
    out = ba.band_attention_pe_cuda(q, k, v, mask, pe, **kw)
    torch.cuda.synchronize()
    assert (ba.launches, ba.pe_launches) == (before[0], before[1] + 1)
    ref = ba.band_attention_pe_plain(q, k, v, mask, pe, **kw)
    assert max_err(out, ref) <= TOL
    assert (out[3] == 0).all()  # no valid query (and no valid key)


def test_band_pe_kernel_with_zero_table_is_k1(cuda):
    """K1 and K4 share one forward body: with a zero table K4 gives K1's
    output bit for bit."""
    q, k, v, mask = streams(3, 4, 768, 768, 8 * 64, [768, 300, 1, 0], cuda)
    kw = dict(n_head=8, window_size=9)
    zero = torch.zeros(8, 9, device=cuda)
    assert torch.equal(ba.band_attention_pe_cuda(q, k, v, mask, zero, **kw),
                       ba.band_attention_cuda(q, k, v, mask, **kw))


@pytest.mark.parametrize("t,window_size,d", [
    (768, 9, 64), (96, 8, 64), (37, 7, 32), (5, 9, 16)])
def test_band_pe_autograd_matches_plain(cuda, t, window_size, d):
    """``BandAttentionPE`` (K4 forward, the dense form's recomputed
    autograd as the backward) against autograd of the plain version: dq,
    dk, dv and d rel_pe, with a nonzero upstream gradient on invalid query
    rows."""
    b, h = 4, 8
    q, k, v, mask = streams(t * 7 + window_size, b, t, t, h * d,
                            [t, max(1, t // 2), 1, 0], cuda)
    mask[0, t // 3] = False
    pe = pe_table(t, h, window_size, cuda)
    kw = dict(n_head=h, window_size=window_size)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(t)
                       ).to(cuda)
    counts = (ba.launches, ba.pe_launches, ba.dq_launches, ba.dkv_launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, pe)]
    out = mops.band_attention(*leaves[:3], mask, rel_pe=leaves[3], **kw)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (ba.launches, ba.pe_launches, ba.dq_launches,
            ba.dkv_launches) == (counts[0], counts[1] + 1, *counts[2:])
    ref = [x.clone().requires_grad_() for x in (q, k, v, pe)]
    ref_out = ba.band_attention_pe_plain(*ref[:3], mask, ref[3], **kw)
    want = torch.autograd.grad(ref_out, ref, dout)
    assert max_err(out, ref_out) <= TOL
    for name, g, r in zip(("dq", "dk", "dv", "drel_pe"), got, want):
        assert max_err(g, r) <= 1e-5 * max(1.0, r.abs().max().item()), name
    assert (got[0][3] == 0).all()  # a batch row with no valid query


def band_forward_case(cuda, seed, b, t, h, d, w):
    """K1 with its lse, K4 with a random and with a zero table, against
    their plain versions, on streams with an invalid key inside a valid
    stretch, a batch row of one valid query and one with none."""
    window_size = 2 * w + 1
    lens = ([t, max(1, t // 2), 1, 0] + [t] * (b - 4) if b >= 4
            else [t] * b)
    q, k, v, mask = streams(seed, b, t, t, h * d, lens, cuda)
    mask[0, t // 3] = False
    kw = dict(n_head=h, window_size=window_size)
    out, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True, **kw)
    assert max_err(out, ba.band_attention_plain(q, k, v, mask, **kw)) <= TOL
    ref_lse = ba.band_lse_plain(q, k, mask, **kw)
    assert ((lse - ref_lse).abs() / (1 + ref_lse.abs())).max() <= 1e-5
    pe = pe_table(seed, h, window_size, cuda)
    got = ba.band_attention_pe_cuda(q, k, v, mask, pe, **kw)
    assert max_err(got, ba.band_attention_pe_plain(q, k, v, mask, pe,
                                                   **kw)) <= TOL
    zero = torch.zeros_like(pe)
    assert torch.equal(ba.band_attention_pe_cuda(q, k, v, mask, zero, **kw),
                       out)
    if b >= 4:
        assert (out[3] == 0).all()  # no valid query (and no valid key)


@pytest.mark.parametrize("t,w,d,b,h", [
    # T one below, at and one above a multiple of each row tile the rule
    # picks (16 up to 16 rows, 32, 48, 64; T = 96 and 48 take 48)
    (15, 3, 128, 4, 4), (16, 3, 128, 4, 4), (17, 3, 128, 4, 4),
    (31, 3, 64, 4, 4), (32, 3, 64, 4, 4), (33, 3, 64, 4, 4),
    (47, 3, 128, 4, 4), (48, 3, 128, 4, 4), (49, 3, 128, 4, 4),
    (63, 4, 64, 4, 8), (64, 4, 64, 4, 8), (65, 4, 64, 4, 8),
    (95, 3, 128, 4, 4), (96, 3, 128, 4, 4), (97, 3, 128, 4, 4),
    (767, 4, 64, 4, 8), (768, 4, 64, 4, 8), (769, 4, 64, 4, 8),
    # the paths' shapes: the eval forward (B*H = 128*4, two 48-row tiles
    # a block), the train step, the stream (B*H = 8*8, 64-row tiles)
    (96, 3, 128, 128, 4), (12, 3, 128, 128, 4), (96, 3, 128, 24, 4),
    (768, 4, 64, 8, 8), (96, 4, 64, 8, 8),
    # the widest band and head dim (the slab fits one stage only), w = 0
    (100, 15, 256, 4, 4), (40, 0, 32, 4, 4),
    # head dims off their bucket: 20 takes the vector instance, 33, 18
    # and 6 (d % 4 != 0) the scalar one
    (96, 3, 20, 4, 3), (70, 4, 33, 4, 4), (50, 3, 18, 4, 3),
    (40, 2, 6, 4, 5)])
def test_band_forward_instances_match_plain(cuda, t, w, d, b, h):
    """K1 (with its lse) and K4 at each row-tile instance's edges, at the
    paths' shapes and at head dims off a multiple of 4; a zero table gives
    K1's output bit for bit at each."""
    inst = ba.forward_instance(cuda.index or 0, b, t, h, d, 2 * w + 1)
    assert inst["rows"] in (16, 32, 48, 64)
    assert inst["tiles"] == -(-t // inst["rows"])
    assert inst["vec"] == (d % 4 == 0)
    band_forward_case(cuda, t * 7 + d, b, t, h, d, w)


@pytest.mark.parametrize("t", [1500, 1630])
def test_band_forward_walks_double_buffered_tiles(cuda, t):
    """Enough row tiles (64 sequences of 24 or 26 tiles of 64 rows) that a
    block walks several, double-buffered, the last one padded; on an H100
    (264 block slots) 1630 leaves the last block of a sequence fewer tiles
    than the others."""
    inst = ba.forward_instance(cuda.index or 0, 8, t, 8, 64, 9)
    assert inst["rows"] == 64 and inst["per_block"] > 1
    band_forward_case(cuda, t, 8, t, 8, 64, 4)


def test_band_forward_unaligned_streams_take_the_scalar_instance(cuda):
    """Streams that start 4 bytes past a 16-byte boundary cannot be copied
    16 bytes at a time: the scalar instance takes them, K1 and K4 alike."""
    b, t, h, d = 4, 150, 8, 64
    q, k, v, mask = streams(9, b, t, t, h * d, [t, 70, 1, 0], cuda)
    qs, ks, vs = shifted(q), shifted(k), shifted(v)
    assert qs.data_ptr() % 16 and qs.is_contiguous()
    kw = dict(n_head=h, window_size=9)
    assert max_err(ba.band_attention_cuda(qs, ks, vs, mask, **kw),
                   ba.band_attention_plain(q, k, v, mask, **kw)) <= TOL
    pe = pe_table(9, h, 9, cuda)
    assert max_err(ba.band_attention_pe_cuda(qs, ks, vs, mask, pe, **kw),
                   ba.band_attention_pe_plain(q, k, v, mask, pe, **kw)) \
        <= TOL


def band_backward_case(cuda, seed, b, t, h, d, w, shift=False):
    """K2 (dQ) and K3 (dK, dV) through ``BandAttention`` against autograd of
    the plain version, one launch of each, on streams with an invalid key
    inside a valid stretch, a batch row of one valid query and one with
    none (dQ exactly 0 there), and a nonzero upstream gradient on the
    invalid query rows. With ``shift`` q, k, v and dout start 4 bytes past
    a 16-byte boundary."""
    lens = ([t, max(1, t // 2), 1, 0] + [t] * (b - 4) if b >= 4
            else [t] * b)
    q, k, v, mask = streams(seed, b, t, t, h * d, lens, cuda)
    mask[0, t // 3] = False
    kw = dict(n_head=h, window_size=2 * w + 1)
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        q.shape).astype(np.float32)).to(cuda)
    move = shifted if shift else torch.clone
    leaves = [move(x).requires_grad_() for x in (q, k, v)]
    counts = (ba.dq_launches, ba.dkv_launches)
    got = torch.autograd.grad(mops.band_attention(*leaves, mask, **kw),
                              leaves, move(dout))
    torch.cuda.synchronize()
    assert (ba.dq_launches, ba.dkv_launches) == (counts[0] + 1,
                                                 counts[1] + 1)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ba.band_attention_plain(*ref, mask, **kw),
                               ref, dout)
    for name, g, r in zip("qkv", got, want):
        assert max_err(g, r) <= 1e-5 * max(1.0, r.abs().max().item()), name
    assert (got[0][~mask] == 0).all()  # invalid query rows, row 3 whole


@pytest.mark.parametrize("t,w,d,b,h", [
    # T one below, at and one above a multiple of each row tile (16 rows
    # up to w = 4, 32 up to 8, 48 up to 12, 64 above, at most 32 at 2 rows
    # a warp), for few sequences (B*H = 16) and for many (B*H = 512)
    (15, 3, 128, 4, 4), (16, 3, 128, 4, 4), (17, 3, 128, 4, 4),
    (31, 6, 64, 4, 4), (32, 6, 64, 4, 4), (33, 6, 64, 4, 4),
    (47, 10, 128, 128, 4), (48, 10, 128, 128, 4), (49, 10, 128, 128, 4),
    (63, 14, 64, 64, 8), (64, 14, 64, 64, 8), (65, 14, 64, 64, 8),
    (95, 3, 128, 128, 4), (96, 3, 128, 128, 4), (97, 3, 128, 128, 4),
    # the train step's shapes
    (96, 3, 128, 24, 4), (48, 3, 128, 24, 4), (24, 3, 128, 24, 4),
    (12, 3, 128, 24, 4),
    # VrdONE-X's (configs/vidor_x.yaml) at its 20 pairs
    (512, 4, 64, 20, 8), (256, 4, 64, 20, 8), (128, 4, 64, 20, 8),
    (64, 4, 64, 20, 8),
    # the widest band and w = 0 at head dims 32 and 256; T < 2w + 1
    (100, 15, 256, 4, 4), (64, 0, 256, 4, 4), (70, 15, 32, 4, 4),
    (40, 0, 32, 4, 4), (5, 3, 128, 4, 4), (1, 3, 8, 4, 4),
    # head dims off a multiple of 4: the scalar instance
    (70, 4, 33, 4, 4), (50, 3, 18, 4, 3), (40, 2, 6, 4, 5)])
def test_band_backward_instances_match_plain_autograd(cuda, t, w, d, b, h):
    """K2 and K3 at each instance's edges, at the train steps' shapes and
    at head dims off a multiple of 4; the instance the C side reports is a
    tiling of T."""
    for dkv in (False, True):
        inst = ba.backward_instance(cuda.index or 0, b, t, h, d, 2 * w + 1,
                                    dkv)
        assert inst["rows_warp"] in (2, 4)
        assert inst["rows"] in (16, 32, 48, 64)
        assert inst["tiles"] == -(-t // inst["rows"])
        assert 1 <= inst["per_block"] <= inst["tiles"]
        assert inst["vec"] == (d % 4 == 0)
    band_backward_case(cuda, t * 5 + d, b, t, h, d, w)


@pytest.mark.parametrize("dkv", [False, True])
@pytest.mark.parametrize("t", [96, 80])
def test_band_backward_walks_double_buffered_tiles(cuda, t, dkv):
    """A block walks two row tiles, double-buffered, where that puts every
    block on the card at once: the first batch of 4-head sequences
    (d 128, w 3) at which the kernel's instance walks, with T = 96 (six
    16-row tiles) and T = 80 (five: a block walks one)."""
    b = next((b for b in range(4, 129, 4) if ba.backward_instance(
        cuda.index or 0, b, t, 4, 128, 7, dkv)["per_block"] > 1), None)
    assert b is not None
    band_backward_case(cuda, t + b, b, t, 4, 128, 3)


def test_band_backward_unaligned_streams_take_the_scalar_instance(cuda):
    """q, k, v and dout 4 bytes past a 16-byte boundary: K2 and K3 take
    the scalar instance."""
    band_backward_case(cuda, 9, 4, 150, 8, 64, 4, shift=True)


def test_band_backward_invalid_queries_pass_nothing_back(cuda):
    """An invalid query row's q and upstream gradient reach no gradient:
    changing them leaves dQ, dK and dV bit for bit as they were, and dQ of
    those rows is exactly 0."""
    b, t, h, d, w = 4, 96, 4, 128, 3
    q, k, v, mask = streams(11, b, t, t, h * d, [t, 50, 1, 0], cuda)
    mask[0, 40] = False
    kw = dict(n_head=h, window_size=2 * w + 1)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(4)
                       ).to(cuda)
    grads = []
    for scale in (1.0, 100.0):
        qx, dx = q.clone(), dout.clone()
        qx[~mask] *= scale
        dx[~mask] *= scale
        leaves = [qx.requires_grad_(), k.clone().requires_grad_(),
                  v.clone().requires_grad_()]
        grads.append(torch.autograd.grad(
            mops.band_attention(*leaves, mask, **kw), leaves, dx))
    for g0, g1 in zip(*grads):
        assert torch.equal(g0, g1)
    assert (grads[0][0][~mask] == 0).all()


def traced_kernels(run, path, part: str, seen_all) -> list:
    """(name, grid, block) of each kernel whose name matches the regex
    ``part`` in ``torch.profiler`` runs of ``run`` (three calls a run, each
    followed by a synchronize), profiled again (up to three runs) until
    ``seen_all(found)`` holds: the profiler misses some launches made
    through ``ctypes``. Every run's kernels are returned, so a check on each
    of them holds on every trace taken."""
    import json
    import re

    from torch.profiler import ProfilerActivity, profile
    found = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run()
                torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        found += [(e["name"], e["args"]["grid"], e["args"]["block"])
                  for e in json.loads(path.read_text())["traceEvents"]
                  if e.get("cat") == "kernel"
                  and re.search(part, e.get("name", ""))]
        if seen_all(found):
            break
    return found


def test_band_backward_instance_is_what_launches(cuda, tmp_path):
    """The instance ``backward_instance`` reports is the one the C side
    launches: the kernel's template arguments (head-dim bucket, vector or
    scalar copies, K2 or K3, owner rows a warp), its grid and its block,
    read from a ``torch.profiler`` trace."""
    import re
    for b, t, h, d, w in ((24, 96, 4, 128, 3), (24, 12, 4, 128, 3),
                          (128, 48, 4, 128, 3), (8, 1500, 8, 64, 4),
                          (4, 70, 4, 33, 4)):
        q, k, v, mask = streams(t + d, b, t, t, h * d, [t] * b, cuda)
        kw = dict(n_head=h, window_size=2 * w + 1)
        dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            t)).to(cuda)
        out, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True, **kw)
        args = (q, k, v, mask, lse, ba.band_rowsum(dout, out, h), dout)
        seen = set()
        for name, grid, block in traced_backward_kernels(
                args, kw, tmp_path / f"trace{t}.json"):
            m = re.search(r"band_backward_kernel<(\d+), (true|false), "
                          r"(true|false), (\d+), (\w+)>", name)
            if m is None:
                continue
            assert m[5] == "float"
            dkv = m[3] == "true"
            inst = ba.backward_instance(cuda.index or 0, b, t, h, d,
                                        2 * w + 1, dkv)
            assert (int(m[1]), m[2] == "true", int(m[4])) == (
                inst["bucket"], inst["vec"], inst["rows_warp"])
            blocks = b * h * -(-inst["tiles"] // inst["per_block"])
            assert grid == [blocks, 1, 1]
            assert block == [32 * inst["rows"] // inst["rows_warp"], 1, 1]
            seen.add(dkv)
        assert seen == {False, True}, (b, t, h, d, w)


def test_kernels_without_backward_refuse_grad(cuda):
    """A CUDA tensor that needs a gradient cannot pass through a kernel
    launch that has no backward."""
    q, k, v, mask = streams(1, 2, 16, 16, 64, [16, 8], cuda)
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ba.band_attention_cuda(q, k, v, mask, n_head=4, window_size=7)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.full_attention_cuda(q, k, v, mask, n_head=4)
    pe = torch.zeros(4, 7, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ba.band_attention_pe_cuda(q, k, v, mask, pe, n_head=4, window_size=7)
    with torch.no_grad():
        ba.band_attention_cuda(q, k, v, mask, n_head=4, window_size=7)
        ba.band_attention_pe_cuda(q, k, v, mask, pe, n_head=4, window_size=7)
        fa.full_attention_cuda(q, k, v, mask, n_head=4)
    # the dispatch picks the differentiable forms instead
    fa.dense_calls = 0
    out = mops.full_attention(q, k, v, mask, n_head=4, allow_kernel=False)
    assert out.grad_fn is not None and fa.dense_calls == 1
    assert mops.band_attention(q, k, v, mask, n_head=4,
                               window_size=7).grad_fn is not None
    assert mops.band_attention(q, k, v, mask, n_head=4, window_size=7,
                               rel_pe=pe).grad_fn is not None


def small_train_case():
    """A small MaskVRD's config (drop path on), a training config and a
    batch of 4 items with 1 to 3 ground-truth segments each."""
    cfg = ModelConfig(visual_dim=24, embd_dim=32, fpn_dim=16,
                      max_seq_len=48, with_fuzzy=True, scale_range=0.85,
                      predictor=PredictorConfig(
                          n_input=32, n_embd=16, n_hidden=64, num_layers=3,
                          num_queries=9))
    tc = {"type": "AdamW", "training_lr": 1e-4, "weight_decay": 0.05,
          "clip_grad_l2norm": 1.0, "warmup": True, "warmup_epochs": 1,
          "total_epoch": 2}
    rng = np.random.default_rng(2)
    b, t, g = 4, 48, 9
    lens = np.array([48, 30, 17, 5])
    seq = np.arange(t)[None] < lens[:, None]
    gm = np.zeros((b, g, t), np.float32)
    segs = np.zeros((b, g, 2), np.int32)
    gv = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(int(rng.integers(1, 4))):
            s = int(rng.integers(0, lens[i] - 1))
            e = int(rng.integers(s + 1, lens[i] + 1))
            gm[i, j, s:e], segs[i, j], gv[i, j] = 1, (s, e), True
    batch = {"feats": rng.standard_normal((b, t, 2 * 24 + 5 + 16))
             .astype(np.float32) * seq[..., None],
             "seq_mask": seq, "item_valid": np.ones(b, bool),
             "gt_labels": rng.integers(1, 133, (b, g)).astype(np.int32),
             "gt_masks": gm, "gt_segs": segs, "gt_valid": gv}
    return cfg, tc, batch


def test_train_step_on_card_matches_cpu(cuda):
    """One train step of a small MaskVRD with drop path on: the card (band
    kernels forward and backward, dense full attention) against the CPU on
    the same weights, batch and drop-path draws."""
    from vrdone_tpu_torch.train.loop import (create_train_state,
                                             step_generator, train_step)
    cfg, tc, batch = small_train_case()
    states = {}
    for dev in (torch.device("cpu"), cuda):
        states[dev.type], _ = create_train_state(
            cfg, tc, 1, device=dev, generator=torch.Generator().manual_seed(0))
    losses = {}
    ba.launches = ba.dq_launches = ba.dkv_launches = fa.launches = 0
    for name, state in states.items():
        dev = next(state.model.parameters()).device
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        for step in range(2):
            _, losses[name, step] = train_step(state, tb,
                                               step_generator(0, step))
    torch.cuda.synchronize()
    band = 2 * cfg.backbone_arch[1] + cfg.backbone_arch[2]
    assert (ba.launches, ba.dq_launches, ba.dkv_launches,
            fa.launches) == (2 * band, 2 * band, 2 * band, 0)
    for step in range(2):
        for k, v in losses["cpu", step].items():
            assert abs(losses["cuda", step][k].item() - v.item()) <= 1e-4 * (
                1 + abs(v.item())), (k, step)
    # the gradients, through Adam's first moments (noise-level gradients of
    # key biases make sign-like Adam steps differ, so parameters are held
    # only to twice the largest step, 2 * lr)
    for m, r in zip(states["cuda"].optimizer.moments["mu"],
                    states["cpu"].optimizer.moments["mu"]):
        assert max_err(m.cpu(), r) <= 1e-3 * r.abs().max().item() + 1e-7
    for p, r in zip(states["cuda"].params(), states["cpu"].params()):
        assert max_err(p.cpu(), r) <= 2e-4


@pytest.mark.parametrize("remat", [False, True])
def test_bf16_train_step_on_card_matches_cpu(cuda, remat):
    """One bf16 train step of a small MaskVRD with drop path on (with and
    without remat, policy "dots"): the card launches only the bf16
    instances of the band kernels, K1 once a band layer (twice under remat,
    whose recompute runs the forward again) and K2 and K3 once, and its
    losses agree with the CPU's bf16 step on the same weights, batch and
    draws within 5e-2 of 1 + |loss| (tests/test_torch_bf16_train.py's
    BF16_LOSS_TOL: both round to bf16 in their own places, and the kernels'
    backward keeps P in fp32 where autograd of the plain version reads the
    forward's rounded P); the masters stay fp32."""
    import dataclasses

    from vrdone_tpu_torch.train.loop import (create_train_state,
                                             step_generator, train_step)
    cfg, tc, batch = small_train_case()
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16", remat=remat,
                              remat_policy="dots")
    losses = {}
    counts = dict(launches=0, bf16_launches=0, dq_launches=0,
                  bf16_dq_launches=0, dkv_launches=0, bf16_dkv_launches=0)
    for name, value in counts.items():
        setattr(ba, name, value)
    fa.launches = 0
    for dev in (torch.device("cpu"), cuda):
        state, _ = create_train_state(
            cfg, tc, 1, device=dev, generator=torch.Generator().manual_seed(0))
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _, losses[dev.type] = train_step(state, tb, step_generator(0, 0))
        assert all(x.dtype == torch.float32 for x in state.params())
    torch.cuda.synchronize()
    band = 2 * cfg.backbone_arch[1] + cfg.backbone_arch[2]
    k1 = 2 * band if remat else band
    assert {n: getattr(ba, n) for n in counts} == dict(
        launches=k1, bf16_launches=k1, dq_launches=band,
        bf16_dq_launches=band, dkv_launches=band, bf16_dkv_launches=band)
    assert fa.launches == 0
    for k, v in losses["cpu"].items():
        assert abs(losses["cuda"][k].item() - v.item()) <= 5e-2 * (
            1 + abs(v.item())), k


def test_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, mask = streams(0, 2, 16, 16, 64, [16, 8], cuda)
    with pytest.raises(TypeError, match="float32"):
        ba.band_attention_cuda(q.double(), k, v, mask, n_head=4,
                               window_size=7)
    with pytest.raises(ValueError, match="contiguous"):
        fa.full_attention_cuda(q.transpose(0, 1), k, v, mask, n_head=4)
    with pytest.raises(ValueError, match="half window"):
        ba.band_attention_cuda(q, k, v, mask, n_head=4, window_size=33)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.full_attention_cuda(q, k, v, mask.cpu(), n_head=4)
    with pytest.raises(ValueError, match="rel_pe"):
        ba.band_attention_pe_cuda(q, k, v, mask, torch.zeros(4, 8,
                                                             device=cuda),
                                  n_head=4, window_size=7)


def test_model_forward_on_card_matches_cpu(cuda):
    """A small MaskVRD: the CUDA forward (through both kernels) against the
    CPU forward (plain versions) on the same weights, and the launches."""
    cfg = ModelConfig(visual_dim=24, embd_dim=32, fpn_dim=16,
                      max_seq_len=48, predictor=PredictorConfig(
                          n_input=32, n_embd=16, n_hidden=64, num_layers=3))
    gen = torch.Generator().manual_seed(0)
    cpu = MaskVRD(cfg, device=torch.device("cpu"), generator=gen)
    with torch.no_grad():
        # drop-path scales near 1, so every attention branch moves the
        # output (the 1e-4 of the reference init would hide one)
        for m in cpu.modules():
            if isinstance(m, AffineDropPath):
                m.scale.uniform_(0.5, 1.5, generator=gen)
    gpu = MaskVRD(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (3, 48, 2 * 24 + 5 + 16)).astype(np.float32))
    mask = torch.from_numpy(np.arange(48)[None]
                            < np.array([48, 24, 11])[:, None])
    ba.launches = fa.launches = 0
    with torch.no_grad():
        out = gpu(x.to(cuda), mask.to(cuda))
        torch.cuda.synchronize()
        # band: 2 stem blocks x 2 streams + the branch blocks; full: self
        # and cross attention of each S/O mutual layer and decoder layer
        assert ba.launches == 2 * cfg.backbone_arch[1] + cfg.backbone_arch[2]
        assert fa.launches == (4 * cfg.backbone_arch[1]
                               + 2 * cfg.predictor.num_layers)
        ref = cpu(x, mask)
    for key in ("pred_logits", "pred_masks"):
        assert max_err(out[key].cpu(), ref[key]) <= 5e-4, key


# VrdONE-X (configs/vidor_x.yaml) at its eval width: K1 fp32 in the stem
# and the three branch levels (8 heads of 64, window 9, T = 512 down to
# 64), K7 fp32 in the S/O mutual attention (512 x 512, d = 64) and the
# predictor (10 queries against themselves and the coarsest level, d = 32)
@pytest.mark.parametrize("kind,tq,tk,d", [
    ("band", 512, 512, 64), ("band", 256, 256, 64), ("band", 128, 128, 64),
    ("band", 64, 64, 64), ("full", 512, 512, 64), ("full", 10, 10, 32),
    ("full", 10, 64, 32)])
def test_vrdone_x_shapes_match_plain(cuda, kind, tq, tk, d):
    b, h = 16, 8
    lens = np.random.default_rng(tq + tk).integers(2, tk + 1, b)
    lens[0] = tk
    q, k, v, mask = streams(tq * 7 + tk + d, b, tq, tk, h * d, lens, cuda)
    if kind == "band":
        kw = dict(n_head=h, window_size=9)
        out = ba.band_attention_cuda(q, k, v, mask, **kw)
        ref = ba.band_attention_plain(q, k, v, mask, **kw)
    else:
        out = fa.full_attention_cuda(q, k, v, mask, n_head=h)
        ref = fa.full_attention_plain(q, k, v, mask, n_head=h)
    assert max_err(out, ref) <= TOL


def test_clip_model_forward_on_card_matches_cpu(cuda):
    """A small VrdONE-X (CLIP-fused backbone, 12 CLIP channels a stream):
    the CUDA forward against the CPU forward on the same weights, through
    K1 and K7 only, as many times as without CLIP."""
    cfg = ModelConfig(visual_dim=24, embd_dim=32, fpn_dim=16,
                      max_seq_len=48, with_clip_feature=True, clip_dim=12,
                      predictor=PredictorConfig(
                          n_input=32, n_embd=16, n_hidden=64, num_layers=3))
    gen = torch.Generator().manual_seed(2)
    cpu = MaskVRD(cfg, device=torch.device("cpu"), generator=gen)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, AffineDropPath):
                m.scale.uniform_(0.5, 1.5, generator=gen)
    gpu = MaskVRD(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal(
        (3, 48, 2 * 24 + 2 * 12 + 5 + 16)).astype(np.float32))
    mask = torch.from_numpy(np.arange(48)[None]
                            < np.array([48, 24, 11])[:, None])
    ba.launches = fa.launches = ba.pe_launches = 0
    with torch.no_grad():
        out = gpu(x.to(cuda), mask.to(cuda))
        torch.cuda.synchronize()
        assert ba.launches == 2 * cfg.backbone_arch[1] + cfg.backbone_arch[2]
        assert fa.launches == (4 * cfg.backbone_arch[1]
                               + 2 * cfg.predictor.num_layers)
        assert ba.pe_launches == 0
        ref = cpu(x, mask)
    for key in ("pred_logits", "pred_masks"):
        assert max_err(out[key].cpu(), ref[key]) <= 5e-4, key


def test_model_with_rel_pe_on_card_matches_cpu(cuda):
    """A small MaskVRD with ``use_local`` and ``use_rel_pe``: the CUDA
    forward (K4 in the stem and branch blocks, K1 in the S/O mutual layers,
    K7 in the predictor) against the CPU forward on the same weights."""
    cfg = ModelConfig(visual_dim=24, embd_dim=32, fpn_dim=16,
                      max_seq_len=48, use_local=True, use_rel_pe=True,
                      predictor=PredictorConfig(
                          n_input=32, n_embd=16, n_hidden=64, num_layers=3))
    gen = torch.Generator().manual_seed(1)
    cpu = MaskVRD(cfg, device=torch.device("cpu"), generator=gen)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, AffineDropPath):
                m.scale.uniform_(0.5, 1.5, generator=gen)
    gpu = MaskVRD(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(
        (3, 48, 2 * 24 + 5 + 16)).astype(np.float32))
    mask = torch.from_numpy(np.arange(48)[None]
                            < np.array([48, 24, 11])[:, None])
    ba.launches = ba.pe_launches = fa.launches = 0
    with torch.no_grad():
        out = gpu(x.to(cuda), mask.to(cuda))
        torch.cuda.synchronize()
        arch = cfg.backbone_arch
        assert (ba.pe_launches, ba.launches, fa.launches) == (
            2 * arch[1] + arch[2], 4 * arch[1], 2 * cfg.predictor.num_layers)
        ref = cpu(x, mask)
    for key in ("pred_logits", "pred_masks"):
        assert max_err(out[key].cpu(), ref[key]) <= 5e-4, key


def mega_case(seed, g, n, m, dg, dgo, p_valid, device, canvas=(608, 1088)):
    """Fused-attention operands as the detector makes them: rois on a
    canvas, Wg drawn as initialised (normal(0.01))."""
    rng = np.random.default_rng(seed)

    def boxes(k):
        xy = rng.uniform(0, 1, (k, 2)) * (canvas[1], canvas[0])
        wh = rng.uniform(8, 300, (k, 2))
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)

    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((g, n, dg), (g, m, dg), (g, m, dgo))]
    arrays.append(0.1 * rng.standard_normal((g, m)).astype(np.float32))
    arrays.append(rng.uniform(size=m) < p_valid)
    arrays += [boxes(n), boxes(m),
               rng.normal(0, 0.01, (64, g)).astype(np.float32),
               rng.normal(0, 0.01, (g,)).astype(np.float32)]
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


def gate_space_ok(got, want):
    """Gate space everywhere; log space where the bias is above -8, where
    its atol 3e-2 is the gate's 1e-5 carried through the log. (Nearer the
    floor a gate error of 1e-6, what fp32 sines of the 360-radian dw/dh
    angles give between the folded and the embedded forms, is more than
    3e-2 in log space: at the detector's 40 million values some reach it
    above -10.)"""
    eg, ew = got.exp(), want.exp()
    assert ((eg - ew).abs() <= 1e-5 + 2e-5 * ew.abs()).all()
    sel = want > -8
    assert ((got - want)[sel].abs() <= 3e-2 + 1e-3 * want[sel].abs()).all()


@pytest.mark.parametrize("n,m,g", [
    (675, 3750, 16), (300, 750, 16), (37, 101, 16), (1, 1, 1), (9, 130, 32),
    (5, 257, 4)])
def test_position_bias_kernel_matches_plain(cuda, n, m, g):
    """The detector's shapes, ragged tiles, the largest group count."""
    *_, qr, kr, w, b = mega_case(n + m, g, n, m, 1, 1, 1.0, cuda)
    qr[-1] = 0.0   # a degenerate (padding) box stays finite
    before = pb.launches
    got = pb.fused_position_bias(qr, kr, w, b)
    torch.cuda.synchronize()
    assert pb.launches == before + 1
    want = pb.position_bias_plain(qr, kr, w, b)
    assert got.shape == (g, n, m) and torch.isfinite(got).all()
    gate_space_ok(got, want)


def bias_args(seed, g, n, m, cuda, *, size=(8, 300), w_scale=0.01,
              b_scale=0.01):
    """Rois of widths and heights drawn apart in ``size`` on the detector's
    canvas, and Wg (64, g) as the head passes it (``l_Wg.weight.T``, a
    transposed view) with its bias."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (n + m, 2)) * (1088, 608)
    rois = np.concatenate([xy, xy + rng.uniform(*size, (n + m, 2))], 1)
    w = rng.normal(0, w_scale, (g, 64)).astype(np.float32)
    b = rng.normal(0, b_scale, (g,)).astype(np.float32)
    qr, kr, w, b = (torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
                    for a in (rois[:n], rois[n:], w, b))
    return qr, kr, w.T, b


@pytest.mark.parametrize("n,m,g", [
    (675, 3750, 16), (675, 750, 16), (300, 750, 16),   # the local stages
    (13, 77, 1), (1, 1, 4), (37, 101, 5), (9, 130, 32), (5, 0, 4)])
def test_bias_factors_match_pe_setup(cuda, n, m, g):
    """One bias_factors launch against the torch chain it replaces, both
    fp32 sines of the same angles on the card."""
    qr, kr, w, b = bias_args(n * m + g, g, n, m, cuda)
    before = pb.factor_launches
    _, _, a, b_t, wt, _, freqs = pb.bias_operands(qr, kr, w, b)
    torch.cuda.synchronize()
    assert pb.factor_launches == before + 1
    f_ref, a_ref, bt_ref, wt_ref = pb.pe_setup(qr, kr, w)
    assert tuple(freqs) == f_ref
    assert (a.shape, b_t.shape, wt.shape) == ((g, n, 32), (32, m), (g, 32))
    assert torch.equal(wt, wt_ref)
    assert max_err(a, a_ref) <= 1e-5 * (1 + a_ref.abs().max().item())
    assert m == 0 or max_err(b_t, bt_ref) <= 1e-5


@pytest.mark.parametrize("case", [
    "two m-tiles", "one group", "padded groups", "one row", "one key",
    "odd keys", "large aspect ratios", "near-zero gates"])
def test_position_bias_kernel_edges(cuda, case):
    """G = 32 (two m-tiles), G < 16 (zero-padded weights, rows not
    stored), N or M of 1, an odd M (scalar stores), boxes of extreme aspect
    ratios (angles near the top of the range), and gates near the relu's
    zero; in gate space as above."""
    n, m, g, kw = {
        "two m-tiles": (300, 750, 32, {}),
        "one group": (37, 130, 1, {}),
        "padded groups": (675, 750, 5, {}),
        "one row": (1, 3750, 16, {}),
        "one key": (675, 1, 16, {}),
        "odd keys": (13, 777, 16, {}),
        "large aspect ratios": (300, 750, 16, dict(size=(1, 1000))),
        "near-zero gates": (300, 750, 16, dict(w_scale=1e-3, b_scale=0.0)),
    }[case]
    qr, kr, w, b = bias_args(n + 3 * m + g, g, n, m, cuda, **kw)
    before = (pb.launches, pb.factor_launches)
    got = pb.fused_position_bias(qr, kr, w, b)
    torch.cuda.synchronize()
    assert (pb.launches, pb.factor_launches) == (before[0] + 1,
                                                 before[1] + 1)
    want = pb.position_bias_plain(qr, kr, w, b)
    assert got.shape == (g, n, m) and torch.isfinite(got).all()
    gate_space_ok(got, want)


def test_pe_setup_is_off_the_card_path(cuda, monkeypatch):
    """The torch chain never runs for a CUDA tensor: with pe_setup made to
    raise, the position bias and a biased set-attention still run, each
    through one bias_factors launch."""
    q, k, vp, ub, valid, *bias = mega_case(9, 16, 300, 750, 64, 64, 0.9,
                                           cuda)
    want_bias = pb.position_bias_plain(*bias)
    want = ma.mega_attention_plain(q, k, vp, ub, valid, *bias)

    def refuse(*args, **kwargs):
        raise AssertionError("pe_setup ran on the card path")

    monkeypatch.setattr(pb, "pe_setup", refuse)
    before = pb.factor_launches
    got_bias = pb.fused_position_bias(*bias)
    got = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    torch.cuda.synchronize()
    assert pb.factor_launches == before + 2
    gate_space_ok(got_bias, want_bias)
    assert max_err(got, want) <= 1e-4 * (1 + want.abs().max().item())


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("g,n,m,dg,dgo,p_valid", [
    (16, 675, 3750, 64, 64, 0.9),     # local stage 0
    (16, 675, 750, 64, 64, 0.9),      # local stage 1
    (16, 300, 750, 64, 64, 0.9),      # local stage 2, global
    (16, 1875, 750, 64, 64, 0.9),     # global over the window
    (4, 10, 12, 256, 256, 0.7),       # the small detector's groups
    (5, 13, 77, 30, 40, 0.5),         # widths off the float4 path
    (16, 37, 101, 16, 24, 0.3),
    (2, 3, 1, 8, 8, 1.0)])
def test_mega_attention_kernel_matches_plain(cuda, with_bias, g, n, m, dg,
                                             dgo, p_valid):
    q, k, vp, ub, valid, *bias = mega_case(n * 7 + m, g, n, m, dg, dgo,
                                           p_valid, cuda)
    bias = bias if with_bias else []
    before = ma.launches
    got = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    torch.cuda.synchronize()
    assert ma.launches == before + 1
    want = ma.mega_attention_plain(q, k, vp, ub, valid, *bias)
    assert got.shape == (n, g * dgo) and torch.isfinite(got).all()
    assert max_err(got, want) <= 1e-4 * (1 + want.abs().max().item())


@pytest.mark.parametrize("m", [1, 40, 3750])
def test_mega_attention_all_invalid_rows_are_zero(cuda, m):
    """No valid key (and so no finite score) anywhere: exactly 0, no NaN."""
    q, k, vp, ub, valid, *bias = mega_case(m, 16, 33, m, 64, 64, 0.0, cuda)
    for extra in ([], bias):
        out = ma.fused_mega_attention(q, k, vp, ub, valid, *extra)
        torch.cuda.synchronize()
        assert (out == 0).all()


def mega_split_case(seed, n, m, cuda, with_bias):
    """A 16-group, 64-wide case whose keys the kernel cuts into more than
    one split (checked), and the plain version's output."""
    q, k, vp, ub, valid, *bias = mega_case(seed, 16, n, m, 64, 64, 0.9, cuda)
    bias = bias if with_bias else []
    assert ma.launch_plan(q.device.index, n, m, 16, 64, 64)[1] > 1
    return q, k, vp, ub, valid, bias


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("n,m", [
    (675, 3750),    # stage 0, every split full
    (300, 1001),    # M not a multiple of the splits' whole tiles
    (1, 3750),      # one query row
    (5, 777)])      # fewer rows than a block holds
def test_mega_attention_split_keys_match_plain(cuda, with_bias, n, m):
    q, k, vp, ub, valid, bias = mega_split_case(n + m, n, m, cuda, with_bias)
    got = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    torch.cuda.synchronize()
    want = ma.mega_attention_plain(q, k, vp, ub, valid, *bias)
    assert got.shape == (n, 16 * 64) and torch.isfinite(got).all()
    assert max_err(got, want) <= 1e-4 * (1 + want.abs().max().item())


def dense_with_bias(q, k, vp, ub, valid, bias):
    """The set-attention's dense form in float64 around a given (g, N, M)
    bias (0 for none)."""
    q, k, vp, ub, bias = (t.double() for t in (q, k, vp, ub, bias))
    aff = torch.einsum("gnd,gmd->gnm", q, k) / q.shape[-1] ** 0.5
    aff = torch.where(valid, aff + ub[:, None, :] + bias, -1e9)
    att = torch.softmax(aff, dim=-1) * valid
    out = torch.einsum("gnm,gmo->gno", att, vp)
    return out.transpose(0, 1).reshape(q.shape[1], -1).float()


def softmax_bounds(scores, gate):
    """The least and the most of softmax(scores + log gate') over the last
    axis, in float64, for every gate' within the position bias's gate-space
    tolerance of ``gate`` (relu + 1e-6, so never below 1e-6): each
    probability rises with its own gate and falls with the others'."""
    d = 1e-5 + 2e-5 * gate
    up = scores + torch.log(gate + d)
    down = scores + torch.log((gate - d).clamp_min(1e-6))
    eye = torch.eye(gate.shape[-1], dtype=torch.bool, device=gate.device)

    def prob(own, others):
        rest = (others[..., None, :] - own[..., :, None]).masked_fill(
            eye, -math.inf)
        return 1 / (1 + rest.exp().sum(-1))

    return prob(down, up), prob(up, down)


@pytest.mark.parametrize("with_bias", [True, False])
def test_mega_attention_valid_keys_in_one_split_only(cuda, with_bias):
    """Valid keys only in the last tile of M = 3750: every split but the
    last has no valid key and must weigh nothing in the merge. With five
    valid keys the softmax follows each key's bias closely, and near the
    relu's zero any two computations of the bias differ by more than the
    tolerance in log space (the position-bias tests compare in gate space
    for that). So with the bias the merge is held to the kernel itself on
    the five keys alone, one split and no merge, whose bias of a pair is the
    same arithmetic wherever the key sits (the same lanes of a tile, too:
    3744 is a multiple of 32); and the attention to the plain version in
    probability space: with one-hot values the output is each row's five
    probabilities, which must lie, within the set-attention's tolerance,
    between the least and the most that a bias within the gate-space
    tolerance of the plain bias gives."""
    q, k, vp, ub, valid, bias = mega_split_case(5, 675, 3750, cuda,
                                                with_bias)
    valid[:] = False
    valid[3744:3749] = True
    got = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    if bias:
        sel = valid.nonzero()[:, 0]
        qr, kr, w, b = bias
        assert ma.launch_plan(q.device.index, 675, 5, 16, 64, 64)[1] == 1
        want = ma.fused_mega_attention(q, k[:, sel], vp[:, sel], ub[:, sel],
                                       valid[sel], qr, kr[sel], w, b)
    else:
        want = dense_with_bias(q, k, vp, ub, valid, torch.zeros(()).to(cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert max_err(got, want) <= 1e-4 * (1 + want.abs().max().item())
    if bias:
        one_hot = torch.zeros_like(vp)
        one_hot[:, sel, torch.arange(5, device=cuda)] = 1.0
        out = ma.fused_mega_attention(q, k, one_hot, ub, valid, *bias)
        prob = out.view(675, 16, 64)[..., :5].permute(1, 0, 2).double()
        scores = (torch.einsum("gnd,gmd->gnm", q.double(), k[:, sel].double())
                  / 8 + ub[:, None, sel].double())
        gate = pb.position_bias_plain(qr, kr[sel], w, b).double().exp()
        least, most = softmax_bounds(scores, gate)
        tol = 1e-4 * (1 + most.max().item())
        assert ((prob >= least - tol) & (prob <= most + tol)).all()


@pytest.mark.parametrize("with_bias", [True, False])
def test_mega_attention_never_reads_invalid_keys(cuda, with_bias):
    """NaN in k and vproj at the invalid keys never reaches the output."""
    q, k, vp, ub, valid, bias = mega_split_case(6, 300, 1001, cuda,
                                                with_bias)
    want = ma.mega_attention_plain(q, k, vp, ub, valid, *bias)
    k[:, ~valid] = float("nan")
    vp[:, ~valid] = float("nan")
    got = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert max_err(got, want) <= 1e-4 * (1 + want.abs().max().item())


@pytest.mark.parametrize("with_bias", [True, False])
def test_mega_attention_split_merge_is_deterministic(cuda, with_bias):
    q, k, vp, ub, valid, bias = mega_split_case(7, 675, 3750, cuda,
                                                with_bias)
    first = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    second = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_mega_kernels_refuse_grad_and_bad_inputs(cuda):
    q, k, vp, ub, valid, qr, kr, w, b = mega_case(0, 4, 8, 16, 16, 16, 1.0,
                                                  cuda)
    w.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        pb.fused_position_bias(qr, kr, w, b)
    with pytest.raises(RuntimeError, match="no backward"):
        ma.fused_mega_attention(q, k, vp, ub, valid, qr, kr, w, b)
    with torch.no_grad():
        pb.fused_position_bias(qr, kr, w, b)
    with pytest.raises(ValueError, match="groups"):
        ma.fused_mega_attention(q.repeat(5, 1, 1), k.repeat(5, 1, 1),
                                vp.repeat(5, 1, 1), ub.repeat(5, 1), valid)
    with pytest.raises(ValueError, match="embed_dim"):
        pb.fused_position_bias(qr, kr, w.detach(), b, embed_dim=32)
    with pytest.raises(TypeError, match="dtype"):
        ma.fused_mega_attention(q.double(), k, vp, ub, valid)


def test_mega_head_on_card_matches_cpu(cuda):
    """MEGAHead.enhance of a 16-group head with memory and global sets:
    the card through K5 (and through K6 on the dense route) against the
    CPU's plain versions, same parameters and inputs."""
    from vrdone_tpu_torch.models.mega import BoxSet, MEGAHead
    gen = torch.Generator().manual_seed(0)
    cpu = MEGAHead(feat_dim=256, groups=16, stage=3, advanced_num=3,
                   in_dim=128, device=torch.device("cpu"), generator=gen)
    gpu = MEGAHead(feat_dim=256, groups=16, stage=3, advanced_num=3,
                   in_dim=128, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)

    def boxes(*shape):
        xy = rng.uniform(0, 500, (*shape, 2))
        return np.concatenate([xy, xy + rng.uniform(8, 200, (*shape, 2))],
                              -1).astype(np.float32)

    arrays = [rng.standard_normal((12, 128)).astype(np.float32), boxes(12),
              np.arange(12) < 10,
              rng.standard_normal((5, 6, 256)).astype(np.float32),
              boxes(5, 6), rng.uniform(size=(5, 6)) < 0.8]
    mems = [(rng.standard_normal((n, 256)).astype(np.float32), boxes(n),
             rng.uniform(size=n) < 0.8) for n in (30, 15, 15)]
    glob = (rng.standard_normal((20, 256)).astype(np.float32), boxes(20),
            np.ones(20, bool))

    def run(head, dev, **flags):
        tt = [torch.from_numpy(np.asarray(a)).to(dev) for a in arrays]
        mem = [BoxSet(*(torch.from_numpy(np.asarray(a)).to(dev) for a in x))
               for x in mems]
        gl = BoxSet(*(torch.from_numpy(np.asarray(a)).to(dev) for a in glob))
        with torch.no_grad():
            return head.routed(**flags).enhance(
                tt[0], tt[1], tt[2], BoxSet(*tt[3:]), mem, gl).cpu()

    want = run(cpu, torch.device("cpu"), fused_pe_bias=False,
               fused_attention=False)
    ma.launches = pb.launches = 0
    fused = run(gpu, cuda, fused_pe_bias=False, fused_attention=True)
    biased = run(gpu, cuda, fused_pe_bias=True, fused_attention=False)
    torch.cuda.synchronize()
    # 3 local stages + the global attention of the key rows, of the window
    # rows and the one residual stage; K6 serves the 3 local stages
    assert (ma.launches, pb.launches) == (6, 3)
    scale = want.abs().max().item()
    assert max_err(fused, want) <= 2e-4 * scale
    assert max_err(biased, want) <= 2e-4 * scale


def test_detect_video_tta_on_card_matches_cpu(cuda):
    """detect_video_tta (identity, hflip, 0.75x and its flip) of a small
    detector on the card against the same weights on the CPU: each view
    launches K5 6 times a frame and bias_factors 3 times, and on the
    frames where no view's proposals flipped (RPN near-ties) the labels are
    equal and boxes and scores within 1e-3 of their largest magnitude
    (chip_smoke.py's DETECT_TOL)."""
    from vrdone_tpu_torch.models import detector
    kw = dict(num_classes=31, resnet_layers=(1, 1, 1), base_num=16,
              window=5, key_loc=2, global_size=3)
    cpu_det = detector.MegaDetector(**kw, device=torch.device("cpu"),
                                    generator=torch.Generator().manual_seed(1))
    gpu_det = detector.MegaDetector(**kw, device=cuda)
    gpu_det.load_state_dict(cpu_det.state_dict())
    t, hw = 4, (96, 128)
    images = np.random.default_rng(9).integers(0, 256, (t, *hw, 3),
                                               dtype=np.uint8)
    real = detector.detect_video
    views, res = {}, {}
    for name, det in (("cpu", cpu_det), ("cuda", gpu_det)):
        views[name] = []

        def capture(*args, name=name, **kwargs):
            views[name].append(real(*args, **kwargs))
            return views[name][-1]

        detector.detect_video = capture
        ma.launches = pb.factor_launches = 0
        try:
            res[name] = detector.detect_video_tta(
                det, images, np.asarray(hw, np.float32), scales=(0.75,),
                hflip=True, key_post_nms=24, score_thresh=0.02)
        finally:
            detector.detect_video = real
    torch.cuda.synchronize()
    assert (ma.launches, pb.factor_launches) == (6 * t * 4, 3 * t * 4)
    clean = [f for f in range(t)
             if all(np.array_equal(c["valid"][f], g["valid"][f])
                    and np.allclose(c["proposals"][f], g["proposals"][f],
                                    atol=1e-3, rtol=0)
                    for c, g in zip(views["cpu"], views["cuda"]))]
    assert clean
    for key in ("boxes", "scores"):
        for f in clean:
            np.testing.assert_array_equal(res["cuda"][f]["labels"],
                                          res["cpu"][f]["labels"])
        want = np.concatenate([res["cpu"][f][key] for f in clean])
        got = np.concatenate([res["cuda"][f][key] for f in clean])
        assert len(want) and np.abs(got - want).max() <= 1e-3 * np.abs(
            want).max()


# ---------------------------------------------------------------------------
# bf16 instances of the band (K1) and full-attention (K7) kernels
# ---------------------------------------------------------------------------

def to_bf16(*xs):
    return [x.to(torch.bfloat16) for x in xs]


def bf16_err(out, ref):
    """max |out - ref| over 1 + max |ref|, both bf16."""
    assert out.dtype == ref.dtype == torch.bfloat16
    ref = ref.float()
    return ((out.float() - ref).abs().max() / (1 + ref.abs().max())).item()


@pytest.mark.parametrize("t,w,d,b,h", [
    # the bf16 forward's shapes: VidVRD (B*H = 128*4, d = 128, w = 3) and
    # VidOR (16*8, d = 64, w = 4)
    (96, 3, 128, 128, 4), (12, 3, 128, 128, 4), (512, 4, 64, 16, 8),
    (64, 4, 64, 16, 8),
    # each head-dim bucket; T one off a row tile (16, 48 and 64 rows)
    (40, 3, 32, 4, 4), (100, 15, 256, 4, 4), (15, 3, 128, 4, 4),
    (17, 3, 128, 4, 4), (47, 3, 128, 4, 4), (49, 3, 128, 4, 4),
    (63, 4, 64, 4, 8), (65, 4, 64, 4, 8),
    # d % 8 != 0: the scalar instance (d = 20 is a vector one in fp32)
    (96, 3, 20, 4, 3), (70, 4, 33, 4, 4), (40, 2, 6, 4, 5)])
def test_band_bf16_instances_match_plain(cuda, t, w, d, b, h):
    """K1's bf16 instances against the bf16 plain version, with an fp32 lse
    against the plain logsumexp; a batch row without a valid key (and so
    without a valid query) is 0; only the bf16 count of the launches
    moves apart from the total."""
    kw = dict(n_head=h, window_size=2 * w + 1)
    inst = ba.forward_instance(cuda.index or 0, b, t, h, d, 2 * w + 1,
                               dtype=torch.bfloat16)
    assert inst["vec"] == (d % 8 == 0)
    q, k, v, mask = streams(t * 5 + d, b, t, t, h * d,
                            [t, max(1, t // 2), 1, 0] + [t] * (b - 4), cuda)
    mask[0, t // 3] = False
    q, k, v = to_bf16(q, k, v)
    before, before16 = ba.launches, ba.bf16_launches
    out, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True, **kw)
    torch.cuda.synchronize()
    assert (ba.launches, ba.bf16_launches) == (before + 1, before16 + 1)
    assert bf16_err(out, ba.band_attention_plain(q, k, v, mask, **kw)) \
        <= BF16_TOL
    ref_lse = ba.band_lse_plain(q, k, mask, **kw)
    assert lse.dtype == torch.float32
    assert ((lse - ref_lse).abs() / (1 + ref_lse.abs())).max() <= 1e-5
    assert (out[3] == 0).all()


@pytest.mark.parametrize("tq,tk,d,h", [
    # the bf16 forward's shapes: VidVRD's S/O cross-attention and eval
    # buckets (d = 128) and predictor (d = 64), VidOR's (d = 64; the
    # predictor's d = 32 against itself and the coarsest level)
    (96, 96, 128, 4), (384, 384, 128, 4), (9, 9, 64, 4), (9, 12, 64, 4),
    (512, 512, 64, 8), (9, 9, 32, 8), (9, 64, 32, 8),
    # the tiles' edges and each head-dim bucket
    (63, 31, 128, 4), (65, 33, 32, 4), (97, 65, 256, 4), (17, 32, 64, 4),
    (49, 33, 64, 4), (16, 65, 256, 4),
    # d % 8 != 0: the scalar instance
    (96, 96, 20, 4), (17, 40, 30, 4), (9, 12, 12, 4)])
def test_full_bf16_instances_match_plain(cuda, tq, tk, d, h):
    """K7's bf16 instances against the bf16 plain version; a batch row
    with no valid key is 0 in both."""
    b = 4
    q, k, v, mask = streams(tq * 3 + tk, b, tq, tk, h * d,
                            [tk, max(1, tk // 3), 1, 0], cuda)
    q, k, v = to_bf16(q, k, v)
    before, before16 = fa.launches, fa.bf16_launches
    out = fa.full_attention_cuda(q, k, v, mask, n_head=h)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bf16_launches) == (before + 1, before16 + 1)
    assert torch.isfinite(out.float()).all()
    assert bf16_err(out, fa.full_attention_plain(q, k, v, mask, n_head=h)) \
        <= BF16_TOL
    assert (out[3] == 0).all()


def test_bf16_unaligned_streams_take_the_scalar_instance(cuda):
    """bf16 streams that start 2 bytes past a 16-byte boundary: both
    kernels take their scalar instance (plain 2-byte loads)."""
    b, t, h, d = 4, 150, 8, 64
    q, k, v, mask = streams(11, b, t, t, h * d, [t, 70, 1, 0], cuda)
    q, k, v = to_bf16(q, k, v)
    qs, ks, vs = shifted(q), shifted(k), shifted(v)
    assert qs.data_ptr() % 16 and qs.is_contiguous()
    kw = dict(n_head=h, window_size=9)
    assert bf16_err(ba.band_attention_cuda(qs, ks, vs, mask, **kw),
                    ba.band_attention_plain(q, k, v, mask, **kw)) <= BF16_TOL
    assert bf16_err(fa.full_attention_cuda(qs, ks, vs, mask, n_head=h),
                    fa.full_attention_plain(q, k, v, mask, n_head=h)) \
        <= BF16_TOL


def band_pe_bf16_case(cuda, seed, b, t, h, d, window_size, table,
                      shift=False):
    """K4's bf16 instance on bf16 streams with an N(0, 1) table in
    ``table``'s dtype against the bf16 plain version, one launch counted
    as K4 bf16 (and not as K1); a zero table gives K1 bf16's output bit
    for bit. ``shift`` moves q, k and v 2 bytes past a 16-byte boundary.
    Returns the kernel's output."""
    lens = [t, max(1, t // 2), 1, 0] + [t] * (b - 4)
    q, k, v, mask = streams(seed, b, t, t, h * d, lens, cuda)
    mask[0, t // 3] = False  # an invalid key inside a valid stretch
    q, k, v = to_bf16(q, k, v)
    pe = pe_table(seed, h, window_size, cuda).to(table)
    kw = dict(n_head=h, window_size=window_size)
    move = shifted if shift else torch.clone
    qs, ks, vs = move(q), move(k), move(v)
    counts = (ba.launches, ba.bf16_launches, ba.pe_launches,
              ba.pe_bf16_launches)
    out = ba.band_attention_pe_cuda(qs, ks, vs, mask, pe, **kw)
    torch.cuda.synchronize()
    assert (ba.launches, ba.bf16_launches, ba.pe_launches,
            ba.pe_bf16_launches) == (*counts[:2], counts[2] + 1,
                                     counts[3] + 1)
    assert bf16_err(out, ba.band_attention_pe_plain(q, k, v, mask, pe,
                                                    **kw)) <= BF16_TOL
    assert (out[3] == 0).all()  # no valid query (and no valid key)
    zero = torch.zeros_like(pe)
    assert torch.equal(ba.band_attention_pe_cuda(qs, ks, vs, mask, zero,
                                                 **kw),
                       ba.band_attention_cuda(qs, ks, vs, mask, **kw))
    return out


@pytest.mark.parametrize("table", [torch.bfloat16, torch.float32],
                         ids=["bf16_table", "fp32_table"])
@pytest.mark.parametrize("t,window_size,d,b,h", [
    # the bf16 rel-PE paths' shapes: VidOR local width (B*H = 16*8, d = 64,
    # window 9) at the stem and the coarsest level, the stream's stem
    (512, 9, 64, 16, 8), (64, 9, 64, 16, 8), (768, 9, 64, 8, 8),
    # T one off each row tile (16, 48, 64 rows), odd T, even windows (the
    # bias index clamps), T < 2w + 1, the widest band, w = 0
    (15, 7, 128, 4, 4), (17, 7, 128, 4, 4), (47, 8, 128, 4, 4),
    (49, 7, 128, 4, 4), (63, 9, 64, 4, 8), (65, 8, 64, 4, 8),
    (37, 8, 32, 4, 8), (5, 9, 64, 4, 8), (100, 31, 256, 4, 4),
    (64, 1, 64, 4, 8),
    # d % 8 != 0: the scalar instance (d = 20 is a vector one in fp32)
    (96, 7, 20, 4, 3), (70, 9, 33, 4, 4), (40, 5, 6, 4, 5)])
def test_band_pe_bf16_instances_match_plain(cuda, t, window_size, d, b, h,
                                            table):
    """K4's bf16 instances against the bf16 plain version, the table bf16
    (as ``cast_floating`` and the bf16 train step leave it) or fp32, and
    a zero table equal to K1 bf16 bit for bit; the instance the C side
    reports for it."""
    inst = ba.forward_instance(cuda.index or 0, b, t, h, d, window_size,
                               pe=True, dtype=torch.bfloat16)
    assert inst["rows"] in (16, 32, 48, 64)
    assert inst["tiles"] == -(-t // inst["rows"])
    assert inst["vec"] == (d % 8 == 0)
    band_pe_bf16_case(cuda, t * 3 + d, b, t, h, d, window_size, table)


def test_band_pe_bf16_unaligned_streams_take_the_scalar_instance(cuda):
    """bf16 streams 2 bytes past a 16-byte boundary: K4 bf16 takes its
    scalar instance, and a zero table still gives K1 bf16's output."""
    band_pe_bf16_case(cuda, 12, 4, 150, 8, 64, 9, torch.bfloat16,
                      shift=True)


def test_band_pe_bf16_walks_double_buffered_tiles(cuda):
    """More row tiles than the card holds blocks at once (8 * 8 sequences
    of 26 tiles of 64 rows, the last one padded). K4 bf16's tensor-core
    kernel does not walk tiles: walking double-buffered blocks was slower
    at every shape measured (PERF.md), so each block takes one tile
    however many there are."""
    inst = ba.forward_instance(cuda.index or 0, 8, 1630, 8, 64, 9, pe=True,
                               dtype=torch.bfloat16)
    assert inst["rows"] == 64 and inst["per_block"] == 1
    assert inst["tiles"] == 26
    band_pe_bf16_case(cuda, 13, 8, 1630, 8, 64, 9, torch.bfloat16)


@pytest.mark.parametrize("t,window_size,d", [
    (512, 9, 64), (96, 8, 64), (37, 7, 32), (5, 9, 16)])
def test_band_pe_bf16_autograd_matches_plain(cuda, t, window_size, d):
    """``BandAttentionPE`` on bf16 leaves (the bf16 train step's): K4's
    bf16 instance as the forward and the dense form's autograd as the
    backward, against autograd of the plain version, dq, dk, dv and
    d rel_pe bf16, with a nonzero upstream gradient on invalid query
    rows."""
    b, h = 4, 8
    q, k, v, mask = streams(t * 11 + window_size, b, t, t, h * d,
                            [t, max(1, t // 2), 1, 0], cuda)
    mask[0, t // 3] = False
    pe = pe_table(t, h, window_size, cuda)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(t)
                       ).to(cuda)
    q, k, v, pe, dout = to_bf16(q, k, v, pe, dout)
    kw = dict(n_head=h, window_size=window_size)
    counts = (ba.launches, ba.pe_launches, ba.pe_bf16_launches,
              ba.dq_launches, ba.dkv_launches)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, pe)]
    out = mops.band_attention(*leaves[:3], mask, rel_pe=leaves[3], **kw)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (ba.launches, ba.pe_launches, ba.pe_bf16_launches,
            ba.dq_launches, ba.dkv_launches) == (
        counts[0], counts[1] + 1, counts[2] + 1, *counts[3:])
    ref = [x.clone().requires_grad_() for x in (q, k, v, pe)]
    ref_out = ba.band_attention_pe_plain(*ref[:3], mask, ref[3], **kw)
    want = torch.autograd.grad(ref_out, ref, dout)
    assert bf16_err(out, ref_out) <= BF16_TOL
    for name, g, r in zip(("dq", "dk", "dv", "drel_pe"), got, want):
        assert g.dtype == torch.bfloat16, name
        assert bf16_err(g, r) <= BF16_TOL, name
    assert (got[0][3] == 0).all()  # a batch row with no valid query


def check_mma_launch(name, grid, block, inst, b, h, pe):
    """One trace entry of a bf16 band forward: the tensor-core kernel with
    the template arguments, grid and block of ``inst`` (from
    ``forward_instance``), never the FMA body on bf16 streams. Returns
    whether ``name`` was the tensor-core kernel."""
    import re
    assert not re.search(r"band_forward_kernel<.*__nv_bfloat16", name), name
    m = re.search(r"band_forward_mma_kernel<(\d+), (true|false), "
                  r"(true|false), (\d+)>", name)
    if m is None:
        return False
    assert (int(m[1]), m[2] == "true", m[3] == "true", int(m[4])) == (
        inst["bucket"], inst["vec"], pe, inst["key_tiles"])
    # one row tile a block, a warp each 16 rows of it, 4 warps a block
    assert inst["per_block"] == 1 and inst["warps"] == 4
    assert inst["rows"] in (16, 32, 64)
    assert grid == [b * h * inst["tiles"], 1, 1]
    assert block == [32 * inst["warps"], 1, 1]
    return True


def test_band_pe_bf16_instance_is_what_launches(cuda, tmp_path):
    """A bf16 call with the bias launches K4's bf16 instance, the
    tensor-core kernel ``band_forward_mma_kernel<bucket, vec, true, key
    tiles>``: head-dim bucket, vector copies, key tiles, grid and block
    (32 threads a warp of 16 rows) from a ``torch.profiler`` trace against
    ``forward_instance(pe=True)``; the FMA body never runs on bf16
    streams."""
    for b, t, h, d, ws in ((16, 512, 8, 64, 9), (8, 768, 8, 64, 9),
                           (4, 70, 4, 20, 8), (4, 100, 4, 256, 31)):
        q, k, v, mask = streams(t + d, b, t, t, h * d, [t] * b, cuda)
        q, k, v = to_bf16(q, k, v)
        pe = pe_table(t, h, ws, cuda).to(torch.bfloat16)
        inst = ba.forward_instance(cuda.index or 0, b, t, h, d, ws, pe=True,
                                   dtype=torch.bfloat16)
        seen = 0
        for name, grid, block in traced_kernels(
                lambda: ba.band_attention_pe_cuda(q, k, v, mask, pe,
                                                  n_head=h, window_size=ws),
                tmp_path / f"trace{t}.json", "band_forward",
                lambda found: any("band_forward_mma_kernel" in n
                                  for n, _, _ in found)):
            seen += check_mma_launch(name, grid, block, inst, b, h, True)
        assert seen, (b, t, h, d)


def band_bf16_held(q, k, v, mask, kw, pe=None, with_lse=False):
    """K1 bf16 (K4 bf16 with ``pe``) on bf16 streams, launched twice:
    equal bit for bit, finite, within BF16_TOL of the bf16 plain version,
    and 0 on every invalid query row; with ``with_lse`` the lse is fp32 and
    within 1e-5 of 1 + |lse| of the plain logsumexp. ``q``, ``k`` and ``v``
    may be shifted copies of the plain version's inputs. Returns the
    output."""
    if pe is None:
        runs = [ba.band_attention_cuda(q, k, v, mask, with_lse=with_lse,
                                       **kw) for _ in range(2)]
        plain = ba.band_attention_plain(q, k, v, mask, **kw)
    else:
        runs = [ba.band_attention_pe_cuda(q, k, v, mask, pe, **kw)
                for _ in range(2)]
        plain = ba.band_attention_pe_plain(q, k, v, mask, pe, **kw)
    if with_lse:
        (out, lse), (out2, lse2) = runs
        assert torch.equal(lse, lse2)
        assert lse.dtype == torch.float32
        assert torch.isfinite(lse).all()
        ref_lse = ba.band_lse_plain(q, k, mask, **kw)
        assert ((lse - ref_lse).abs() / (1 + ref_lse.abs())).max() <= 1e-5
    else:
        out, out2 = runs
    assert torch.equal(out, out2)
    assert torch.isfinite(out.float()).all()
    assert bf16_err(out, plain) <= BF16_TOL
    assert (out[~mask] == 0).all()
    return out


@pytest.mark.parametrize("w", [1, 3, 4, 15])
@pytest.mark.parametrize("t", [1, 15, 16, 17, 31, 33, 47, 49])
def test_band_bf16_tile_edges(cuda, t, w):
    """The tensor-core forward at T one below, at and one above its 16-row
    tiles (and at T = 1, a single dead-padded tile) for each key-tile
    instance (w <= 4: 3 key tiles, w = 15: 6): K1 bf16 with and without
    its lse (the two outputs equal bit for bit), K4 bf16 with an odd and
    an even window (the bias index clamps), each deterministic, finite and
    0 on invalid query rows; invalid keys inside a valid stretch and after
    it, a batch row with one valid key and one with none."""
    b, h, d = 4, 2, 64
    q, k, v, mask = streams(t * 17 + w, b, t, t, h * d,
                            [t, max(1, t // 2), 1, 0], cuda)
    mask[0, t // 3] = False
    q, k, v = to_bf16(q, k, v)
    kw = dict(n_head=h, window_size=2 * w + 1)
    out = band_bf16_held(q, k, v, mask, kw, with_lse=True)
    assert torch.equal(out, band_bf16_held(q, k, v, mask, kw))
    for ws in (2 * w + 1, 2 * w):
        pe = pe_table(t + ws, h, ws, cuda).to(torch.bfloat16)
        band_bf16_held(q, k, v, mask, dict(n_head=h, window_size=ws), pe)


@pytest.mark.parametrize("shift", [False, True], ids=["vector", "scalar"])
@pytest.mark.parametrize("d", [6, 16, 20, 32, 33, 64, 100, 128, 256])
def test_band_bf16_head_dims(cuda, d, shift):
    """Every head-dim bucket (32, 64, 128, 256: channels past d are zero
    in the tensor cores' k16 steps), vector and scalar copies (d % 8 != 0,
    or streams 2 bytes past a 16-byte boundary), K1 bf16 with its lse and
    K4 bf16, at a T off the row tile with 2 and 6 key tiles' windows."""
    b, h, t = 4, 2, 70
    q, k, v, mask = streams(d * 3 + shift, b, t, t, h * d,
                            [t, 40, 1, 0], cuda)
    mask[0, 20] = False
    q, k, v = to_bf16(q, k, v)
    move = shifted if shift else torch.clone
    qs, ks, vs = move(q), move(k), move(v)
    for w in (4, 11):
        kw = dict(n_head=h, window_size=2 * w + 1)
        inst = ba.forward_instance(cuda.index or 0, b, t, h, d, 2 * w + 1,
                                   dtype=torch.bfloat16)
        assert inst["bucket"] == max(32, 1 << (d - 1).bit_length())
        assert inst["key_tiles"] == (3 if w <= 4 else 6)
        out = ba.band_attention_cuda(qs, ks, vs, mask, **kw)
        assert torch.equal(out, band_bf16_held(q, k, v, mask, kw,
                                               with_lse=True))
        assert bf16_err(out, ba.band_attention_plain(q, k, v, mask, **kw)) \
            <= BF16_TOL
        pe = pe_table(d + w, h, 2 * w + 1, cuda).to(torch.bfloat16)
        got = ba.band_attention_pe_cuda(qs, ks, vs, mask, pe, **kw)
        assert torch.equal(got, band_bf16_held(q, k, v, mask, kw, pe))


def test_band_bf16_keeps_fp32_scale_at_large_scores(cuda):
    """Scores near 60 at d = 128, where 1/sqrt(d) is not a power of two:
    key j is a one-hot row of 680 at channel j % 128 and every query
    channel lies in [1, 1.125), so a score is 680 q_c / sqrt(128), 60 to
    68, and the band's keys differ by a few units. Rounding q * scale to
    bf16 would move each score by up to 2^-9 of its size (0.13 here) and
    the lse with it, far past its limit of 1e-5 of 1 + |lse|; an lse in
    log2 units would be 1.44 times too large. With and without the bias,
    the kernel's scores, lse and output agree with the plain version."""
    b, t, h, d, w = 4, 96, 4, 128, 4
    rng = np.random.default_rng(31)
    q = 1 + rng.random((b, t, h * d)) / 8
    k = np.zeros((b, t, h, d))
    k[:, np.arange(t), :, np.arange(t) % d] = 680.0
    v = rng.standard_normal((b, t, h * d))
    mask = np.ones((b, t), bool)
    mask[1, 50:] = False
    mask[2, 30] = False
    q, k, v = (torch.from_numpy(x.astype(np.float32)).reshape(b, t, h * d)
               .to(cuda, torch.bfloat16) for x in (q, k, v))
    mask = torch.from_numpy(mask).to(cuda)
    kw = dict(n_head=h, window_size=2 * w + 1)
    band_bf16_held(q, k, v, mask, kw, with_lse=True)
    lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True, **kw)[1]
    assert lse[0].min() > 55
    pe = pe_table(31, h, 2 * w + 1, cuda).to(torch.bfloat16)
    band_bf16_held(q, k, v, mask, kw, pe)


@pytest.mark.parametrize("t,w,d,b,h,pe", [
    (96, 3, 128, 128, 4, False), (512, 4, 64, 16, 8, False),
    (512, 4, 64, 16, 8, True), (1630, 4, 64, 8, 8, True),
    (100, 15, 256, 4, 4, True)])
def test_band_bf16_paths_are_deterministic_and_finite(cuda, t, w, d, b, h,
                                                      pe):
    """At the bf16 paths' main shapes (VidVRD's K1, VidOR's K1 and K4), a
    long sequence and the widest band and head dim: two launches equal bit
    for bit, finite, held to the plain version."""
    q, k, v, mask = streams(t + d, b, t, t, h * d,
                            [t, t // 2, 1, 0] + [t] * (b - 4), cuda)
    q, k, v = to_bf16(q, k, v)
    kw = dict(n_head=h, window_size=2 * w + 1)
    table = (pe_table(t, h, 2 * w + 1, cuda).to(torch.bfloat16) if pe
             else None)
    band_bf16_held(q, k, v, mask, kw, table, with_lse=not pe)


def full_bf16_case(cuda, seed, tq, tk, d, lens, h=2, shift=False):
    """K7's bf16 instance on bf16 streams against the bf16 plain version,
    one launch counted as bf16; ``shift`` moves q, k and v 2 bytes past a
    16-byte boundary (the scalar copies). Returns (out, plain)."""
    q, k, v, mask = streams(seed, len(lens), tq, tk, h * d, lens, cuda)
    q, k, v = to_bf16(q, k, v)
    move = shifted if shift else torch.clone
    before, before16 = fa.launches, fa.bf16_launches
    out = fa.full_attention_cuda(move(q), move(k), move(v), mask, n_head=h)
    torch.cuda.synchronize()
    assert (fa.launches, fa.bf16_launches) == (before + 1, before16 + 1)
    ref = fa.full_attention_plain(q, k, v, mask, n_head=h)
    assert torch.isfinite(out.float()).all()
    assert bf16_err(out, ref) <= BF16_TOL
    return out, ref


@pytest.mark.parametrize("tk", [1, 31, 33, 63, 65])
@pytest.mark.parametrize("tq", [1, 9, 15, 16, 17, 95, 96, 97])
def test_full_bf16_tile_edges(cuda, tq, tk):
    """The tensor-core instance at the edges of its tiles: 16-row tiles,
    one or two a warp (16, 48, 64, 96 or 128 rows a block), 32 keys a tile
    and 8 keys an n8 column block, with a batch row of one valid key and
    one of none."""
    out, _ = full_bf16_case(cuda, tq * 100 + tk, tq, tk, 64,
                            [tk, max(1, tk // 2), 1, 0])
    assert (out[3] == 0).all()


@pytest.mark.parametrize("shift", [False, True], ids=["vector", "scalar"])
@pytest.mark.parametrize("d", [8, 20, 40, 64, 100, 128, 256])
def test_full_bf16_head_dims(cuda, d, shift):
    """Each head-dim bucket, d on and off a multiple of 8, through the
    16-byte copies and the 2-byte ones (d % 8 != 0 or unaligned streams)."""
    full_bf16_case(cuda, d, 70, 90, d, [90, 41, 1, 0], shift=shift)


def poisoned(x, mask, fill):
    """A contiguous copy of x (B, Tk, C) at the start of a larger buffer,
    ``fill`` at every invalid key and in the buffer past x's end (what a
    kernel would read past the last batch row's Tk)."""
    buf = torch.full((x.numel() + 4 * x.shape[-1],), fill, device=x.device,
                     dtype=x.dtype)
    y = buf[:x.numel()].view(x.shape)
    y.copy_(torch.where(mask[..., None], x, fill))
    return y


@pytest.mark.parametrize("tq,tk,d", [
    (96, 96, 128), (9, 12, 64), (512, 100, 64), (40, 70, 20), (17, 33, 256)])
def test_full_bf16_never_reads_invalid_keys(cuda, tq, tk, d):
    """NaN in K and inf in V (then the other way round) at every invalid
    key and past Tk: the copies zero-fill those keys, so nothing of them
    reaches S or P.V, where 0 * NaN would be NaN on the tensor cores too.
    Held against the plain version on the clean streams (invalid keys 0:
    the plain version multiplies V by the mask and would carry the NaN)."""
    h = 2
    q, k, v, mask = streams(tq + tk + d, 4, tq, tk, h * d,
                            [tk, tk // 2, 3, 0], cuda)
    mask[0, tk // 3] = False
    q, k, v = to_bf16(q, k, v)
    k, v = (torch.where(mask[..., None], x, 0) for x in (k, v))
    ref = fa.full_attention_plain(q, k, v, mask, n_head=h)
    for fk, fv in ((float("nan"), float("inf")),
                   (float("-inf"), float("nan"))):
        out = fa.full_attention_cuda(q, poisoned(k, mask, fk),
                                     poisoned(v, mask, fv), mask, n_head=h)
        assert torch.isfinite(out.float()).all()
        assert bf16_err(out, ref) <= BF16_TOL
        assert (out[3] == 0).all()


def test_full_bf16_keeps_fp32_scale_at_large_scores(cuda):
    """Scores near 30 at d = 128, where 1/sqrt(d) is not a power of two:
    key j is a one-hot row of 320 at channel j % 128 and every query
    channel lies in [1, 1.125), so a score is 320 q_c / sqrt(128), 28 to 32,
    and neighbouring keys differ by a few units. Rounding q * scale to bf16
    would move each score by up to 2^-9 of its size, independently a key
    (0.06 here), and the softmax with it; the scores in fp32 agree with the
    plain version."""
    b, tq, tk, h, d = 4, 96, 96, 4, 128
    rng = np.random.default_rng(30)
    q = 1 + rng.random((b, tq, h * d)) / 8
    k = np.zeros((b, tk, h, d))
    k[:, np.arange(tk), :, np.arange(tk) % d] = 320.0
    v = rng.standard_normal((b, tk, h * d))
    mask = np.ones((b, tk), bool)
    mask[1, 50:] = False
    q, k, v = (torch.from_numpy(x.astype(np.float32)).reshape(b, -1, h * d)
               .to(cuda, torch.bfloat16) for x in (q, k, v))
    mask = torch.from_numpy(mask).to(cuda)
    out = fa.full_attention_cuda(q, k, v, mask, n_head=h)
    assert bf16_err(out, fa.full_attention_plain(q, k, v, mask, n_head=h)) \
        <= BF16_TOL


def test_full_bf16_skips_key_tiles_without_valid_keys(cuda):
    """Key tiles with no valid key between valid ones, valid keys only in
    the last, ragged tile, and a batch row with no valid key at all, which
    is exactly 0."""
    b, tq, tk, h, d = 4, 80, 200, 2, 64
    q, k, v, mask = streams(64, b, tq, tk, h * d, [tk] * 3 + [0], cuda)
    mask[0, 64:128] = False
    mask[1, :192] = False
    mask[2, 5:130] = False
    q, k, v = to_bf16(q, k, v)
    out = fa.full_attention_cuda(q, k, v, mask, n_head=h)
    assert bf16_err(out, fa.full_attention_plain(q, k, v, mask, n_head=h)) \
        <= BF16_TOL
    assert (out[3] == 0).all()


def test_full_bf16_walks_past_the_mask_window(cuda):
    """Past 4096 keys the block reads the next window of mask bits: a run of
    invalid keys across the window's edge, and a batch row whose first
    window holds no valid key (the walk moves the window on while it looks
    for a tile). Values of 100 at the invalid keys show any key taken from
    the wrong window's bits."""
    b, tq, tk, h, d = 3, 20, 4500, 2, 32
    q, k, v, mask = streams(4096, b, tq, tk, h * d, [tk] * b, cuda)
    mask[1, 4000:4200] = False
    mask[2, :4100] = False
    v[~mask] = 100.0
    q, k, v = to_bf16(q, k, v)
    out = fa.full_attention_cuda(q, k, v, mask, n_head=h)
    assert bf16_err(out, fa.full_attention_plain(q, k, v, mask, n_head=h)) \
        <= BF16_TOL


@pytest.mark.parametrize("tq,tk,d", [(96, 96, 128), (512, 512, 64)])
def test_full_bf16_is_deterministic(cuda, tq, tk, d):
    """Two launches on the same streams are equal bit for bit."""
    b, h = 8, 4
    q, k, v, mask = streams(7, b, tq, tk, h * d, [tk, tk // 2] * (b // 2),
                            cuda)
    q, k, v = to_bf16(q, k, v)
    first = fa.full_attention_cuda(q, k, v, mask, n_head=h)
    second = fa.full_attention_cuda(q, k, v, mask, n_head=h)
    assert torch.equal(first, second)


def band_backward_bf16_case(cuda, seed, b, t, h, d, w, shift=False):
    """K2 (dQ) and K3 (dK, dV) in bf16 against ``band_backward_plain`` on
    the same bf16 streams, fp32 lse (K1's bf16 instance) and Dr, one launch
    of each, counted as bf16; streams with an invalid key inside a valid
    stretch, a batch row of one valid query and one with none (dQ exactly 0
    there), and a nonzero upstream gradient on the invalid query rows. With
    ``shift`` q, k, v and dout start 2 bytes past a 16-byte boundary."""
    lens = ([t, max(1, t // 2), 1, 0] + [t] * (b - 4) if b >= 4
            else [t] * b)
    q, k, v, mask = streams(seed, b, t, t, h * d, lens, cuda)
    mask[0, t // 3] = False
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        q.shape).astype(np.float32)).to(cuda)
    q, k, v, dout = to_bf16(q, k, v, dout)
    kw = dict(n_head=h, window_size=2 * w + 1)
    out, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True, **kw)
    dr = ba.band_rowsum(dout, out, h)
    move = shifted if shift else torch.clone
    args = (move(q), move(k), move(v), mask, lse, dr, move(dout))
    names = ("dq_launches", "bf16_dq_launches", "dkv_launches",
             "bf16_dkv_launches")
    before = [getattr(ba, n) for n in names]
    dq = ba.band_attention_dq_cuda(*args, **kw)
    dk, dv = ba.band_attention_dkv_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert [getattr(ba, n) for n in names] == [x + 1 for x in before]
    want = ba.band_backward_plain(q, k, v, mask, lse, dr, dout, **kw)
    for name, g, r in zip("qkv", (dq, dk, dv), want):
        assert bf16_err(g, r) <= BF16_TOL, name
    assert (dq[~mask] == 0).all()


@pytest.mark.parametrize("t,w,d,b,h", [
    # the train step's shapes (B*H = 24*4, d = 128, w = 3)
    (96, 3, 128, 24, 4), (48, 3, 128, 24, 4), (24, 3, 128, 24, 4),
    (12, 3, 128, 24, 4),
    # T one below, at and one above a row tile (16 rows up to w = 4, 64
    # at w = 15, at most 32 at 2 rows a warp), each head-dim bucket, for
    # few sequences and for many (B*H = 512)
    (15, 1, 32, 4, 4), (16, 1, 32, 4, 4), (17, 1, 32, 4, 4),
    (31, 3, 64, 4, 4), (33, 3, 64, 4, 4), (63, 15, 64, 8, 8),
    (65, 15, 128, 4, 4), (100, 15, 256, 4, 4), (47, 3, 256, 4, 4),
    (95, 3, 128, 128, 4), (97, 3, 128, 128, 4), (5, 3, 128, 4, 4),
    # d % 8 != 0: the scalar instance (d = 20 and 36 are vector ones in
    # fp32)
    (96, 3, 20, 4, 3), (70, 15, 36, 4, 2), (50, 1, 33, 4, 4),
    (40, 3, 6, 4, 5)])
def test_band_backward_bf16_instances_match_plain(cuda, t, w, d, b, h):
    """K2's and K3's bf16 instances, the tensor-core kernel
    ``band_backward_mma_kernel``, at each instance's edges against the
    plain version; the instance the C side reports for bf16 is a tiling of
    T into one tile of 16, 32 or 64 owner rows a block of 4 warps, 16 rows
    a warp, 3 partner tiles a warp up to w = 4 and 6 beyond, with vector
    copies exactly when d % 8 == 0."""
    for dkv in (False, True):
        inst = ba.backward_instance(cuda.index or 0, b, t, h, d, 2 * w + 1,
                                    dkv, dtype=torch.bfloat16)
        assert inst["rows_warp"] == 16
        assert inst["rows"] in (16, 32, 64)
        assert inst["tiles"] == -(-t // inst["rows"])
        assert inst["per_block"] == 1 and inst["warps"] == 4
        assert inst["key_tiles"] == (3 if w <= 4 else 6)
        assert inst["vec"] == (d % 8 == 0)
    band_backward_bf16_case(cuda, t * 5 + d, b, t, h, d, w)


@pytest.mark.parametrize("dkv", [False, True])
def test_band_backward_bf16_walks_double_buffered_tiles(cuda, dkv):
    """More row tiles than the card holds blocks at once (8 * 8 sequences
    of 26 tiles of 64 rows, the last one padded). The bf16 backward's
    tensor-core kernel does not walk tiles, as the bf16 forward's does not
    (walking double-buffered blocks was slower at every shape measured,
    PERF.md): each block takes one tile however many there are."""
    inst = ba.backward_instance(cuda.index or 0, 8, 1630, 8, 64, 9, dkv,
                                dtype=torch.bfloat16)
    assert inst["rows"] == 64 and inst["per_block"] == 1
    assert inst["tiles"] == 26
    band_backward_bf16_case(cuda, 13 + dkv, 8, 1630, 8, 64, 4)


def test_band_backward_bf16_unaligned_streams_take_the_scalar_instance(
        cuda):
    """bf16 q, k, v and dout 2 bytes past a 16-byte boundary: K2 and K3
    take their scalar instance (plain 2-byte loads)."""
    band_backward_bf16_case(cuda, 9, 4, 150, 8, 64, 4, shift=True)


def test_band_backward_bf16_through_autograd(cuda):
    """bf16 leaves that need a gradient go through ``BandAttention``: K1's
    bf16 instance with its lse, then K2's and K3's, with bf16 gradients
    equal to ``band_backward_plain`` of the same lse and Dr."""
    b, t, h, d, w = 24, 96, 4, 128, 3
    q, k, v, mask = streams(5, b, t, t, h * d, [t, 50, 1, 0] + [t] * 20,
                            cuda)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)
                       ).to(cuda)
    q, k, v, dout = to_bf16(q, k, v, dout)
    kw = dict(n_head=h, window_size=2 * w + 1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ba.launches = ba.bf16_launches = 0
    ba.dq_launches = ba.bf16_dq_launches = 0
    ba.dkv_launches = ba.bf16_dkv_launches = 0
    out = mops.band_attention(*leaves, mask, **kw)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (ba.launches, ba.bf16_launches, ba.dq_launches,
            ba.bf16_dq_launches, ba.dkv_launches,
            ba.bf16_dkv_launches) == (1, 1, 1, 1, 1, 1)
    with torch.no_grad():
        _, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True, **kw)
        want = ba.band_backward_plain(q, k, v, mask, lse,
                                      ba.band_rowsum(dout, out, h), dout,
                                      **kw)
    for name, g, r in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        assert bf16_err(g, r) <= BF16_TOL, name


def band_backward_bf16_held(q, k, v, mask, lse, dr, dout, kw, plain=None):
    """K2 and K3 bf16 on these streams (``q``, ``k``, ``v`` and ``dout``
    may be shifted or poisoned copies), each launched twice: equal bit for
    bit, finite, bf16, within BF16_TOL of ``band_backward_plain`` (on
    ``plain``'s streams where given: the clean ones) and dQ exactly 0 on
    every invalid query row. Returns (dQ, dK, dV)."""
    runs = [(ba.band_attention_dq_cuda(q, k, v, mask, lse, dr, dout, **kw),
             *ba.band_attention_dkv_cuda(q, k, v, mask, lse, dr, dout, **kw))
            for _ in range(2)]
    torch.cuda.synchronize()
    want = ba.band_backward_plain(*(plain or (q, k, v, mask, lse, dr,
                                              dout)), **kw)
    for name, g, g2, r in zip("qkv", *runs, want):
        assert torch.equal(g, g2), name
        assert g.dtype == torch.bfloat16, name
        assert torch.isfinite(g.float()).all(), name
        assert bf16_err(g, r) <= BF16_TOL, name
    assert (runs[0][0][~mask] == 0).all()
    return runs[0]


def band_backward_bf16_inputs(seed, b, t, h, d, w, cuda):
    """bf16 streams and upstream gradient with an invalid key inside a
    valid stretch, a batch row of half its queries, one of one and one of
    none, K1 bf16's fp32 lse and Dr: (q, k, v, mask, lse, dr, dout)."""
    lens = [t, max(1, t // 2), 1, 0] + [t] * (b - 4)
    q, k, v, mask = streams(seed, b, t, t, h * d, lens, cuda)
    mask[0, t // 3] = False
    dout = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        q.shape).astype(np.float32)).to(cuda)
    q, k, v, dout = to_bf16(q, k, v, dout)
    out, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True,
                                      n_head=h, window_size=2 * w + 1)
    return q, k, v, mask, lse, ba.band_rowsum(dout, out, h), dout


@pytest.mark.parametrize("w", [0, 1, 3, 4, 15])
@pytest.mark.parametrize("t", [1, 15, 16, 17, 31, 33, 47, 49, 65])
def test_band_backward_bf16_tile_edges(cuda, t, w):
    """The tensor-core backward at T one below, at and one above its
    16-row owner tiles (and T = 1, a single dead-padded tile; 65, a tile
    of 64 rows and one of 1) for both partner-tile instances (w <= 4: 3
    n8 tiles, w = 15: 6) and w = 0: K2 and K3 deterministic, finite, held
    to the plain version, dQ 0 on invalid query rows."""
    b, h, d = 4, 2, 64
    args = band_backward_bf16_inputs(t * 17 + w, b, t, h, d, w, cuda)
    for dkv in (False, True):
        inst = ba.backward_instance(cuda.index or 0, b, t, h, d, 2 * w + 1,
                                    dkv, dtype=torch.bfloat16)
        assert inst["key_tiles"] == (3 if w <= 4 else 6)
    band_backward_bf16_held(*args, dict(n_head=h, window_size=2 * w + 1))


@pytest.mark.parametrize("shift", [False, True], ids=["vector", "scalar"])
@pytest.mark.parametrize("d", [6, 16, 20, 32, 33, 64, 100, 128, 256])
def test_band_backward_bf16_head_dims(cuda, d, shift):
    """Every head-dim bucket (32, 64, 128, 256: channels past d are zero
    in the tensor cores' k16 steps and never stored), vector and scalar
    copies (d % 8 != 0, or streams 2 bytes past a 16-byte boundary), at a
    T off the row tile with 3 and 6 partner tiles' windows: the shifted
    streams give the aligned ones' gradients bit for bit."""
    b, h, t = 4, 2, 70
    for w in (4, 11):
        kw = dict(n_head=h, window_size=2 * w + 1)
        q, k, v, mask, lse, dr, dout = band_backward_bf16_inputs(
            d * 3 + shift + w, b, t, h, d, w, cuda)
        for dkv in (False, True):
            inst = ba.backward_instance(cuda.index or 0, b, t, h, d,
                                        2 * w + 1, dkv, dtype=torch.bfloat16)
            assert inst["bucket"] == max(32, 1 << (d - 1).bit_length())
            assert inst["key_tiles"] == (3 if w <= 4 else 6)
            assert inst["vec"] == (d % 8 == 0)
        clean = band_backward_bf16_held(q, k, v, mask, lse, dr, dout, kw)
        move = shifted if shift else torch.clone
        got = band_backward_bf16_held(move(q), move(k), move(v), mask, lse,
                                      dr, move(dout), kw,
                                      (q, k, v, mask, lse, dr, dout))
        for g, c in zip(got, clean):
            assert torch.equal(g, c)


@pytest.mark.parametrize("t,w,d,h", [
    (96, 3, 128, 4), (70, 4, 20, 1), (49, 15, 100, 2), (33, 4, 64, 8)])
def test_band_backward_bf16_never_reads_what_it_must_not(cuda, t, w, d, h):
    """NaN and inf in q and dO at every invalid query row (hence in its Dr)
    and past the last batch row's T in all four streams, which a copy past
    T, or past d (d = 20 and 100 are off their buckets; with one head the
    channels past d are the next row's), would read: the gradients equal
    those of the clean streams bit for bit. An invalid query meets P = dS =
    0, selected, and K3 masks its q and dO rows out of the tensor cores'
    B fragments (0 * NaN is NaN there). k and v of an in-band invalid key
    are read, as the -1e4 the key gets is added to its score, so they are
    not poisoned."""
    b = 4
    q, k, v, mask, lse, dr, dout = band_backward_bf16_inputs(
        t + d, b, t, h, d, w, cuda)
    kw = dict(n_head=h, window_size=2 * w + 1)
    clean = band_backward_bf16_held(q, k, v, mask, lse, dr, dout, kw)
    every = torch.ones_like(mask)
    for fa_, fb in ((float("nan"), float("inf")),
                    (float("-inf"), float("nan"))):
        qp, dp = poisoned(q, mask, fa_), poisoned(dout, mask, fb)
        kp, vp = poisoned(k, every, fb), poisoned(v, every, fa_)
        # Dr as band_rowsum makes it from the poisoned dO: NaN on the
        # invalid query rows, the clean Dr elsewhere
        drp = ba.band_rowsum(dp, torch.zeros_like(dp), h) + dr
        assert not torch.isfinite(drp.transpose(1, 2)[~mask]).any()
        got = band_backward_bf16_held(qp, kp, vp, mask, lse, drp, dp, kw,
                                      (q, k, v, mask, lse, dr, dout))
        for g, c in zip(got, clean):
            assert torch.equal(g, c)


def test_band_backward_bf16_keeps_fp32_scale_at_large_scores(cuda):
    """Scores near 60 at d = 128, where 1/sqrt(d) is not a power of two
    (the forward's test_band_bf16_keeps_fp32_scale_at_large_scores): key
    j a one-hot row of 680 at channel j % 128, query channels in [1,
    1.125). Rounding q * scale to bf16 would move each score by up to 0.13
    and P = exp(s - lse) by up to 13%; the scores kept in fp32 against K1
    bf16's lse give the plain version's gradients."""
    b, t, h, d, w = 4, 96, 4, 128, 4
    rng = np.random.default_rng(32)
    q = 1 + rng.random((b, t, h * d)) / 8
    k = np.zeros((b, t, h, d))
    k[:, np.arange(t), :, np.arange(t) % d] = 680.0
    v, dout = (rng.standard_normal((b, t, h * d)) for _ in range(2))
    mask = np.ones((b, t), bool)
    mask[1, 50:] = False
    mask[2, 30] = False
    q, k, v, dout = (torch.from_numpy(x.astype(np.float32))
                     .reshape(b, t, h * d).to(cuda, torch.bfloat16)
                     for x in (q, k, v, dout))
    mask = torch.from_numpy(mask).to(cuda)
    kw = dict(n_head=h, window_size=2 * w + 1)
    out, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True, **kw)
    assert lse[0].min() > 55
    band_backward_bf16_held(q, k, v, mask, lse, ba.band_rowsum(dout, out, h),
                            dout, kw)


@pytest.mark.parametrize("t,w,d,b,h", [
    (96, 3, 128, 24, 4), (96, 3, 128, 96, 4), (512, 4, 64, 48, 8),
    (100, 15, 256, 4, 4)])
def test_band_backward_bf16_is_deterministic(cuda, t, w, d, b, h):
    """At the bf16 train steps' shapes (24 and 96 pairs at VidVRD width,
    the rel-PE step's 48 pairs at VidOR local width) and the widest band
    and head dim: two launches of each kernel equal bit for bit, finite,
    held to the plain version."""
    band_backward_bf16_held(*band_backward_bf16_inputs(t + b, b, t, h, d, w,
                                                       cuda),
                            dict(n_head=h, window_size=2 * w + 1))


@pytest.mark.parametrize("t,w", [(96, 3), (70, 4), (49, 15)])
def test_band_backward_bf16_p_sums_to_one_against_the_forward_lse(cuda, t,
                                                                  w):
    """K2 rebuilds the bf16 forward's scores bit for bit, so its P =
    exp(s - lse) sums to 1 over each valid row against K1 bf16's lse. With
    v = 0 (dP = 0) and Dr = -1, dS = P; with every key's channel 0 of each
    head 1 (d = 64, scale 1/8 exactly), dQ's channel 0 is the row sum of P
    over 8, which rounds to bf16 1/8 exactly unless the sum is off by more
    than 2^-9 (an lse in log2 units, q * scale rounded to bf16 or a key
    mask missing from s would move it far more); invalid query rows 0."""
    b, h, d = 4, 2, 64
    q, k, _, mask, lse, _, dout = band_backward_bf16_inputs(
        t * 7 + w, b, t, h, d, w, cuda)
    k = k.view(b, t, h, d).clone()
    k[..., 0] = 1.0
    k = k.view(b, t, h * d)
    kw = dict(n_head=h, window_size=2 * w + 1)
    out, lse = ba.band_attention_cuda(q, k, torch.zeros_like(k), mask,
                                      with_lse=True, **kw)
    dq = ba.band_attention_dq_cuda(q, k, torch.zeros_like(k), mask, lse,
                                   torch.full_like(lse, -1.0), dout, **kw)
    torch.cuda.synchronize()
    sums = dq.view(b, t, h, d)[..., 0].float()
    assert (sums[mask] == 0.125).all(), sums[mask].unique()
    assert (dq[~mask] == 0).all()


def traced_backward_kernels(args, kw, path):
    """(name, grid, block) of the band backward kernels in
    ``traced_kernels`` runs of a dQ and a dK/dV launch, profiled again
    until a dQ and a dK/dV kernel are both in the traces."""
    import re

    def both(found):
        return {m[1] for name, _, _ in found
                if (m := re.search(r"kernel<\d+, \w+, (\w+)", name))} == {
            "true", "false"}

    return traced_kernels(lambda: (ba.band_attention_dq_cuda(*args, **kw),
                                   ba.band_attention_dkv_cuda(*args, **kw)),
                          path, "band_backward", both)


def test_band_backward_bf16_instance_is_what_launches(cuda, tmp_path):
    """The bf16 instance ``backward_instance`` reports is the one the C
    side launches: the tensor-core kernel ``band_backward_mma_kernel<
    bucket, vec, dkv, key tiles>`` (head-dim bucket, vector copies, K2 or
    K3, n8 partner tiles a warp), one tile a block (grid) of 4 warps
    (block), from a ``torch.profiler`` trace; the FMA body
    ``band_backward_kernel<..., __nv_bfloat16>`` never runs."""
    import re
    bf = torch.bfloat16
    for b, t, h, d, w in ((24, 96, 4, 128, 3), (24, 12, 4, 128, 3),
                          (96, 96, 4, 128, 3), (48, 512, 8, 64, 4),
                          (8, 1500, 8, 64, 4), (4, 70, 4, 20, 4),
                          (4, 100, 4, 256, 15)):
        q, k, v, mask = streams(t + d, b, t, t, h * d, [t] * b, cuda)
        dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            t)).to(cuda)
        q, k, v, dout = to_bf16(q, k, v, dout)
        kw = dict(n_head=h, window_size=2 * w + 1)
        out, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True, **kw)
        seen = set()
        for name, grid, block in traced_backward_kernels(
                (q, k, v, mask, lse, ba.band_rowsum(dout, out, h), dout), kw,
                tmp_path / f"trace{t}.json"):
            assert not re.search(r"band_backward_kernel<.*__nv_bfloat16",
                                 name), name
            m = re.search(r"band_backward_mma_kernel<(\d+), (true|false), "
                          r"(true|false), (\d+)>", name)
            if m is None:
                continue
            dkv = m[3] == "true"
            inst = ba.backward_instance(cuda.index or 0, b, t, h, d,
                                        2 * w + 1, dkv, dtype=bf)
            assert (int(m[1]), m[2] == "true", int(m[4])) == (
                inst["bucket"], inst["vec"], inst["key_tiles"])
            assert inst["per_block"] == 1 and inst["warps"] == 4
            assert inst["rows_warp"] == 16
            assert grid == [b * h * inst["tiles"], 1, 1]
            assert block == [32 * inst["warps"], 1, 1]
            seen.add(dkv)
        assert seen == {False, True}, (b, t, h, d, w)


def test_fp32_band_backward_launches_the_fma_kernel(cuda, tmp_path):
    """fp32 calls still launch the FMA body ``band_backward_kernel<bucket,
    vec, dkv, rows a warp, float>`` with the grid and block of
    ``backward_instance`` (32 threads a warp of 2 or 4 owner rows, no
    partner tiles), never the bf16 tensor-core kernel."""
    import re
    for b, t, h, d, w in ((24, 96, 4, 128, 3), (16, 512, 8, 64, 4)):
        q, k, v, mask = streams(5 + t, b, t, t, h * d, [t] * b, cuda)
        dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            t)).to(cuda)
        kw = dict(n_head=h, window_size=2 * w + 1)
        out, lse = ba.band_attention_cuda(q, k, v, mask, with_lse=True, **kw)
        seen = set()
        for name, grid, block in traced_backward_kernels(
                (q, k, v, mask, lse, ba.band_rowsum(dout, out, h), dout), kw,
                tmp_path / f"trace{t}.json"):
            assert "band_backward_mma_kernel" not in name, name
            m = re.search(r"band_backward_kernel<(\d+), (true|false), "
                          r"(true|false), (\d+), (\w+)>", name)
            assert m is not None and m[5] == "float", name
            dkv = m[3] == "true"
            inst = ba.backward_instance(cuda.index or 0, b, t, h, d,
                                        2 * w + 1, dkv)
            assert (int(m[1]), m[2] == "true", int(m[4])) == (
                inst["bucket"], inst["vec"], inst["rows_warp"])
            assert inst["rows_warp"] in (2, 4) and inst["key_tiles"] == 0
            assert grid == [b * h * -(-inst["tiles"] // inst["per_block"]),
                            1, 1]
            assert block == [32 * inst["rows"] // inst["rows_warp"], 1, 1]
            assert block == [32 * inst["warps"], 1, 1]
            seen.add(dkv)
        assert seen == {False, True}, (b, t, h, d, w)


def test_kernels_take_bf16_and_refuse_mixed_dtypes(cuda):
    """q, k and v in one dtype only, and dout in theirs for the backward
    kernels; K4 takes bf16 streams with a bf16 or fp32 table, refuses mixed
    stream dtypes, and a bf16 table beside fp32 streams."""
    q, k, v, mask = streams(2, 2, 16, 16, 64, [16, 8], cuda)
    q16, k16, v16 = to_bf16(q, k, v)
    with pytest.raises(TypeError, match="one dtype"):
        ba.band_attention_cuda(q16, k, v16, mask, n_head=4, window_size=7)
    with pytest.raises(TypeError, match="one dtype"):
        fa.full_attention_cuda(q, k16, v, mask, n_head=4)
    pe = pe_table(2, 4, 7, cuda)
    kw = dict(n_head=4, window_size=7)
    with pytest.raises(TypeError, match="one dtype"):
        ba.band_attention_pe_cuda(q16, k16, v, mask, pe, **kw)
    with pytest.raises(ValueError, match="rel_pe"):
        ba.band_attention_pe_cuda(q, k, v, mask, pe.to(torch.bfloat16), **kw)
    for table in (pe, pe.to(torch.bfloat16)):
        out = ba.band_attention_pe_cuda(q16, k16, v16, mask, table, **kw)
        assert out.dtype == torch.bfloat16
        assert bf16_err(out, ba.band_attention_pe_plain(
            q16, k16, v16, mask, table, **kw)) <= BF16_TOL
    out, lse = ba.band_attention_cuda(q16, k16, v16, mask, n_head=4,
                                      window_size=7, with_lse=True)
    dr = ba.band_rowsum(out, out, 4)
    for fn in (ba.band_attention_dq_cuda, ba.band_attention_dkv_cuda):
        with pytest.raises(TypeError, match="dout must have q's dtype"):
            fn(q16, k16, v16, mask, lse, dr, out.float(), n_head=4,
               window_size=7)
        with pytest.raises(TypeError, match="one dtype"):
            fn(q16, k, v16, mask, lse, dr, out, n_head=4, window_size=7)
        fn(q16, k16, v16, mask, lse, dr, out, n_head=4, window_size=7)


def test_bf16_instance_is_what_launches(cuda, tmp_path):
    """A bf16 call launches the bf16 instance: the kernels' template
    arguments (head-dim bucket, vector copies and key tiles of K1's
    tensor-core kernel ``band_forward_mma_kernel``; head-dim bucket, warps
    and row tiles a warp of K7's), grid and block, read from a
    ``torch.profiler`` trace, against ``forward_instance`` and
    ``_variant``; the FMA kernels, fp32's (``band_forward_kernel``,
    ``masked_attention_fwd_kernel``), never run on bf16 streams."""
    import re
    for b, t, h, d, w, tq in ((128, 96, 4, 128, 3, 9), (16, 512, 8, 64, 4, 9),
                              (4, 70, 4, 20, 4, 70), (4, 40, 4, 32, 9, 9)):
        q, k, v, mask = streams(t + d, b, t, t, h * d, [t] * b, cuda)
        q, k, v = to_bf16(q, k, v)
        kw = dict(n_head=h, window_size=2 * w + 1)
        inst = ba.forward_instance(cuda.index or 0, b, t, h, d, 2 * w + 1,
                                   dtype=torch.bfloat16)
        seen = set()
        for name, grid, block in traced_kernels(
                lambda: (ba.band_attention_cuda(q, k, v, mask, **kw),
                         fa.full_attention_cuda(q[:, :tq].contiguous(), k, v,
                                                mask, n_head=h)),
                tmp_path / f"trace{t}.json", "band_forward|masked_attention",
                lambda found: all(any(part in n for n, _, _ in found) for part
                                  in ("band_forward_mma_kernel",
                                      "masked_attention_mma_kernel"))):
            if "band_forward" in name:
                if check_mma_launch(name, grid, block, inst, b, h, False):
                    seen.add("band")
            elif m := re.search(r"masked_attention_mma_kernel<(\d+), "
                                r"(\d+), (\d+)>", name):
                rows, bucket = fa._variant(tq, d, torch.bfloat16)
                warps, tiles = int(m[2]), int(m[3])
                assert (int(m[1]), 16 * tiles * warps) == (bucket, rows)
                assert grid == [b * h * -(-tq // rows), 1, 1]
                assert block == [32 * warps, 1, 1]
                seen.add("full")
            assert "masked_attention_fwd_kernel" not in name
        assert seen == {"band", "full"}, (b, t, h, d)


def test_fp32_band_forward_launches_the_fma_kernel(cuda, tmp_path):
    """fp32 calls, with and without the bias, still launch the FMA body
    ``band_forward_kernel<bucket, vec, pe, float>`` with the grid and block
    of ``forward_instance`` (8 threads a query row), never the bf16
    tensor-core kernel."""
    import re
    b, t, h, d, w = 16, 512, 8, 64, 4
    q, k, v, mask = streams(5, b, t, t, h * d, [t] * b, cuda)
    pe = pe_table(5, h, 2 * w + 1, cuda)
    kw = dict(n_head=h, window_size=2 * w + 1)
    fma = r"band_forward_kernel<(\d+), (true|false), (true|false), (\w+)>"
    seen = set()
    for name, grid, block in traced_kernels(
            lambda: (ba.band_attention_cuda(q, k, v, mask, **kw),
                     ba.band_attention_pe_cuda(q, k, v, mask, pe, **kw)),
            tmp_path / "trace.json", "band_forward",
            lambda found: {m[3] for n, _, _ in found
                           if (m := re.search(fma, n))} == {"true", "false"}):
        assert "band_forward_mma_kernel" not in name, name
        m = re.search(fma, name)
        assert m is not None and m[4] == "float", name
        pe_arg = m[3] == "true"
        inst = ba.forward_instance(cuda.index or 0, b, t, h, d, 2 * w + 1,
                                   pe=pe_arg)
        assert (int(m[1]), m[2] == "true") == (inst["bucket"], inst["vec"])
        assert grid == [b * h * -(-inst["tiles"] // inst["per_block"]), 1, 1]
        assert block == [8 * inst["rows"], 1, 1] == [32 * inst["warps"], 1, 1]
        assert inst["key_tiles"] == 0
        seen.add(pe_arg)
    assert seen == {False, True}


def test_model_bf16_forward_on_card_matches_cpu(cuda):
    """A small MaskVRD's ``cast_floating`` copy: the bf16 forward on the
    card (bf16 instances only) against the bf16 forward on the CPU (plain
    versions) within 5e-2 of max |ref| (tests/test_torch_bf16.py's
    MODEL_TOL), its heads fp32."""
    cfg = ModelConfig(visual_dim=24, embd_dim=32, fpn_dim=16,
                      max_seq_len=48, predictor=PredictorConfig(
                          n_input=32, n_embd=16, n_hidden=64, num_layers=3))
    gen = torch.Generator().manual_seed(0)
    cpu = MaskVRD(cfg, device=torch.device("cpu"), generator=gen)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, AffineDropPath):
                m.scale.uniform_(0.5, 1.5, generator=gen)
    gpu = MaskVRD(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    cpu, gpu = cast_floating(cpu), cast_floating(gpu)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (3, 48, 2 * 24 + 5 + 16)).astype(np.float32)).to(torch.bfloat16)
    mask = torch.from_numpy(np.arange(48)[None]
                            < np.array([48, 24, 11])[:, None])
    ba.launches = ba.bf16_launches = fa.launches = fa.bf16_launches = 0
    with torch.no_grad():
        out = gpu(x.to(cuda), mask.to(cuda))
        torch.cuda.synchronize()
        k1 = 2 * cfg.backbone_arch[1] + cfg.backbone_arch[2]
        k7 = 4 * cfg.backbone_arch[1] + 2 * cfg.predictor.num_layers
        assert (ba.launches, ba.bf16_launches) == (k1, k1)
        assert (fa.launches, fa.bf16_launches) == (k7, k7)
        ref = cpu(x, mask)
    for key in ("pred_logits", "pred_masks"):
        assert out[key].dtype == torch.float32
        top = ref[key].abs().max().item()
        assert max_err(out[key].cpu(), ref[key]) <= 5e-2 * top, key


# ---------------------------------------------------------------------------
# bf16 instance of the fused set-attention kernel (K5)
# ---------------------------------------------------------------------------

def mega_bf16_case(seed, g, n, m, dg, dgo, p_valid, cuda):
    """``mega_case`` with q, k and vproj in bf16 (ub and the bias operands
    fp32, as the bf16 head hands them over)."""
    q, k, vp, ub, valid, *bias = mega_case(seed, g, n, m, dg, dgo, p_valid,
                                           cuda)
    return (*to_bf16(q, k, vp), ub, valid, *bias)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("g,n,m,dg,dgo,p_valid", [
    (16, 675, 3750, 64, 64, 0.9),     # local stage 0
    (16, 675, 750, 64, 64, 0.9),      # local stage 1
    (16, 300, 750, 64, 64, 0.9),      # local stage 2, global
    (16, 1875, 750, 64, 64, 0.9),     # global over the window
    (4, 10, 12, 256, 256, 0.7),       # the small detector's groups
    (5, 13, 77, 32, 40, 0.5),         # 16-byte key loads, ragged dgo
    (5, 13, 77, 30, 40, 0.5),         # dg % 8 != 0: 2-byte key loads
    (16, 37, 101, 16, 24, 0.3),
    (2, 3, 1, 8, 8, 1.0)])
def test_mega_attention_bf16_instance_matches_plain(cuda, with_bias, g, n,
                                                    m, dg, dgo, p_valid):
    """The bf16 instance against the bf16 plain version (both round P to
    bf16 before P.V and the output once; the kernel against the running
    max of 32-key tiles and splits): within BF16_TOL; only the bf16 count
    moves apart from the total."""
    q, k, vp, ub, valid, *bias = mega_bf16_case(n * 7 + m, g, n, m, dg, dgo,
                                                p_valid, cuda)
    bias = bias if with_bias else []
    before, before16 = ma.launches, ma.bf16_launches
    got = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    torch.cuda.synchronize()
    assert (ma.launches, ma.bf16_launches) == (before + 1, before16 + 1)
    want = ma.mega_attention_plain(q, k, vp, ub, valid, *bias)
    assert got.shape == (n, g * dgo) and torch.isfinite(got.float()).all()
    assert bf16_err(got, want) <= BF16_TOL


@pytest.mark.parametrize("with_bias", [True, False])
def test_mega_attention_bf16_splits_merge_and_skip_invalid_keys(cuda,
                                                                with_bias):
    """At stage 0's shape the bf16 instance splits the keys (its own
    occupancy), merges them the same way every run, writes exactly 0 for a
    row without a valid key and never reads an invalid key's k or vproj
    (NaN there)."""
    q, k, vp, ub, valid, *bias = mega_bf16_case(5, 16, 675, 3750, 64, 64,
                                                0.9, cuda)
    bias = bias if with_bias else []
    assert ma.launch_plan(q.device.index, 675, 3750, 16, 64, 64,
                          True)[1] > 1
    want = ma.mega_attention_plain(q, k, vp, ub, valid, *bias)
    k[:, ~valid] = float("nan")
    vp[:, ~valid] = float("nan")
    first = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    second = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.isfinite(first.float()).all()
    assert bf16_err(first, want) <= BF16_TOL
    none = torch.zeros_like(valid)
    assert (ma.fused_mega_attention(q, k, vp, ub, none, *bias) == 0).all()


def test_mega_attention_bf16_refuses_mixed_dtypes(cuda):
    """q, k and vproj in one dtype; ub fp32 in either instance; no quiet
    cast before the kernel."""
    q, k, vp, ub, valid, *bias = mega_bf16_case(1, 4, 8, 16, 16, 16, 1.0,
                                                cuda)
    with pytest.raises(TypeError, match="one dtype"):
        ma.fused_mega_attention(q, k.float(), vp, ub, valid, *bias)
    with pytest.raises(TypeError, match="one dtype"):
        ma.fused_mega_attention(q.float(), k, vp, ub, valid, *bias)
    with pytest.raises(TypeError, match="ub"):
        ma.fused_mega_attention(q, k, vp, ub.to(torch.bfloat16), valid,
                                *bias)
    with pytest.raises(TypeError, match="dtype"):
        ma.fused_mega_attention(q.half(), k.half(), vp.half(), ub, valid)
    qs, ks, vs = shifted(q), shifted(k), shifted(vp)
    assert ks.data_ptr() % 16 and ks.is_contiguous()
    assert bf16_err(ma.fused_mega_attention(qs, ks, vs, ub, valid, *bias),
                    ma.mega_attention_plain(q, k, vp, ub, valid, *bias)) \
        <= BF16_TOL


def test_mega_attention_bf16_instance_is_what_launches(cuda, tmp_path):
    """A bf16 call launches the tensor-core kernel
    ``mega_attention_mma_kernel<bucket, groups>`` with the bucket and the
    groups a block that ``mma_instance`` reports, 16 rows a block, the
    splits of ``launch_plan`` and ceil(G / groups) blocks along grid.z
    (4 at dg = dgo = 256, where a block takes 4 groups), then the bf16
    merge; never the FMA kernel ``mega_attention_kernel`` (fp32's), read
    from a ``torch.profiler`` trace."""
    import re
    for g, n, m, dg, dgo in ((16, 675, 3750, 64, 64), (16, 40, 300, 256, 256),
                             (5, 13, 77, 30, 40)):
        q, k, vp, ub, valid, *bias = mega_bf16_case(2, g, n, m, dg, dgo, 0.9,
                                                    cuda)
        rows, splits = ma.launch_plan(cuda.index or 0, n, m, g, dg, dgo, True)
        bucket, groups = ma.mma_instance(g, dg, dgo)
        assert rows == 16 and bucket == max(16, 1 << (max(dg, dgo) - 1)
                                            .bit_length())
        want = ("mega_attention_mma_kernel",) + (
            ("mega_attention_merge",) if splits > 1 else ())
        seen = set()
        for name, grid, block in traced_kernels(
                lambda: ma.fused_mega_attention(q, k, vp, ub, valid, *bias),
                tmp_path / f"trace{dg}.json", "mega_attention",
                lambda found: all(any(part in x for x, _, _ in found)
                                  for part in want)):
            assert not re.search(r"mega_attention_kernel<", name), name
            if mm := re.search(r"mega_attention_mma_kernel<(\d+), (\d+)>",
                               name):
                assert (int(mm[1]), int(mm[2])) == (bucket, groups)
                assert grid == [-(-n // rows), splits, -(-g // groups)]
                assert block == [32 * min(g, groups), 1, 1]
                seen.add("kernel")
            elif "mega_attention_merge" in name:
                assert "__nv_bfloat16" in name
                seen.add("merge")
        assert seen == ({"kernel", "merge"} if splits > 1 else {"kernel"}), (
            g, n, m, dg, dgo, splits)
    assert ma.mma_instance(16, 256, 256) == (256, 4)


def test_mega_attention_fp32_launches_the_fma_kernel(cuda, tmp_path):
    """An fp32 call still launches the FMA kernel
    ``mega_attention_kernel<rows, floats a lane, float>`` with the rows of
    ``launch_plan``, and never the bf16 tensor-core kernel."""
    import re
    n, m = 675, 3750
    q, k, vp, ub, valid, *bias = mega_case(2, 16, n, m, 64, 64, 0.9, cuda)
    rows, splits = ma.launch_plan(cuda.index or 0, n, m, 16, 64, 64)
    fma = r"mega_attention_kernel<(\d+), (\d+), (\w+)>"
    seen = set()
    for name, grid, _ in traced_kernels(
            lambda: ma.fused_mega_attention(q, k, vp, ub, valid, *bias),
            tmp_path / "trace.json", "mega_attention",
            lambda found: any(re.search(fma, x) for x, _, _ in found)):
        assert "mega_attention_mma_kernel" not in name, name
        if mm := re.search(fma, name):
            assert (int(mm[1]), mm[3]) == (rows, "float")
            assert grid == [-(-n // rows), splits, 1]
            seen.add("kernel")
    assert seen == {"kernel"}


def mega_bf16_held(q, k, vp, ub, valid, bias, want=None):
    """The bf16 kernel's output on these operands, held to the bf16 plain
    version (``want``, else computed here) within BF16_TOL, finite and of
    the plain version's shape."""
    got = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    if want is None:
        want = ma.mega_attention_plain(q, k, vp, ub, valid, *bias)
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert bf16_err(got, want) <= BF16_TOL
    return got


@pytest.mark.parametrize("n", [1, 15, 16, 17, 33])
@pytest.mark.parametrize("m", [1, 15, 16, 17, 31, 33])
def test_mega_bf16_tile_edges(cuda, n, m):
    """Query rows and keys on either side of the 16-row block and the
    16-key tile, with and without the bias."""
    q, k, vp, ub, valid, *bias = mega_bf16_case(100 * n + m, 3, n, m, 64, 64,
                                                0.8, cuda)
    for extra in (bias, []):
        mega_bf16_held(q, k, vp, ub, valid, extra)


@pytest.mark.parametrize("dg", [8, 16, 24, 30, 64, 100, 128, 256])
@pytest.mark.parametrize("dgo", [8, 16, 24, 30, 64, 100, 128, 256])
def test_mega_bf16_width_buckets(cuda, dg, dgo):
    """Every channel bucket (16 to 256 of max(dg, dgo)), with 16-byte copies
    (dg and dgo multiples of 8) and 2-byte ones (30, 100), at 1, 5 and 16
    groups (16 at 256: four chunks of 4 groups along grid.z)."""
    for g in (1, 5, 16):
        q, k, vp, ub, valid, *bias = mega_bf16_case(dg * dgo + g, g, 23, 45,
                                                    dg, dgo, 0.7, cuda)
        for extra in (bias, []):
            mega_bf16_held(q, k, vp, ub, valid, extra)


@pytest.mark.parametrize("g,n,m,dg,dgo", [
    (5, 20, 77, 32, 24),     # the 32 bucket, 16-byte copies
    (3, 17, 50, 100, 128),   # the 128 bucket, 2-byte copies
    (2, 9, 40, 30, 40)])     # the 64 bucket, 2-byte copies
def test_mega_bf16_never_reads_invalid_keys(cuda, g, n, m, dg, dgo):
    """NaN in k and inf in vproj (then -inf and NaN) at every invalid key
    and past M: the copies zero-fill those keys, so nothing of them reaches
    S or P.V, where 0 * NaN would be NaN on the tensor cores too. Held to
    the plain version on the clean operands."""
    q, k, vp, ub, valid, *bias = mega_bf16_case(g + m, g, n, m, dg, dgo, 0.5,
                                                cuda)
    keys = valid.expand(g, m)  # poisoned's (rows, keys) mask
    for extra in (bias, []):
        want = ma.mega_attention_plain(q, k, vp, ub, valid, *extra)
        for fk, fv in ((float("nan"), float("inf")),
                       (float("-inf"), float("nan"))):
            mega_bf16_held(q, poisoned(k, keys, fk), poisoned(vp, keys, fv),
                           ub, valid, extra, want)


def test_mega_bf16_splits_merge_in_natural_log_units(cuda):
    """Scores near 30 over key splits whose maxima differ by whole units:
    key j is a one-hot row of 320 at channel j % 128 and every query
    channel lies in [1, 1.125), so a score is 320 q_c / sqrt(128), 28 to
    32, and ub lowers each quarter of the keys by one more unit. The merge
    weighs each split by exp(m_s - m_max), so a split's max stored in
    log2 units (or any other) moves the output by several times the
    limit."""
    g, n, m, d = 2, 16, 160, 128
    rng = np.random.default_rng(30)
    q = 1 + rng.random((g, n, d)) / 8
    k = np.zeros((g, m, d))
    k[:, np.arange(m), np.arange(m) % d] = 320.0
    vp = rng.standard_normal((g, m, d))
    ub = np.repeat(-np.arange(4.0), m // 4)[None].repeat(g, 0)
    q, k, vp = (torch.from_numpy(x.astype(np.float32)).to(cuda, torch.bfloat16)
                for x in (q, k, vp))
    ub = torch.from_numpy(ub.astype(np.float32)).to(cuda)
    valid = torch.ones(m, dtype=torch.bool, device=cuda)
    assert ma.launch_plan(cuda.index or 0, n, m, g, d, d, True)[1] > 1
    mega_bf16_held(q, k, vp, ub, valid, [])


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("g,n,m,dg,dgo", [
    (16, 675, 3750, 64, 64), (16, 1875, 750, 64, 64), (16, 40, 300, 256, 256),
    (5, 13, 77, 30, 40)])
def test_mega_bf16_is_deterministic(cuda, with_bias, g, n, m, dg, dgo):
    """Two launches on the same operands are equal bit for bit (the merge
    sums the splits in split order)."""
    q, k, vp, ub, valid, *bias = mega_bf16_case(n + m, g, n, m, dg, dgo, 0.9,
                                                cuda)
    bias = bias if with_bias else []
    first = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    second = ma.fused_mega_attention(q, k, vp, ub, valid, *bias)
    assert torch.equal(first, second)


def test_mega_bf16_walks_past_the_mask_window(cuda):
    """Past 4096 keys a block reads the next window of valid-key bits. With
    70,000 keys and one row block the 16 splits (at most) take over 4,096
    keys each, so every split moves its window: a run of invalid keys
    across split 0's window edge (key 4096), no valid key in the first
    tiles, and 100 in vproj at every invalid key, which any key taken from
    the wrong window's bits would show; then valid keys only past the last
    split's window edge."""
    m = 70_000
    q, k, vp, ub, valid, *bias = mega_bf16_case(5, 1, 5, m, 16, 16, 0.9,
                                                cuda)
    splits = ma.launch_plan(cuda.index or 0, 5, m, 1, 16, 16, True)[1]
    assert -(-m // 16) // splits * 16 > 4096
    valid[4000:4300] = False
    valid[:100] = False
    vp[:, ~valid] = 100.0
    for extra in (bias, []):
        mega_bf16_held(q, k, vp, ub, valid, extra)
    late = torch.zeros_like(valid)
    late[m - 60:m - 50] = True
    mega_bf16_held(q, k, vp, ub, late, [])


def test_mega_head_bf16_on_card_matches_cpu(cuda):
    """MEGAHead.enhance of a ``cast_floating`` 16-group head with memory
    and global sets on bf16 features: the card through K5's bf16 instance
    (6 launches, none of the fp32 one) against the CPU's bf16 plain
    version, within JAX's bf16 limits (5e-2 of max |ref| at the largest
    gap, 5e-3 on average); the dense route's fp32 attention through K6."""
    from vrdone_tpu_torch.models.mega import BoxSet, MEGAHead
    gen = torch.Generator().manual_seed(0)
    cpu = MEGAHead(feat_dim=256, groups=16, stage=3, advanced_num=3,
                   in_dim=128, device=torch.device("cpu"), generator=gen)
    gpu = MEGAHead(feat_dim=256, groups=16, stage=3, advanced_num=3,
                   in_dim=128, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    cpu, gpu = cast_floating(cpu), cast_floating(gpu)
    rng = np.random.default_rng(3)
    bf = torch.bfloat16

    def boxes(*shape):
        xy = rng.uniform(0, 500, (*shape, 2))
        return np.concatenate([xy, xy + rng.uniform(8, 200, (*shape, 2))],
                              -1).astype(np.float32)

    arrays = [rng.standard_normal((12, 128)).astype(np.float32), boxes(12),
              np.arange(12) < 10,
              rng.standard_normal((5, 6, 256)).astype(np.float32),
              boxes(5, 6), rng.uniform(size=(5, 6)) < 0.8]
    mems = [(rng.standard_normal((n, 256)).astype(np.float32), boxes(n),
             rng.uniform(size=n) < 0.8) for n in (30, 15, 15)]
    glob = (rng.standard_normal((20, 256)).astype(np.float32), boxes(20),
            np.ones(20, bool))

    def tensors(xs, dev):
        out = [torch.from_numpy(np.asarray(a)).to(dev) for a in xs]
        return [x.to(bf) if x.dtype == torch.float32 and x.shape[-1] != 4
                else x for x in out]

    def run(head, dev, **flags):
        tt = tensors(arrays, dev)
        mem = [BoxSet(*tensors(x, dev)) for x in mems]
        gl = BoxSet(*tensors(glob, dev))
        with torch.no_grad():
            return head.routed(**flags).enhance(
                tt[0], tt[1], tt[2], BoxSet(*tt[3:]), mem, gl).float().cpu()

    for flags, counts in ((dict(fused_pe_bias=False, fused_attention=True),
                           (6, 6, 0)),
                          (dict(fused_pe_bias=True, fused_attention=False),
                           (0, 0, 3))):
        want = run(cpu, torch.device("cpu"), **flags)
        ma.launches = ma.bf16_launches = pb.launches = 0
        got = run(gpu, cuda, **flags)
        torch.cuda.synchronize()
        assert (ma.launches, ma.bf16_launches, pb.launches) == counts
        scale = want.abs().max().item()
        assert max_err(got, want) <= 5e-2 * scale, flags
        assert (got - want).abs().mean().item() <= 5e-3 * scale, flags


def test_fgfa_detect_video_on_card_matches_cpu(cuda):
    """fgfa_detect_video (FlowNetS, the flow warp, EmbedNet and the cosine
    aggregation; no hand kernel on its path) of a small FGFA detector on
    the card against the same weights on the CPU: valid slots equal,
    proposals within 1e-3 pixel, logits and deltas within 1e-3 of their
    largest magnitude (chip_smoke.py's DETECT_TOL); no MEGA kernel
    launched."""
    from vrdone_tpu_torch.models import flownet
    kw = dict(num_classes=5, resnet_layers=(1, 1, 1), window=3, key_loc=1)
    cpu_det = flownet.FGFADetector(**kw, device=torch.device("cpu"),
                                   generator=torch.Generator().manual_seed(2))
    gpu_det = flownet.FGFADetector(**kw, device=cuda)
    gpu_det.load_state_dict(cpu_det.state_dict())
    images = np.random.default_rng(10).integers(0, 256, (3, 64, 96, 3),
                                                dtype=np.uint8)
    hw = np.asarray([64, 96], np.float32)
    ma.launches = pb.launches = pb.factor_launches = 0
    want = flownet.fgfa_detect_video(cpu_det, images, hw, post_nms_top_n=8)
    got = flownet.fgfa_detect_video(gpu_det, images, hw, post_nms_top_n=8)
    torch.cuda.synchronize()
    assert (ma.launches, pb.launches, pb.factor_launches) == (0, 0, 0)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_allclose(got["proposals"], want["proposals"], rtol=0,
                               atol=1e-3)
    for key in ("cls_logits", "bbox_deltas"):
        scale = np.abs(want[key]).max()
        assert np.abs(got[key] - want[key]).max() <= 1e-3 * scale, key


def halo_extended(x, a, t_local, w, fill_rows_with_zero=False):
    """Rows [a - w, a + t_local + w) of the global (B, T, ...) ``x``, zero
    past the global edges (all of the halo rows zero with
    ``fill_rows_with_zero``): what a sequence-parallel rank's band layer
    reads (``ops/masked.py::band_attention`` under ``time_sharded``)."""
    pad = torch.zeros((x.shape[0], w, *x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    ext = torch.cat([pad, x, pad], 1)[:, a:a + t_local + 2 * w].clone()
    if fill_rows_with_zero:
        ext[:, :w] = 0
        ext[:, w + t_local:] = 0
    return ext


@pytest.mark.parametrize("t_local,w,ranks", [(256, 4, 2), (3, 3, 4)])
def test_band_kernels_on_halo_extended_streams(cuda, tmp_path, t_local, w,
                                               ranks):
    """The band kernels a sequence-parallel rank launches: K1 with its lse,
    K2 and K3 over T_local + 2w rows (q's halo rows zero, k's and v's and
    the key mask's the neighbours', masked zeros past the global edges),
    through ``mops.band_attention`` on leaves that require grad. The
    central rows equal the plain version's rows of the whole sequence, the
    halo query rows get no gradient, and the k and v gradients of every
    extended row (the halo gradients a rank sends back) equal the plain
    version's for the upstream gradient of this rank's rows alone. The
    shapes: VidOR local's 256 frames a rank at sp 2 (window 9), and 3
    frames a rank at sp 4 with a half-window of 3 (a halo as wide as a
    shard). The trace shows the kernels at T_local + 2w, as
    ``forward_instance`` and ``backward_instance`` report them."""
    import re
    b, h, d = 3, 8, 64
    t = ranks * t_local
    window = 2 * w + 1
    kw = dict(n_head=h, window_size=window)
    q, k, v, mask = streams(t_local + w, b, t, t, h * d,
                            [t, t - t_local - 1, t_local], cuda)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(
        t_local)).to(cuda)
    te = t_local + 2 * w
    for r in range(ranks):
        a = r * t_local
        rows = torch.zeros(t, 1, device=cuda)
        rows[a:a + t_local] = 1
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        ref = ba.band_attention_plain(*leaves, mask, **kw)
        (ref * dout * rows).sum().backward()
        ext = [halo_extended(x, a, t_local, w, i == 0).requires_grad_()
               for i, x in enumerate((q, k, v))]
        m_ext = halo_extended(mask, a, t_local, w)
        launched = (ba.launches, ba.dq_launches, ba.dkv_launches)
        out = mops.band_attention(*ext, m_ext, **kw)
        (out[:, w:w + t_local] * dout[:, a:a + t_local]).sum().backward()
        assert (ba.launches, ba.dq_launches, ba.dkv_launches) == tuple(
            n + 1 for n in launched)
        assert max_err(out[:, w:w + t_local], ref[:, a:a + t_local]) <= TOL
        dq = ext[0].grad
        assert max_err(dq[:, w:w + t_local],
                       leaves[0].grad[:, a:a + t_local]) <= 1e-5 * max(
            1.0, leaves[0].grad.abs().max().item())
        assert dq[:, :w].abs().max().item() == 0
        assert dq[:, w + t_local:].abs().max().item() == 0
        for got, leaf in zip(ext[1:], leaves[1:]):
            want = halo_extended(leaf.grad, a, t_local, w)
            assert max_err(got.grad, want) <= 1e-5 * max(
                1.0, leaf.grad.abs().max().item()), (r, t_local)

    ext = [halo_extended(x, t_local, t_local, w, i == 0).requires_grad_()
           for i, x in enumerate((q, k, v))]
    m_ext = halo_extended(mask, t_local, t_local, w)
    fwd = ba.forward_instance(cuda.index or 0, b, te, h, d, window)
    seen = set()

    def step():
        out = mops.band_attention(*ext, m_ext, **kw)
        out[:, w:w + t_local].sum().backward()

    for name, grid, _ in traced_kernels(
            step, tmp_path / "trace.json", "band_",
            lambda found: {("backward" in n) for n, _, _ in found} == {
                True, False}):
        if "band_forward_kernel" in name:
            assert grid == [b * h * -(-fwd["tiles"] // fwd["per_block"]), 1,
                            1], (grid, fwd)
            seen.add("K1")
        elif m := re.search(r"band_backward_kernel<\d+, (true|false), "
                            r"(true|false)", name):
            seen.add("K3" if m[2] == "true" else "K2")
        assert "mma" not in name, name
    assert seen == {"K1", "K2", "K3"}


# ---------------------------------------------------------------------------
# the full attention's backward (K8: dQ, K9: dK and dV) and K7's lse
# ---------------------------------------------------------------------------

def full_backward_case(cuda, seed, b, tq, tk, h, d, dtype, shift=False):
    """Streams of ``dtype`` (item 0 whole, item 1 padded with an invalid
    key inside, item 2 without a valid key when b > 2), dout, and K7's
    output and lse; ``shift`` moves every stream off 16-byte alignment."""
    lens = [tk, max(1, 2 * tk // 3), 0][:b] + [tk] * max(0, b - 3)
    q, k, v, mask = streams(seed, b, tq, tk, h * d, lens, cuda)
    mask[1, tk // 3] = False
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(
        seed)).to(cuda)
    q, k, v, dout = (x.to(dtype) for x in (q, k, v, dout))
    if shift:
        q, k, v, dout = (shifted(x) for x in (q, k, v, dout))
    out, lse = fa.full_attention_cuda(q, k, v, mask, n_head=h, with_lse=True)
    return q, k, v, mask, dout, out, lse


def full_backward_errs(q, k, v, mask, dout, out, lse, h):
    """K8 and K9 against ``full_attention_backward_plain`` on the same
    streams, lse and Dr: each gradient's max error over its limit (1e-5 of
    max(1, max |plain|) in fp32, as ``chip_smoke.py``'s GRAD_TOL: a
    gradient can be 0 analytically, as dK is with a single key, where the
    two sides' rounding of dP - Dr is all that is left; ``BF16_TOL`` of
    1 + max |plain| in bf16), K7's lse error over its limit (1e-5 of
    1 + |lse|, +inf exactly where a row has no valid key), and the launched
    gradients."""
    dr = ba.band_rowsum(dout, out, h)
    args = (q, k, v, mask, lse, dr, dout)
    got = (fa.full_attention_dq_cuda(*args, n_head=h),
           *fa.full_attention_dkv_cuda(*args, n_head=h))
    want = fa.full_attention_backward_plain(*args, n_head=h)
    ref_lse = fa.full_attention_lse_plain(q, k, mask, n_head=h)
    torch.cuda.synchronize()
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isposinf(lse), ~fin)
    ratios = [((lse - ref_lse).abs()[fin] / (1 + ref_lse.abs()[fin])).max()
              .item() / 1e-5]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == q.dtype and torch.isfinite(g).all()
        w = w.float()
        limit = (1e-5 * max(1.0, w.abs().max().item())
                 if q.dtype == torch.float32
                 else BF16_TOL * (1 + w.abs().max().item()))
        ratios.append(max_err(g.float(), w) / limit)
    return ratios, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("tq,tk,d,h", [
    # VidOR's S/O cross-attention, the predictor's 9 x 9 and 9 x 64 (its
    # cross-attention over the coarsest level), and 9 x 512
    (512, 512, 64, 8), (9, 9, 32, 8), (9, 64, 32, 8), (9, 512, 32, 8),
    # the head-dim buckets, Tq != Tk, both off the 32-row tiles
    (100, 70, 32, 2), (65, 97, 64, 2), (100, 70, 128, 2), (40, 33, 256, 2),
    (33, 17, 128, 2), (17, 200, 256, 2), (1, 1, 32, 2),
    # head dims off their bucket and off a multiple of 4 or 8
    (48, 48, 20, 3), (70, 45, 100, 2)])
def test_full_backward_kernels_match_plain(cuda, tq, tk, d, h, dtype):
    """K7's lse and K8 / K9 against their plain versions: Tq != Tk, padded
    keys, an item without a valid key (its dQ and its keys' dK and dV 0),
    every head-dim bucket; an invalid key gets exactly zero dK and dV."""
    case = full_backward_case(cuda, tq * 7 + tk + d, 3, tq, tk, h, d, dtype)
    mask = case[3]
    ratios, (dq, dk, dv) = full_backward_errs(*case, h)
    assert max(ratios) <= 1, ratios
    assert (dq[2] == 0).all()
    assert (dk[~mask] == 0).all() and (dv[~mask] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [32, 40, 64, 128, 256])
def test_full_backward_unaligned_streams_take_the_scalar_path(cuda, d,
                                                              dtype):
    """Streams one element off 16-byte alignment take the element-wise
    copies and give the vector path's gradients."""
    kw = dict(b=3, tq=70, tk=45, h=2, d=d, dtype=dtype)
    aligned = full_backward_case(cuda, d, **kw)
    ratios, got = full_backward_errs(
        *full_backward_case(cuda, d, **kw, shift=True), 2)
    assert max(ratios) <= 1, ratios
    _, want = full_backward_errs(*aligned, 2)
    for g, w in zip(got, want):
        assert max_err(g.float(), w.float()) <= 1e-6 * (
            1 + w.float().abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_full_attention_function_matches_plain_autograd(cuda, dtype,
                                                         monkeypatch):
    """With ``FLASH_TRAIN`` a full attention that needs a gradient runs
    ``FullAttention`` on the card: one K7 launch with the lse, one K8 and
    one K9, no dense form; its gradients are autograd's of the plain
    version (fp32) or within ``BF16_TOL`` of it (bf16, where the kernels
    round P and dS to bf16 before their products). Under no_grad the same
    dispatch launches K7 alone."""
    monkeypatch.setattr(mops, "FLASH_TRAIN", True)
    q, k, v, mask, dout, _, _ = full_backward_case(cuda, 5, 3, 96, 80, 4, 32,
                                                   dtype)
    for name in ("launches", "lse_launches", "dq_launches", "dkv_launches",
                 "bf16_dq_launches", "bf16_dkv_launches", "dense_calls"):
        setattr(fa, name, 0)
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = mops.full_attention(*qkv, mask, n_head=4, allow_kernel=False)
    grads = torch.autograd.grad(out, qkv, dout)
    torch.cuda.synchronize()
    bf16 = int(dtype == torch.bfloat16)
    assert (fa.launches, fa.lse_launches, fa.dq_launches, fa.dkv_launches,
            fa.bf16_dq_launches, fa.bf16_dkv_launches,
            fa.dense_calls) == (1, 1, 1, 1, bf16, bf16, 0)
    ref_in = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = fa.full_attention_plain(*ref_in, mask, n_head=4)
    want = torch.autograd.grad(ref, ref_in, dout)
    for g, w in zip(grads, want):
        w = w.float()
        limit = (1e-5 * max(1.0, w.abs().max().item()) if bf16 == 0
                 else BF16_TOL * (1 + w.abs().max().item()))
        assert max_err(g.float(), w) <= limit
    with torch.no_grad():
        mops.full_attention(q, k, v, mask, n_head=4, allow_kernel=False)
    assert (fa.launches, fa.lse_launches, fa.dense_calls) == (2, 1, 0)


def test_full_backward_refuses_and_never_falls_back(cuda, monkeypatch):
    """A head dim past 256, mixed dtypes or a wrong lse raise before any
    launch (the C side refuses the head dim too); with ``FLASH_TRAIN`` a
    head dim past 256 raises in the function's forward rather than taking a
    plain version."""
    monkeypatch.setattr(mops, "FLASH_TRAIN", True)
    q, k, v, mask, dout, out, lse = full_backward_case(cuda, 1, 2, 16, 16, 2,
                                                       32, torch.float32)
    dr = ba.band_rowsum(dout, out, 2)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    wide = [x.repeat(1, 1, 9) for x in (q, k, v, dout)]   # d = 288
    wide_lse = torch.zeros(2, 2, 16, device=cuda)
    for fn in (fa.full_attention_dq_cuda, fa.full_attention_dkv_cuda):
        with pytest.raises(ValueError, match="head dim"):
            fn(*wide[:3], mask, wide_lse, wide_lse, wide[3], n_head=2)
        with pytest.raises(TypeError, match="dtype"):
            fn(q, k, v, mask, lse, dr, dout.to(torch.bfloat16), n_head=2)
        with pytest.raises(ValueError, match="lse"):
            fn(q, k, v, mask, lse[:, :1].contiguous(), dr, dout, n_head=2)
    with pytest.raises(RuntimeError, match="invalid argument"):
        fa.backward_instance(cuda.index or 0, 16, 288)
    leaves = [x.clone().requires_grad_() for x in wide[:3]]
    with pytest.raises(ValueError, match="head dim"):
        mops.full_attention(*leaves, mask, n_head=2)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before


def test_full_backward_instance_is_what_launches(cuda, tmp_path):
    """The instance ``backward_instance`` reports is the one the C side
    launches, for K8 (owners: the Tq queries) and K9 (the Tk keys) in both
    dtypes, at every head-dim bucket: fp32 the FMA body
    ``masked_attention_bwd_kernel<bucket, rows / 16, K9>`` (128 threads),
    bf16 the tensor-core kernel ``masked_attention_bwd_mma_kernel<
    bucket, rows / 16, partner tile rows, K9>`` (a warp for each 16 owner
    rows) and never the FMA body; grid and block as the instance says,
    read from a ``torch.profiler`` trace; the rule's rows and tiles at the
    step's shapes."""
    import re
    for b, tq, tk, h, d in ((4, 512, 512, 8, 64), (4, 9, 512, 8, 32),
                            (4, 9, 9, 8, 32), (4, 9, 64, 8, 32),
                            (2, 100, 70, 2, 128), (2, 40, 33, 2, 256),
                            (2, 20, 30, 2, 100)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, dout, out, lse = full_backward_case(
                cuda, tq + d, b, tq, tk, h, d, dtype)
            args = (q, k, v, mask, lse, ba.band_rowsum(dout, out, h), dout)
            fp32 = dtype == torch.float32
            seen = set()
            for name, grid, block in traced_kernels(
                    lambda: (fa.full_attention_dq_cuda(*args, n_head=h),
                             fa.full_attention_dkv_cuda(*args, n_head=h)),
                    tmp_path / f"trace{tq}_{tk}_{d}.json",
                    "masked_attention_bwd_(mma_)?kernel",
                    lambda found: {"true>" in n for n, _, _ in found} == {
                        True, False}):
                m = re.search(r"masked_attention_bwd_(mma_)?kernel<(\d+), "
                              r"(\d+), (?:(\d+), )?(true|false)>", name)
                assert m is not None, name
                assert (m[1] is None) == fp32, name
                kv = m[5] == "true"
                n_own = tk if kv else tq
                inst = fa.backward_instance(cuda.index or 0, n_own, d, dtype)
                if fp32:
                    assert inst["rows"] == (16 if n_own <= 16 else
                                            {32: 64, 64: 64, 128: 32,
                                             256: 16}[inst["bucket"]])
                    assert inst["tile"] == 32 and m[4] is None, name
                    threads = 128
                else:
                    assert inst["rows"] == (16 if n_own <= 16 else 32
                                            if n_own <= 32 else 64)
                    assert inst["tile"] == (64 if inst["bucket"] <= 64
                                            else 32)
                    assert int(m[4]) == inst["tile"], name
                    threads = 2 * inst["rows"]
                assert (int(m[2]), 16 * int(m[3])) == (inst["bucket"],
                                                       inst["rows"])
                assert grid == [b * h * -(-n_own // inst["rows"]), 1, 1]
                assert block == [threads, 1, 1]
                seen.add(kv)
            assert seen == {False, True}, (tq, tk, d, dtype)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("tq", [1, 31, 32, 33, 63, 64, 65, 513])
def test_full_backward_bf16_tile_edges(cuda, tq, d):
    """The tensor-core instance at the edges of its tiles, for every Tk of
    the same list: 16, 32 or 64 owner rows a block (one warp for each 16),
    partner tiles of 64 rows (32 at the 128 and 256 buckets) and 8-row n8
    tiles, with an item whose keys are all valid, one with an invalid key
    inside its valid stretch and one without a valid key (its dQ and its
    keys' dK and dV exactly 0)."""
    for tk in (1, 31, 32, 33, 63, 64, 65, 513):
        case = full_backward_case(cuda, tq * 1000 + tk + d, 3, tq, tk, 2, d,
                                  torch.bfloat16)
        mask = case[3]
        ratios, (dq, dk, dv) = full_backward_errs(*case, 2)
        assert max(ratios) <= 1, (tk, ratios)
        assert (dq[2] == 0).all(), tk
        assert (dk[~mask] == 0).all() and (dv[~mask] == 0).all(), tk


def padded(x, fill):
    """A contiguous copy of x at the start of a larger buffer that holds
    ``fill`` past x's end (what a kernel would read past the last row)."""
    buf = torch.full((x.numel() + 4 * x.shape[-1],), fill, device=x.device,
                     dtype=x.dtype)
    y = buf[:x.numel()].view(x.shape)
    y.copy_(x)
    return y


@pytest.mark.parametrize("tq,tk,d", [
    (96, 96, 128), (9, 12, 64), (512, 100, 64), (40, 70, 20), (17, 33, 256),
    (70, 200, 64)])
def test_full_backward_bf16_never_reads_invalid_keys(cuda, tq, tk, d):
    """NaN in k and v at every invalid key, and in q, k, v, dout, lse and Dr
    past their last row: K8 and K9 give the gradients of the clean streams
    bit for bit (the copies zero-fill invalid keys and rows past the edge,
    and P and dS exclude them by selection, where 0 * NaN would be NaN on
    the tensor cores), and those are within ``BF16_TOL`` of the plain
    version."""
    h = 2
    q, k, v, mask, dout, out, lse = full_backward_case(
        cuda, tq + tk + d, 3, tq, tk, h, d, torch.bfloat16)
    k, v = (torch.where(mask[..., None], x, 0) for x in (k, v))
    dr = ba.band_rowsum(dout, out, h)
    ratios, want = full_backward_errs(q, k, v, mask, dout, out, lse, h)
    assert max(ratios) <= 1, ratios
    nan = float("nan")
    k_bad, v_bad = (padded(torch.where(mask[..., None], x, nan), nan)
                    for x in (k, v))
    args = (padded(q, nan), k_bad, v_bad, mask, padded(lse, nan),
            padded(dr, nan), padded(dout, nan))
    got = (fa.full_attention_dq_cuda(*args, n_head=h),
           *fa.full_attention_dkv_cuda(*args, n_head=h))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("tq,tk,d", [(512, 512, 64), (96, 80, 128),
                                     (40, 33, 256), (9, 64, 32)])
def test_full_backward_bf16_is_deterministic(cuda, tq, tk, d):
    """Two launches of K8 and of K9 on the same streams are equal bit for
    bit: each owns its rows (no atomics, no second pass)."""
    case = full_backward_case(cuda, 7, 4, tq, tk, 4, d, torch.bfloat16)
    q, k, v, mask, dout, out, lse = case
    args = (q, k, v, mask, lse, ba.band_rowsum(dout, out, 4), dout)
    first = (fa.full_attention_dq_cuda(*args, n_head=4),
             *fa.full_attention_dkv_cuda(*args, n_head=4))
    second = (fa.full_attention_dq_cuda(*args, n_head=4),
              *fa.full_attention_dkv_cuda(*args, n_head=4))
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_full_backward_bf16_keeps_fp32_scale_at_large_scores(cuda):
    """Scores near 30 at d = 128, as ``test_full_bf16_keeps_fp32_scale_at_
    large_scores`` has them for K7 (key j one-hot 320 at channel j % 128,
    query channels in [1, 1.125)): rounding q * scale to bf16 would move a
    score by up to 0.06, P and the gradients with it; K8 and K9 scale the
    fp32 dot and agree with the plain version."""
    b, tq, tk, h, d = 4, 96, 96, 4, 128
    rng = np.random.default_rng(30)
    q = 1 + rng.random((b, tq, h * d)) / 8
    k = np.zeros((b, tk, h, d))
    k[:, np.arange(tk), :, np.arange(tk) % d] = 320.0
    v = rng.standard_normal((b, tk, h * d))
    dout = rng.standard_normal((b, tq, h * d))
    mask = np.ones((b, tk), bool)
    mask[1, 50:] = False
    q, k, v, dout = (torch.from_numpy(x.astype(np.float32)).reshape(
        b, -1, h * d).to(cuda, torch.bfloat16) for x in (q, k, v, dout))
    mask = torch.from_numpy(mask).to(cuda)
    out, lse = fa.full_attention_cuda(q, k, v, mask, n_head=h, with_lse=True)
    ratios, _ = full_backward_errs(q, k, v, mask, dout, out, lse, h)
    assert max(ratios) <= 1, ratios


def test_full_backward_bf16_invalid_key_blocks_write_zeros(cuda):
    """A K9 block whose 64 owner keys are all invalid (keys 64-127 of item
    0, and every key of item 1) writes zeros and stops: its dK and dV are
    exactly 0 though the memory the wrapper allocates held NaN just before;
    the other gradients agree with the plain version."""
    b, tq, tk, h, d = 2, 70, 200, 2, 64
    assert fa.backward_instance(cuda.index or 0, tk, d,
                                torch.bfloat16)["rows"] == 64
    q, k, v, mask = streams(3, b, tq, tk, h * d, [tk, 0], cuda)
    mask[0, 64:128] = False
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(
        3)).to(cuda)
    q, k, v, dout = to_bf16(q, k, v, dout)
    out, lse = fa.full_attention_cuda(q, k, v, mask, n_head=h, with_lse=True)
    junk = [torch.full_like(k, float("nan")) for _ in range(2)]
    del junk   # two blocks of dK's size, freed full of NaN
    ratios, (dq, dk, dv) = full_backward_errs(q, k, v, mask, dout, out, lse,
                                              h)
    assert max(ratios) <= 1, ratios
    assert (dk[~mask] == 0).all() and (dv[~mask] == 0).all()
    assert (dq[1] == 0).all()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_full_backward_bf16_walks_past_the_mask_window(cuda, d):
    """K8's tensor-core blocks hold the valid-key bits of 4096 keys and move
    the window on past them, as ``test_full_bf16_walks_past_the_mask_window``
    has it for K7: a run of invalid keys across key 4096 (item 1) and an
    item whose first window holds no valid key (item 2). At d = 256 dQ is
    summed in two passes over the keys, the second starting again at the
    block's first tile with a valid key, in the window that holds it. NaN in
    k and v at every invalid key: the gradients equal the clean streams' bit
    for bit, and those agree with the plain version."""
    b, tq, tk, h = 3, 70, 4500, 2
    q, k, v, mask = streams(45, b, tq, tk, h * d, [tk] * b, cuda)
    mask[1, 4000:4200] = False
    mask[2, :4100] = False
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(
        45)).to(cuda)
    q, k, v, dout = to_bf16(q, k, v, dout)
    k, v = (torch.where(mask[..., None], x, 0) for x in (k, v))
    out, lse = fa.full_attention_cuda(q, k, v, mask, n_head=h, with_lse=True)
    ratios, want = full_backward_errs(q, k, v, mask, dout, out, lse, h)
    assert max(ratios) <= 1, ratios
    assert (want[1][~mask] == 0).all() and (want[2][~mask] == 0).all()
    nan = float("nan")
    k_bad, v_bad = (torch.where(mask[..., None], x, nan) for x in (k, v))
    args = (q, k_bad, v_bad, mask, lse, ba.band_rowsum(dout, out, h), dout)
    got = (fa.full_attention_dq_cuda(*args, n_head=h),
           *fa.full_attention_dkv_cuda(*args, n_head=h))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_flash_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One train step of a small MaskVRD with drop path on and
    ``FLASH_TRAIN``: on the card every full attention runs K7 with its lse,
    K8 and K9 (the predictor's at Tq = 9), none the dense form; the losses
    and first gradients agree with the CPU's opt-in step (the plain
    versions) as ``test_train_step_on_card_matches_cpu`` holds the dense
    step."""
    from vrdone_tpu_torch.train.loop import (create_train_state,
                                             step_generator, train_step)
    monkeypatch.setattr(mops, "FLASH_TRAIN", True)
    cfg, tc, batch = small_train_case()
    states, losses = {}, {}
    for name in ("launches", "lse_launches", "dq_launches", "dkv_launches",
                 "dense_calls"):
        setattr(fa, name, 0)
    for dev in (torch.device("cpu"), cuda):
        state, _ = create_train_state(
            cfg, tc, 1, device=dev, generator=torch.Generator().manual_seed(0))
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _, losses[dev.type] = train_step(state, tb, step_generator(0, 0))
        states[dev.type] = state
    torch.cuda.synchronize()
    full = 4 * cfg.backbone_arch[1] + 2 * cfg.predictor.num_layers
    assert (fa.launches, fa.lse_launches, fa.dq_launches, fa.dkv_launches,
            fa.dense_calls) == (full, full, full, full, 0)
    for k, v in losses["cpu"].items():
        assert abs(losses["cuda"][k].item() - v.item()) <= 1e-4 * (
            1 + abs(v.item())), k
    for m, r in zip(states["cuda"].optimizer.moments["mu"],
                    states["cpu"].optimizer.moments["mu"]):
        assert max_err(m.cpu(), r) <= 1e-3 * r.abs().max().item() + 1e-7
