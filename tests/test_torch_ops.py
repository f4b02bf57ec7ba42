"""The port's masked ops and plain attention against the JAX package:
``vrdone_tpu.ops.masked`` and, for band attention, the Pallas TPU kernel in
interpret mode. Inputs come from numpy with a fixed seed.

Tolerance 1e-5 (fp32): the two frameworks sum dot products and reductions
in different orders, which moves the last bits; nothing else may differ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrdone_tpu.ops import masked as jops
from vrdone_tpu.ops.pallas.band_attention import band_attention_pallas
from vrdone_tpu_torch.ops import band_attention as tband
from vrdone_tpu_torch.ops import full_attention as tfull
from vrdone_tpu_torch.ops import masked as tops

torch.set_num_threads(1)

TOL = 1e-5


def close(ours, theirs, tol=TOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs),
                               atol=tol, rtol=tol)


def lengths_mask(t, lens):
    return np.arange(t)[None] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("k,stride,groups", [(3, 1, 1), (3, 2, 1),
                                             (3, 2, 16), (1, 1, 1),
                                             (5, 2, 8)])
def test_masked_conv1d(k, stride, groups):
    rng = np.random.default_rng(0)
    b, t, c_in, c_out = 3, 21, 16, 24 if groups == 1 else 16
    x = rng.standard_normal((b, t, c_in)).astype(np.float32)
    w = rng.standard_normal((k, c_in // groups, c_out)).astype(np.float32)
    bias = rng.standard_normal(c_out).astype(np.float32)
    mask = lengths_mask(t, [t, 13, 4])
    jo, jm = jops.masked_conv1d(jnp.asarray(x), jnp.asarray(mask),
                                jnp.asarray(w), jnp.asarray(bias),
                                stride=stride, groups=groups)
    to, tm = tops.masked_conv1d(
        torch.from_numpy(x), torch.from_numpy(mask),
        torch.from_numpy(w.transpose(2, 1, 0).copy()),
        torch.from_numpy(bias), stride=stride, groups=groups)
    close(to, jo)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tm.is_contiguous()


def test_max_pool_layernorm_and_heads():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 19, 12)).astype(np.float32)
    w = rng.standard_normal(12).astype(np.float32)
    bias = rng.standard_normal(12).astype(np.float32)
    xt = torch.from_numpy(x)
    close(tops.max_pool1d(xt, kernel=3, stride=2, padding=1),
          jops.max_pool1d(jnp.asarray(x), kernel=3, stride=2, padding=1))
    close(tops.channel_layernorm(xt, torch.from_numpy(w),
                                 torch.from_numpy(bias)),
          jops.channel_layernorm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(bias)))
    close(tops.channel_layernorm(xt, None, None),
          jops.channel_layernorm(jnp.asarray(x), None, None))
    heads = tops.split_heads(xt, 4)
    close(heads, jops._split_heads(jnp.asarray(x), 4), tol=0)
    close(tops.merge_heads(heads), x, tol=0)


def test_position_encodings():
    np.testing.assert_array_equal(tops.sinusoid_encoding(50, 16),
                                  jops.sinusoid_encoding(50, 16))
    pe = jops.sinusoid_encoding(48, 16)
    for new_len in (48, 96, 130):
        close(tops.resize_pe_linear(torch.from_numpy(pe), new_len),
              jops.resize_pe_linear(jnp.asarray(pe), new_len))


def _qkv(rng, b, tq, tk, c):
    return (rng.standard_normal((b, tq, c)).astype(np.float32),
            rng.standard_normal((b, tk, c)).astype(np.float32),
            rng.standard_normal((b, tk, c)).astype(np.float32))


@pytest.mark.parametrize("t", [12, 96, 128, 300])
@pytest.mark.parametrize("w", [3, 4, 9])
def test_band_attention_plain_matches_jax(t, w):
    """Against the dense oracle and the Pallas kernel (interpret mode), with
    partial key masks, T below and above the Pallas block."""
    rng = np.random.default_rng(t * 10 + w)
    b, h, d = 2, 2, 8
    q, k, v = _qkv(rng, b, t, t, h * d)
    mask = lengths_mask(t, [t, max(2, t // 3)])
    mask[0, t // 2] = False  # an invalid key inside a valid stretch
    args = [jnp.asarray(a) for a in (q, k, v, mask)]
    ours = tband.band_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), n_head=h,
        window_size=2 * w + 1)
    close(ours, jops.band_attention(*args, n_head=h, window_size=2 * w + 1))
    close(ours, band_attention_pallas(*args, n_head=h,
                                      window_size=2 * w + 1, block=128,
                                      interpret=True))


@pytest.mark.parametrize("tq,tk,d", [(20, 20, 8), (5, 7, 16), (9, 12, 8),
                                     (33, 40, 32)])
def test_full_attention_plain_matches_jax(tq, tk, d):
    rng = np.random.default_rng(tq + tk)
    b, h = 3, 2
    q, k, v = _qkv(rng, b, tq, tk, h * d)
    mask = lengths_mask(tk, [tk, tk // 2, 1])
    ours = tfull.full_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), n_head=h)
    close(ours, jops.full_attention(*(jnp.asarray(a) for a in (q, k, v, mask)),
                                    n_head=h))


def test_full_attention_row_without_keys_is_zero():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 4, 6, 8)
    mask = lengths_mask(6, [6, 0])
    out = tfull.full_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), n_head=2)
    assert torch.isfinite(out).all()
    assert (out[1] == 0).all()


# (Tq, d, rows a block, head-dim bucket) of the K7 instances on the main
# paths: 48 query rows a block at the eval forward's 96, 64 at the larger
# buckets and VidOR's 512, 16 for the predictor's 9 queries
FULL_VARIANTS = [
    (96, 128, 48, 128), (192, 128, 64, 128), (384, 128, 64, 128),
    (768, 128, 64, 128), (96, 64, 48, 64), (512, 64, 64, 64),
    (9, 32, 16, 32), (9, 128, 16, 128), (16, 40, 16, 64), (17, 30, 48, 32),
    (1, 256, 16, 256), (65, 8, 48, 32), (97, 100, 64, 128)]
# the bf16 forward's shapes (VidVRD's S/O cross-attention, eval buckets and
# predictor, VidOR's S/O and predictor at d = 32) and each rule's edges:
# above Tq = 64 two 16-row tiles a warp, 96 or 128 rows a block, whichever
# pads fewer (128 on a tie); the fp32 rows up to 64 and at the 256 bucket
FULL_BF16_VARIANTS = [
    (96, 128, 96, 128), (192, 128, 96, 128), (384, 128, 128, 128),
    (768, 128, 128, 128), (9, 64, 16, 64), (512, 64, 128, 64),
    (9, 32, 16, 32), (17, 30, 48, 32), (64, 128, 64, 128),
    (65, 64, 96, 64), (97, 100, 128, 128), (97, 256, 64, 256),
    (16, 65, 16, 128), (1, 8, 16, 32)]


@pytest.mark.parametrize("tq,d,dtype,want", [
    pytest.param(tq, d, torch.float32, (rows, bucket),
                 id=f"{tq}-{d}-{rows}-{bucket}")
    for tq, d, rows, bucket in FULL_VARIANTS] + [
    pytest.param(tq, d, torch.bfloat16, (rows, bucket),
                 id=f"bf16-{tq}-{d}-{rows}-{bucket}")
    for tq, d, rows, bucket in FULL_BF16_VARIANTS])
def test_full_kernel_variant(tq, d, dtype, want):
    """The K7 instance (rows a block, head-dim bucket) for the main paths'
    (Tq, d) in each dtype; fp32's is the default."""
    assert tfull._variant(tq, d, dtype) == want
    if dtype == torch.float32:
        assert tfull._variant(tq, d) == want


@pytest.mark.parametrize("d", [0, 257, 512])
def test_full_kernel_variant_refuses_head_dims_it_does_not_take(d):
    with pytest.raises(ValueError, match="head dim"):
        tfull._variant(96, d)


def test_dispatch_takes_plain_on_cpu_and_kernel_refuses_cpu():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 10, 10, 16))
    mask = torch.from_numpy(lengths_mask(10, [10, 6]))
    band0, full0 = tband.launches, tfull.launches
    torch.testing.assert_close(
        tops.band_attention(q, k, v, mask, n_head=2, window_size=7),
        tband.band_attention_plain(q, k, v, mask, n_head=2, window_size=7),
        rtol=0, atol=0)
    torch.testing.assert_close(
        tops.full_attention(q, k, v, mask, n_head=2),
        tfull.full_attention_plain(q, k, v, mask, n_head=2), rtol=0, atol=0)
    assert (tband.launches, tfull.launches) == (band0, full0)
    # the kernels check their inputs before building or launching anything
    with pytest.raises(ValueError, match="CUDA device"):
        tband.band_attention_cuda(q, k, v, mask, n_head=2, window_size=7)
    with pytest.raises(ValueError, match="CUDA device"):
        tfull.full_attention_cuda(q, k, v, mask, n_head=2)
