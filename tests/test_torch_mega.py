"""The port's MEGA head, its position bias and fused set-attention (plain
versions), and the streaming driver against ``vrdone_tpu.models.mega`` and
the Pallas kernels (run in interpret mode on the CPU) on the same inputs and
converted parameters.

Tolerances (fp32): the bias in gate space rtol 2e-5, atol 1e-5 (as
``tests/test_position_bias.py``: the log amplifies rounding near the relu's
zero), and in log space only where it is above -10; pe_setup's factors 1e-4
(sines of angles up to several hundred radians, where XLA's CPU sine is good
to about 3e-5 only); one attention call 2e-4
(the Pallas kernel's online softmax against one dense softmax); the head and
the stream 2e-4 of the output's largest magnitude (several chained
projections, softmaxes and fcs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tools.export_params_npz import flatten_params
from vrdone_tpu.models import mega as jm
from vrdone_tpu.ops.pallas import mega_attention as jma
from vrdone_tpu.ops.pallas import position_bias as jpb
from vrdone_tpu_torch.convert import load_params
from vrdone_tpu_torch.models import mega as tm
from vrdone_tpu_torch.ops import mega_attention as tma
from vrdone_tpu_torch.ops import position_bias as tpb

torch.set_num_threads(1)

CPU = torch.device("cpu")


def rand_rois(rng, n, hw=(480.0, 854.0)):
    cx = rng.uniform(0, hw[1], (n,))
    cy = rng.uniform(0, hw[0], (n,))
    w = rng.uniform(4, 300, (n,))
    h = rng.uniform(4, 300, (n,))
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                    axis=1).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def randomize(shapes, seed):
    """Every leaf from numpy: kernels with variance 1/fan_in, biases and the
    content-free queries u small."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name, shape = path[-1].key, x.shape
        if name == "kernel":
            fan_in = np.prod(shape[:-1]) if len(shape) == 2 else shape[1]
            bound = np.sqrt(3.0 / fan_in)
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("g,n,m", [(1, 13, 29), (5, 7, 130), (16, 13, 29),
                                   (32, 40, 3)])
def test_pe_setup_matches_jax(g, n, m):
    """The bias kernels' operands as ``bias_operands`` hands them over on
    the CPU (contiguous A (g, N, 32), B_t (32, M), wt (g, 32) and the fp32
    rates: the layout the ``bias_factors`` kernel writes on the card)
    against JAX's pe_setup, at the one embedding width both packages take
    (the JAX package hard-codes the 64-dim slice bounds W[32:40] ..
    W[56:64]). Wg comes transposed, as the head passes ``l_Wg.weight.T``."""
    embed_dim = 64
    rng = np.random.default_rng(g * n * m)
    q, k = rand_rois(rng, n), rand_rois(rng, m)
    w = rng.normal(0, 0.1, (g, 64)).astype(np.float32)
    b = rng.normal(0, 0.1, (g,)).astype(np.float32)
    jf, ja, jb, jw = jpb.pe_setup(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(w.T), embed_dim, 1000.0)
    tq, tk, ta, tb, tw, tbias, tf = tpb.bias_operands(
        t(q), t(k), t(w).T, t(b), embed_dim, 1000.0)
    assert tuple(tf) == jf
    assert (ta.shape, tb.shape, tw.shape) == ((g, n, 32), (32, m), (g, 32))
    for x in (tq, tk, ta, tb, tw, tbias):
        assert x.is_contiguous() and x.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), q)
    np.testing.assert_array_equal(tbias.numpy(), b)
    for ours, theirs in ((ta, ja), (tb, jb), (tw, jw)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=0, atol=1e-4)


def test_position_bias_plain_matches_pallas():
    rng = np.random.default_rng(1)
    n, m, g = 37, 101, 16
    q, k = rand_rois(rng, n), rand_rois(rng, m)
    q[-3:] = 0.0   # degenerate (padding) boxes stay finite
    w = rng.normal(0, 0.01, (64, g)).astype(np.float32)
    b = rng.normal(0, 0.01, (g,)).astype(np.float32)
    want = np.asarray(jpb.fused_position_bias(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(w), jnp.asarray(b),
        block_n=16, block_m=32, interpret=True))
    got = tpb.fused_position_bias(t(q), t(k), t(w), t(b)).numpy()
    assert got.shape == (g, n, m) and np.isfinite(got).all()
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=2e-5,
                               atol=1e-5)
    sel = want > -10
    np.testing.assert_allclose(got[sel], want[sel], rtol=1e-3, atol=3e-2)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("n,m", [(24, 40), (37, 130)])
def test_attention_plain_matches_pallas(with_bias, n, m):
    """Ragged N and M (off the Pallas kernel's 16 x 32 blocks)."""
    rng = np.random.default_rng(n * m)
    g, dg = 4, 16
    q, k, vp = (rng.standard_normal(s).astype(np.float32)
                for s in ((g, n, dg), (g, m, dg), (g, m, dg)))
    ub = rng.standard_normal((g, m)).astype(np.float32)
    valid = rng.uniform(size=m) > 0.3
    extra = ()
    if with_bias:
        # Wg as initialised (normal(0.01)) with a positive bias: the gate
        # stays off the relu's zero, where the log would magnify the two
        # bias forms' rounding (their own test compares in gate space)
        extra = (rand_rois(rng, n), rand_rois(rng, m),
                 (rng.standard_normal((64, g)) * 0.01).astype(np.float32),
                 np.full((g,), 0.1, np.float32))
    want = jma.fused_mega_attention(
        *(jnp.asarray(a) for a in (q, k, vp, ub, valid) + extra),
        block_n=16, block_m=32, interpret=True)
    got = tma.fused_mega_attention(*(t(a) for a in (q, k, vp, ub, valid)
                                     + extra))
    assert got.shape == (n, g * dg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_attention_all_invalid_is_exact_zero():
    rng = np.random.default_rng(2)
    g, n, m, dg = 2, 8, 24, 8
    q, k, vp = (t(rng.standard_normal(s).astype(np.float32))
                for s in ((g, n, dg), (g, m, dg), (g, m, dg)))
    args = (q, k, vp, torch.zeros(g, m), torch.zeros(m, dtype=torch.bool))
    rois = (t(rand_rois(rng, n)), t(rand_rois(rng, m)),
            torch.full((64, g), 0.1), torch.zeros(g))
    for extra in ((), rois):
        out = tma.fused_mega_attention(*args, *extra)
        assert (out == 0).all()


def test_global_indices_equal():
    for seg_len, size, seed in ((8, 2, 0), (16, 10, 3), (5, 5, 1), (1, 1, 0)):
        np.testing.assert_array_equal(
            tm.global_indices(seg_len, size, seed=seed),
            jm.global_indices(seg_len, size, seed=seed))


def test_grouped_linear_orders_match_jax():
    """Both association orders of GroupedLinear against flax's."""
    rng = np.random.default_rng(4)
    g, n, m, d = 4, 6, 9, 32
    mod = jm.GroupedLinear(d, g)
    att = rng.uniform(size=(g, n, m)).astype(np.float32)
    vals = rng.standard_normal((m, d)).astype(np.float32)
    shapes = jax.eval_shape(lambda r: mod.init(r, att=att, values=vals),
                            jax.random.key(0))["params"]
    params = randomize(shapes, 4)
    ours = torch.nn.Module()
    ours.l_Wv0 = tm.GroupedLinear(d, g, device=CPU)
    load_params(ours, flatten_params({"l_Wv0": params}))
    ours = ours.l_Wv0
    per_group = np.einsum("gnm,md->gnd", att, vals)
    for want, got in (
            (mod.apply({"params": params}, att=att, values=vals),
             ours(att=t(att), values=t(vals))),
            (mod.apply({"params": params}, per_group),
             ours(t(per_group)))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# -- the head and the stream ------------------------------------------------

FD, G, IN = 64, 4, 48   # feature width, groups, pooled input width


def head_inputs(rng, nk=6, f=4, b=5, stage=3, a=3):
    key = rng.standard_normal((nk, IN)).astype(np.float32)
    key_rois = rand_rois(rng, nk)
    key_valid = np.ones(nk, bool)
    key_valid[-1] = False
    win = (rng.standard_normal((f, b, FD)).astype(np.float32),
           rand_rois(rng, f * b).reshape(f, b, 4),
           rng.uniform(size=(f, b)) > 0.2)
    mem = [(rng.standard_normal((n, FD)).astype(np.float32),
            rand_rois(rng, n), rng.uniform(size=n) > 0.3)
           for n in [2 * b] + [2 * a] * (stage - 1)]
    glob = (rng.standard_normal((7, FD)).astype(np.float32),
            rand_rois(rng, 7), np.ones(7, bool))
    return key, key_rois, key_valid, win, mem, glob


def as_sets(inputs, box_set, conv):
    key, key_rois, key_valid, win, mem, glob = inputs
    return (conv(key), conv(key_rois), conv(key_valid),
            box_set(*map(conv, win)), [box_set(*map(conv, s)) for s in mem],
            box_set(*map(conv, glob)))


@pytest.fixture(scope="module")
def head_pair():
    """A 3-stage head with memory and global stages, its flax params
    (materialised through enhance) and the port loaded from them."""
    kw = dict(feat_dim=FD, groups=G, stage=3, global_res_stage=1,
              advanced_num=3)
    inputs = head_inputs(np.random.default_rng(5))
    jargs = as_sets(inputs, jm.BoxSet, jnp.asarray)
    head = jm.MEGAHead(**kw)
    shapes = jax.eval_shape(
        lambda r: head.init(r, *jargs, method=jm.MEGAHead.enhance),
        jax.random.key(0))["params"]
    params = randomize(shapes, 5)
    ours = tm.MEGAHead(**kw, in_dim=IN, device=CPU)
    load_params(ours, flatten_params(params))
    return kw, {"params": params}, ours, inputs


@pytest.mark.parametrize("route", ["dense", "fused_pe_bias",
                                   "fused_attention"])
def test_enhance_matches_jax(head_pair, route):
    """MEGAHead.enhance with memory and global on, the same parameters
    through each route; the JAX side runs its Pallas kernels in interpret
    mode for the two fused routes."""
    kw, params, ours, inputs = head_pair
    flags = dict(fused_pe_bias=route == "fused_pe_bias",
                 fused_attention=route == "fused_attention")
    head = jm.MEGAHead(**kw, **flags)
    jargs = as_sets(inputs, jm.BoxSet, jnp.asarray)
    want, want_push = jax.jit(lambda p, *a: head.apply(
        p, *a, return_pushes=True, method=jm.MEGAHead.enhance))(params,
                                                                 *jargs)
    with torch.no_grad():
        got, got_push = ours.routed(**flags).enhance(
            *as_sets(inputs, tm.BoxSet, t), return_pushes=True)
    scale = float(np.abs(np.asarray(want)).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4 * scale)
    for a, b in zip(got_push, want_push):
        np.testing.assert_allclose(a.feat.numpy(), np.asarray(b.feat),
                                   rtol=0, atol=2e-4 * scale)
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))


def test_stream_video_matches_jax():
    """Eight frames through a window of 3 (clamped at both ends), memory
    read before the push, and the shuffled global schedule."""
    rng = np.random.default_rng(6)
    kw = dict(feat_dim=FD, groups=G, stage=2, global_res_stage=1,
              advanced_num=2)
    tt, nk, b = 8, 5, 4
    key = rng.standard_normal((tt, nk, IN)).astype(np.float32)
    key_rois = rand_rois(rng, tt * nk).reshape(tt, nk, 4)
    key_valid = rng.uniform(size=(tt, nk)) > 0.2
    ref = rng.standard_normal((tt, b, FD)).astype(np.float32)
    ref_rois = rand_rois(rng, tt * b).reshape(tt, b, 4)
    ref_valid = rng.uniform(size=(tt, b)) > 0.2
    ref_valid[0] = False   # a frame with no valid reference box
    gi = jm.global_indices(tt, 3, seed=2)
    head = jm.MEGAHead(**kw)
    win = jm.BoxSet(*(jnp.asarray(x[:2]) for x in (ref, ref_rois,
                                                   ref_valid)))
    mem = [jm.flatten_set(win)] * 2
    shapes = jax.eval_shape(lambda r: head.init(
        r, jnp.asarray(key[0]), jnp.asarray(key_rois[0]),
        jnp.asarray(key_valid[0]), win, mem, jm.flatten_set(win),
        method=jm.MEGAHead.enhance), jax.random.key(0))["params"]
    params = randomize(shapes, 6)
    ours = tm.MEGAHead(**kw, in_dim=IN, device=CPU)
    load_params(ours, flatten_params(params))
    sched = dict(mem_size=3, window=3, key_loc=1, glob_idx=gi)
    want = np.asarray(jm.stream_video(
        head, {"params": params}, key_feat=jnp.asarray(key),
        key_rois=jnp.asarray(key_rois), key_valid=jnp.asarray(key_valid),
        key_is_fc0=False, ref_feat=jnp.asarray(ref),
        ref_rois=jnp.asarray(ref_rois), ref_valid=jnp.asarray(ref_valid),
        **sched))
    with torch.no_grad():
        got = tm.stream_video(
            ours, key_feat=t(key), key_rois=t(key_rois),
            key_valid=t(key_valid), key_is_fc0=False, ref_feat=t(ref),
            ref_rois=t(ref_rois), ref_valid=t(ref_valid), **sched).numpy()
    assert got.shape == (tt, nk, FD)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * scale)
    assert np.abs(got[~key_valid]).max() == 0.0
