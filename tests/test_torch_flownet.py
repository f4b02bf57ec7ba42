"""The flow machinery of the FGFA and DFF detectors in the port
(``vrdone_tpu_torch/ops/warp.py``, ``models/flownet.py``) against the JAX
package on the CPU: the warp at the borders and with flows that push samples
past every edge, ``avg_pool_ceil`` at odd sizes, a transposed convolution and
FlowNetS (with and without the DFF scale map) from converted JAX weights at
odd input sizes, EmbedNet, ``cosine_weights``, FGFA's two aggregations and
DFF's propagation.

Parameters are drawn from the flax modules' ``eval_shape`` shapes
(``tests/test_torch_detector.py::randomize``: every kernel asymmetric) and
cross with ``convert.params_from_jax``; activations cross NHWC -> NCHW.
Tolerances: the warp 1e-6 absolute (the same four gathers and lerps in fp32;
bf16 features 1e-2 of max |ref|, each framework rounding its bf16 lerp in
its own places), ``avg_pool_ceil`` 1e-6, the convolutional nets 1e-4 of max
|ref| (a dozen chained convolutions summed in other orders), the aggregates
and the propagation 1e-4 of max |ref|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from tests.test_torch_detector import randomize
from tools.export_params_npz import flatten_params
from vrdone_tpu.models import flownet as jf
from vrdone_tpu.ops import warp as jw
from vrdone_tpu_torch.convert import params_from_jax, params_to_jax
from vrdone_tpu_torch.models import flownet as tf
from vrdone_tpu_torch.ops import warp as tw

torch.set_num_threads(1)

# the port's modules are built without storage and take the converted
# arrays as their parameters (drawing FlowNetS's 38M weights on one CPU
# thread takes seconds)
META = torch.device("meta")
NET_TOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.float().permute(0, 2, 3, 1).numpy()


def close(ours, theirs, tol):
    theirs = np.asarray(theirs, np.float32)
    scale = np.abs(theirs).max()
    assert scale > 0
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol * scale)


def load(module, params):
    module.load_state_dict(params_from_jax(flatten_params(params)),
                           strict=True, assign=True)
    return module


# -- the warp -----------------------------------------------------------------

def border_flows(rng, n, h, w):
    """(n, h, w, 2) flows: random, then rows and columns pushed past each
    edge by up to three times the map, and samples exactly on the edges."""
    flow = rng.uniform(-3, 3, (n, h, w, 2)).astype(np.float32)
    flow[0, 0, :, 0] = -3 * w            # past the left edge
    flow[0, -1, :, 0] = 3 * w            # past the right
    flow[0, :, 0, 1] = -3 * h            # past the top
    flow[0, :, -1, 1] = 2.5 * h          # past the bottom
    flow[-1, 1, 1] = (-1.0, -1.0)        # onto pixel (0, 0)
    flow[-1, 2, 3] = (w - 4.0, h - 3.0)  # onto the far corner
    flow[-1, 3, 2] = (0.5, -0.25)        # between pixels
    return flow


@pytest.mark.parametrize("h,w", [(5, 7), (6, 4), (4, 9)])
def test_warp_features_matches_jax(h, w):
    rng = np.random.default_rng(h * w)
    feats = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    flow = border_flows(rng, 2, h, w)
    # eager: XLA's fused program contracts the lerps into FMAs
    want = np.asarray(jw.warp_features(jnp.asarray(feats), jnp.asarray(flow)))
    got = tw.warp_features(nchw(feats), nchw(flow))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_bilinear_matches_jax(align_corners):
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    grid = rng.uniform(-1.6, 1.6, (2, 3, 8, 2)).astype(np.float32)
    grid[0, 0, :4] = [[-1, -1], [1, 1], [-1, 1], [1, -1]]
    want = jw.grid_sample_bilinear(jnp.asarray(feats), jnp.asarray(grid),
                                   align_corners=align_corners)
    got = tw.grid_sample_bilinear(nchw(feats), t(grid),
                                  align_corners=align_corners)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-6)
    # torch's own grid_sample computes the same function
    lib = torch.nn.functional.grid_sample(
        nchw(feats), t(grid), mode="bilinear", padding_mode="border",
        align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=0, atol=1e-5)


def test_warp_bf16_features_keep_their_dtype():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 5, 7, 8)).astype(np.float32)
    flow = border_flows(rng, 2, 5, 7)
    want = jax.jit(jw.warp_features)(jnp.asarray(feats, jnp.bfloat16),
                                     jnp.asarray(flow, jnp.bfloat16))
    got = tw.warp_features(nchw(feats).bfloat16(), nchw(flow).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(nhwc(got), np.asarray(want, np.float32), 1e-2)


# -- the layers -----------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(5, 7), (4, 6), (1, 3), (9, 2)])
def test_avg_pool_ceil_matches_jax(h, w):
    x = np.random.default_rng(h + w).standard_normal((2, h, w, 3)).astype(
        np.float32)
    want = np.asarray(jf.avg_pool_ceil(jnp.asarray(x)))
    got = nhwc(tf.avg_pool_ceil(nchw(x)))
    assert got.shape == want.shape == (2, -(-h // 2), -(-w // 2), 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the bottom-right partial window averages over what is present
    np.testing.assert_allclose(got[:, -1, -1], x[:, (h - 1) // 2 * 2:,
                                                  (w - 1) // 2 * 2:].mean(
        (1, 2)), rtol=1e-6)


@pytest.mark.parametrize("h,w", [(3, 5), (4, 4)])
def test_transposed_conv_crosses_without_a_flip(h, w):
    """A flax ConvTranspose(4x4, stride 2, VALID, transpose_kernel=True)
    with an asymmetric kernel, at odd and even input sizes, equals the
    port's ConvTranspose2d loaded by convert.py; the spatially flipped
    kernel would not."""
    layer = fnn.ConvTranspose(3, (4, 4), strides=(2, 2), padding="VALID",
                              transpose_kernel=True)
    x = np.random.default_rng(h).standard_normal((2, h, w, 5)).astype(
        np.float32)
    shapes = jax.eval_shape(lambda k: layer.init(k, jnp.asarray(x)),
                            jax.random.key(0))
    params = randomize(shapes["params"], 1)
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    conv = load(torch.nn.ConvTranspose2d(5, 3, 4, stride=2, device=META),
                params)
    with torch.no_grad():
        got = nhwc(conv(nchw(x)))
        assert got.shape == want.shape == (2, 2 * h + 2, 2 * w + 2, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        conv.weight.copy_(conv.weight.flip(2, 3))
        assert np.abs(nhwc(conv(nchw(x))) - want).max() > 1e-2


@pytest.fixture(scope="module")
def flownets():
    """JAX's FlowNetS with and without the scale map, drawn parameters,
    the port's loaded from them, and the jitted JAX applies."""
    x = jnp.zeros((1, 64, 96, 6))
    out = {}
    for scale in (False, True):
        net = jf.FlowNetS(dff_scale=scale)
        shapes = jax.eval_shape(lambda k: net.init(k, x), jax.random.key(0))
        params = randomize(shapes["params"], 2 + scale)
        ours = load(tf.FlowNetS(dff_scale=scale, device=META), params)
        out[scale] = (jax.jit(lambda p, i, net=net: net.apply(
            {"params": p}, i)), params, ours)
    return out


@pytest.mark.parametrize("h,w", [(64, 96), (72, 100)])
@pytest.mark.parametrize("scale", [False, True])
def test_flownet_matches_jax(flownets, scale, h, w):
    apply, params, ours = flownets[scale]
    pair = np.random.default_rng(h + scale).uniform(
        0, 1, (2, h, w, 6)).astype(np.float32)
    want = apply(params, jnp.asarray(pair))
    with torch.no_grad():
        got = ours(nchw(pair))
    if not scale:
        want, got = (want,), (got,)
    assert len(got) == len(want) == 1 + scale
    for g, wnt in zip(got, want):
        assert nhwc(g).shape == wnt.shape
        close(nhwc(g), wnt, NET_TOL)


def test_flownet_params_round_trip(flownets):
    """Every FlowNetS leaf (the eight transposed convolutions, the bias-free
    scale convolution) crosses and comes back bit for bit."""
    _, params, ours = flownets[True]
    flat = flatten_params(params)
    assert "Convolution5_scale/kernel" in flat and \
        "Convolution5_scale/bias" not in flat
    mine = params_to_jax(ours.state_dict())
    assert sorted(mine) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


# -- aggregation ----------------------------------------------------------------

H, W, R = 64, 96, 3


@pytest.fixture(scope="module")
def aggregators():
    """JAX's FGFA and DFF modules with drawn parameters, the port's loaded
    from them, and frames, C4-sized features and embeddings."""
    rng = np.random.default_rng(5)
    imgs = rng.uniform(0, 255, (R + 1, H, W, 3)).astype(np.float32)
    feats = rng.standard_normal((R + 1, H // 16, W // 16, 1024)).astype(
        np.float32)
    out = {"imgs": imgs, "feats": feats}
    fgfa, dff = jf.FGFA(), jf.DFF()
    shapes = jax.eval_shape(lambda k: fgfa.init(
        k, jnp.asarray(imgs[:1]), jnp.asarray(imgs[1:]),
        jnp.asarray(feats[:1]), jnp.asarray(feats[1:])), jax.random.key(0))
    out["fgfa"] = (fgfa, randomize(shapes["params"], 6))
    shapes = jax.eval_shape(lambda k: dff.init(
        k, jnp.asarray(imgs[:1]), jnp.asarray(imgs[1:2]),
        jnp.asarray(feats[:1])), jax.random.key(0))
    out["dff"] = (dff, randomize(shapes["params"], 7))
    out["ours_fgfa"] = load(tf.FGFA(device=META), out["fgfa"][1])
    out["ours_dff"] = load(tf.DFF(device=META), out["dff"][1])
    return out


def test_embednet_and_cosine_weights_match_jax(aggregators):
    module, params = aggregators["fgfa"]
    feats = aggregators["feats"]
    want = jax.jit(lambda p, f: module.apply(
        {"params": p}, f, method=lambda m, x: m.embednet(x)))(
        params, jnp.asarray(feats))
    with torch.no_grad():
        got = aggregators["ours_fgfa"].embednet(nchw(feats))
    close(nhwc(got), want, NET_TOL)
    w_want = jf.cosine_weights(want[1:], want[:1])
    w_got = tf.cosine_weights(got[1:], got[:1])
    assert w_got.shape == (R, 1, H // 16, W // 16)
    np.testing.assert_allclose(nhwc(w_got), np.asarray(w_want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(w_got.sum(0).numpy(), 1.0, rtol=1e-6)
    # bf16 embeddings: fp32 inside, the weights back in bf16
    w16 = tf.cosine_weights(got[1:].bfloat16(), got[:1].bfloat16())
    assert w16.dtype == torch.bfloat16
    close(nhwc(w16), np.asarray(jf.cosine_weights(
        want[1:].astype(jnp.bfloat16), want[:1].astype(jnp.bfloat16)),
        np.float32), 1e-2)


def test_fgfa_aggregate_train_matches_jax(aggregators):
    module, params = aggregators["fgfa"]
    imgs, feats = aggregators["imgs"], aggregators["feats"]
    want = jax.jit(lambda p, *a: module.apply(
        {"params": p}, *a, method=jf.FGFA.aggregate_train))(
        params, jnp.asarray(imgs[:1]), jnp.asarray(imgs[1:]),
        jnp.asarray(feats[:1]), jnp.asarray(feats[1:]))
    with torch.no_grad():
        got = aggregators["ours_fgfa"].aggregate_train(
            t(imgs[:1]), t(imgs[1:]), nchw(feats[:1]), nchw(feats[1:]))
    assert got.shape == (1, 1024, H // 16, W // 16)
    close(nhwc(got), want, NET_TOL)


@pytest.mark.parametrize("key_loc", [0, 2])
def test_fgfa_aggregate_test_matches_jax(aggregators, key_loc):
    module, params = aggregators["fgfa"]
    imgs, feats = aggregators["imgs"], aggregators["feats"]

    def fwd(m, cur, win, f, k):
        return m.aggregate_test(cur, win, m.precompute_frame(f), k)

    want = jax.jit(lambda p, *a: module.apply({"params": p}, *a[:3],
                                              key_loc, method=fwd))(
        params, jnp.asarray(imgs[key_loc:key_loc + 1]), jnp.asarray(imgs),
        jnp.asarray(feats))
    ours = aggregators["ours_fgfa"]
    with torch.no_grad():
        fe = ours.precompute_frame(nchw(feats))
        assert fe.shape == (R + 1, 3072, H // 16, W // 16)
        got = ours.aggregate_test(t(imgs[key_loc:key_loc + 1]), t(imgs), fe,
                                  key_loc)
    close(nhwc(got), want, NET_TOL)


def test_dff_propagate_matches_jax(aggregators):
    module, params = aggregators["dff"]
    imgs, feats = aggregators["imgs"], aggregators["feats"]
    want = jax.jit(lambda p, *a: module.apply(
        {"params": p}, *a, method=jf.DFF.propagate))(
        params, jnp.asarray(imgs[1:2]), jnp.asarray(imgs[:1]),
        jnp.asarray(feats[:1]))
    with torch.no_grad():
        got = aggregators["ours_dff"].propagate(t(imgs[1:2]), t(imgs[:1]),
                                                nchw(feats[:1]))
    close(nhwc(got), want, NET_TOL)
