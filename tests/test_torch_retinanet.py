"""RetinaNet in the port (``vrdone_tpu_torch/models/retinanet.py``) against
the JAX package on the CPU, at R (1, 1, 1, 1), FPN width 16, 5 classes and
64 x 96 images (76 x 100 where the FPN's upsampled map is cropped).

The flax parameters are drawn from the shapes of ``RetinaNet.init``
(``tests/test_torch_detector.py::randomize``: kernels with variance 1 /
fan_in, so that the candidates' scores spread across ``score_thresh``) and
cross with ``convert.params_from_jax``.

Tolerances: each level's logits and deltas within ``FWD_TOL`` of its max
|ref|, in fp32 and in bf16 on fp32 parameters (where JAX rounds only the
input); on a bf16 copy of the parameters within ``MAX_TOL`` / ``MEAN_TOL``
of max |ref| (JAX's own ``_rel_close`` against fp32); the losses
``LOSS_TOL`` x (1 + |loss|), ``num_pos`` exact; each parameter's gradient
``GRAD_TOL`` x max |g_JAX|, where a ReLU at rounding distance from 0 may
move some leaves (at most ``FLIP_LEAVES``, each within ``FLIP_TOL``) and the
port's fp64 gradient must then hold them (as
``tests/test_torch_detector_methods.py`` does); ``detect_image``'s keep
order, validity and labels exact, boxes and scores ``FWD_TOL`` of max
|ref|; the anchors exact.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_detector import randomize
from tools.export_params_npz import flatten_params
from vrdone_tpu.models import retinanet as jr
from vrdone_tpu.models.detector import _cast_f32_leaves
from vrdone_tpu_torch.convert import params_from_jax, params_to_jax
from vrdone_tpu_torch.models import retinanet as tr
from vrdone_tpu_torch.utils.precision import cast_floating

torch.set_num_threads(1)

META = torch.device("meta")
H, W = 64, 96
K = 5
LAYERS, WIDTH = (1, 1, 1, 1), 16
FWD_TOL = 1e-4
LOSS_TOL = 1e-4
GRAD_TOL = 1e-4
FLIP_LEAVES, FLIP_TOL = 8, 1e-2
MAX_TOL, MEAN_TOL = 5e-2, 5e-3

_SETUP = {}


def setup():
    """JAX's RetinaNet and drawn parameters, the port's loaded from them
    (built once)."""
    if not _SETUP:
        model = jr.RetinaNet(num_classes=K, resnet_layers=LAYERS,
                             out_channels=WIDTH)
        shapes = jax.eval_shape(lambda k: model.init(
            k, jnp.zeros((1, H, W, 3), jnp.float32)), jax.random.key(0))
        params = {"params": randomize(shapes["params"], 1)}
        _SETUP.update(model=model, params=params, ours=port_model(params))
    return _SETUP["model"], _SETUP["params"], _SETUP["ours"]


def port_model(params) -> tr.RetinaNet:
    ours = tr.RetinaNet(K, LAYERS, WIDTH, device=META)
    ours.load_state_dict(params_from_jax(flatten_params(params["params"])),
                         strict=True, assign=True)
    return ours


def t(a):
    return torch.from_numpy(np.array(a))


def images(n, hw=(H, W), seed=3):
    return np.random.default_rng(seed).uniform(0, 255, (n, *hw, 3)).astype(
        np.float32)


@jax.jit
def jax_apply(params, x):
    return _SETUP["model"].apply(params, x)


@jax.jit
def jax_apply_bf16(params, x):
    return _SETUP["model"].apply(params, x, jnp.bfloat16)


def held(got, want, tol=FWD_TOL):
    """Each level's port output (a tensor) within ``tol`` of max |ref|."""
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max())


# -- the network ---------------------------------------------------------------

@pytest.mark.parametrize("hw", [(H, W), (76, 100)])
def test_forward_matches_jax(hw):
    """fp32 per level; at 76 x 100 the upsampled C5 (3 -> 6 rows) and P4
    maps are cropped to the lateral maps' odd sizes (5, 13 rows)."""
    _, params, ours = setup()
    x = images(2, hw)
    want_l, want_b = jax_apply(params, jnp.asarray(x))
    with torch.no_grad():
        got_l, got_b = ours(t(x))
    held(got_l, want_l)
    held(got_b, want_b)
    assert [tuple(g.shape[1:3]) for g in got_l] == [
        (-(-hw[0] // s), -(-hw[1] // s)) for s in tr.ANCHOR_STRIDES]


def test_bf16_on_fp32_params_rounds_only_the_input():
    """bf16 compute on fp32 parameters: flax promotes the bf16 input with
    the fp32 kernels, so both frameworks run fp32 on the rounded input."""
    _, params, ours = setup()
    x = images(1, seed=4)
    want_l, want_b = jax_apply_bf16(params, jnp.asarray(x))
    assert want_l[0].dtype == jnp.float32
    with torch.no_grad():
        got_l, got_b = ours(t(x), torch.bfloat16)
    assert got_l[0].dtype == torch.float32
    held(got_l, want_l)
    held(got_b, want_b)


def test_bf16_copy_matches_jax_bf16():
    """On a bf16 copy of the parameters the network runs bf16 throughout,
    in both frameworks."""
    _, params, ours = setup()
    x = images(1, seed=5)
    want_l, want_b = jax_apply_bf16(_cast_f32_leaves(params, jnp.bfloat16),
                                    jnp.asarray(x))
    assert want_l[0].dtype == jnp.bfloat16
    with torch.no_grad():
        got_l, got_b = cast_floating(ours)(t(x), torch.bfloat16)
    for got, want in ((got_l, want_l), (got_b, want_b)):
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16
            w = np.asarray(w, np.float32)
            gap = np.abs(g.float().numpy() - w)
            assert gap.max() <= MAX_TOL * np.abs(w).max()
            assert gap.mean() <= MEAN_TOL * np.abs(w).max()
    assert next(ours.parameters()).dtype == torch.float32


# -- losses and gradients -------------------------------------------------------

def gt_batch():
    """Two images' GT: two boxes each and a padded slot."""
    boxes = np.zeros((2, 3, 4), np.float32)
    boxes[:, :2] = [[[8, 6, 50, 44], [40, 20, 90, 60]],
                    [[4, 10, 34, 50], [30, 2, 88, 30]]]
    return (boxes, np.array([[2, 4, 0], [1, 5, 0]], np.int32),
            np.array([[True, True, False]] * 2))


def port_losses(model, x, gtb, gtl, gtv):
    lg, bb = model(x)
    anchors = t(jr.all_anchors((H, W))).to(x.dtype)
    return tr.retinanet_losses(
        anchors, tr.flatten_levels(lg, K), tr.flatten_levels(bb, 4),
        t(gtb).to(x.dtype), t(gtl), t(gtv), num_classes=K)


def gradients(model, loss) -> dict:
    names = [n for n, _ in model.named_parameters()]
    leaves = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, leaves)
    return {k: v.astype(np.float64) for k, v in params_to_jax(
        dict(zip(names, grads))).items()}


def off_leaves(got_g, want_g) -> dict:
    worst = {k: np.abs(got_g[k] - g).max() / np.abs(g).max()
             for k, g in want_g.items()}
    return {k: v for k, v in worst.items() if v > GRAD_TOL}


def test_losses_and_gradients_match_jax():
    model, params, ours = setup()
    x = images(2, seed=6)
    gtb, gtl, gtv = gt_batch()
    anchors = jnp.asarray(jr.all_anchors((H, W)))

    @jax.jit
    def run(params, x):
        def loss_fn(params):
            lg, bb = model.apply(params, x)
            out = jr.retinanet_losses(
                anchors, jr.flatten_levels(lg, K), jr.flatten_levels(bb, 4),
                jnp.asarray(gtb), jnp.asarray(gtl), jnp.asarray(gtv),
                num_classes=K)
            return out["loss_retina_cls"] + out["loss_retina_reg"], out
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, want), want_g = run(params, jnp.asarray(x))
    want_g = flatten_params(want_g["params"])
    got = port_losses(ours, t(x), gtb, gtl, gtv)
    assert int(got["num_pos"]) == int(want["num_pos"]) > 2
    for k in ("loss_retina_cls", "loss_retina_reg"):
        v = float(want[k])
        assert abs(got[k].item() - v) <= LOSS_TOL * (1 + abs(v)), (k, v)
    got_g = gradients(ours, got["loss_retina_cls"] + got["loss_retina_reg"])
    assert sorted(got_g) == sorted(want_g)
    bad = off_leaves(got_g, want_g)
    if bad:
        # a ReLU at rounding distance from 0: a bounded fp32 gap, and the
        # port's fp64 gradient holds the leaves
        assert len(bad) <= FLIP_LEAVES, bad
        assert max(bad.values()) <= FLIP_TOL, bad
        o64 = copy.deepcopy(ours).double()
        got64 = port_losses(o64, t(x).double(), gtb, gtl, gtv)
        bad = off_leaves(gradients(o64, got64["loss_retina_cls"]
                                   + got64["loss_retina_reg"]), want_g)
    assert not bad, bad


def test_losses_on_jax_case():
    """JAX's own loss case (tests/test_retinanet.py): one forced positive,
    perfect deltas give no regression loss, a wrong class a larger loss,
    and the gradient of the logits equals JAX's."""
    anchors = np.array([[0, 0, 10, 10], [20, 20, 40, 40],
                        [100, 100, 140, 140]], np.float32)
    gtb = np.array([[[0, 0, 10, 10], [0, 0, 0, 0]]], np.float32)
    gtl, gtv = np.array([[3, 0]]), np.array([[True, False]])
    from vrdone_tpu.models.rpn import encode_boxes
    perfect = np.asarray(encode_boxes(jnp.broadcast_to(gtb[0, 0], (3, 4)),
                                      jnp.asarray(anchors),
                                      weights=jr.BOX_WEIGHTS))[None]
    for cls in (2, 4):
        logits = np.full((1, 3, 5), -10.0, np.float32)
        logits[0, 0, cls] = 10.0
        want, want_g = jax.jit(jax.value_and_grad(
            lambda lg: jr.retinanet_losses(
                jnp.asarray(anchors), lg, jnp.asarray(perfect), gtb, gtl,
                gtv, num_classes=5)["loss_retina_cls"]))(jnp.asarray(logits))
        lg = t(logits).requires_grad_()
        got = tr.retinanet_losses(t(anchors), lg, t(perfect), t(gtb), t(gtl),
                                  t(gtv), num_classes=5)
        assert int(got["num_pos"]) == 1
        assert got["loss_retina_reg"].item() < 1e-6
        assert abs(got["loss_retina_cls"].item() - float(want)) <= \
            LOSS_TOL * (1 + float(want))
        (g,) = torch.autograd.grad(got["loss_retina_cls"], lg)
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-5,
                                   atol=1e-7)


# -- detection ----------------------------------------------------------------------

def tied(params):
    """The parameters with the class logits' kernel zeroed and a bias a
    class: every anchor's score of a class ties."""
    p = jax.tree.map(np.array, params)
    head = p["params"]["head"]["cls_logits"]
    head["kernel"][:] = 0.0
    head["bias"][:] = np.tile(np.linspace(-1.0, 1.0, K, dtype=np.float32),
                              head["bias"].size // K)
    return p


@pytest.mark.parametrize("case", ["fp32", "bf16_fp32_params", "ties"])
def test_detect_image_matches_jax(case):
    model, params, ours = setup()
    kw = dict(pre_nms_top_n=1000, dets_per_img=100)
    dtype = "bfloat16" if case == "bf16_fp32_params" else "float32"
    if case == "ties":
        params = tied(params)
        ours = port_model(params)
        # the per-level top-k cuts inside a run of equal scores
        kw = dict(pre_nms_top_n=50, dets_per_img=30)
    img = images(1, seed=7)[0]
    hw = np.asarray([60, 90], np.float32)
    want = jax.jit(lambda p, im: jr.detect_image(
        model, p, im, jnp.asarray(hw), compute_dtype=dtype, **kw))(
        params, jnp.asarray(img))
    got = tr.detect_image(ours, t(img), hw, compute_dtype=dtype, **kw)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert want["valid"].sum() > 10
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    for k in ("boxes", "scores"):
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=FWD_TOL * np.abs(want[k]).max())


def test_detect_image_bf16_copy():
    """On a bf16 copy: fp32 outputs of the fp32 run's shapes, finite, the
    boxes on the image, the parameters left fp32."""
    _, _, ours = setup()
    img = images(1, seed=8)[0]
    hw = np.asarray([64, 96], np.float32)
    ref = tr.detect_image(ours, t(img), hw)
    out = tr.detect_image(cast_floating(ours), t(img), hw,
                          compute_dtype="bfloat16")
    for k, v in out.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
        assert torch.isfinite(v.float()).all(), k
    boxes = out["boxes"][out["valid"]]
    assert len(boxes) and (boxes >= 0).all()
    assert (boxes[:, 2] <= 95).all() and (boxes[:, 3] <= 63).all()
    assert next(ours.parameters()).dtype == torch.float32


# -- the rest ---------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(64, 96), (76, 100), (608, 1088)])
def test_anchors_are_jax_anchors(hw):
    np.testing.assert_array_equal(tr.all_anchors(hw), jr.all_anchors(hw))
    for stride, sizes in zip(tr.ANCHOR_STRIDES, tr.octave_sizes()):
        np.testing.assert_array_equal(tr.generate_cell_anchors(stride, sizes),
                                      jr.generate_cell_anchors(stride, sizes))


def test_params_round_trip():
    """Every leaf crosses and comes back bit for bit; the flax names are
    the port's, the head's prior bias among them."""
    _, params, ours = setup()
    flat = flatten_params(params["params"])
    mine = params_to_jax(ours.state_dict())
    assert sorted(mine) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    fresh = tr.RetinaNet(K, LAYERS, WIDTH, device=torch.device("cpu"),
                         generator=torch.Generator().manual_seed(0))
    assert sorted(params_to_jax(fresh.state_dict())) == sorted(flat)
    np.testing.assert_allclose(fresh.head.cls_logits.bias.detach().numpy(),
                               -np.log(99.0), rtol=1e-6)


def test_nms_walk_stops_after_the_last_live_block():
    """``detect_image``'s class-wise NMS sees mostly -inf scores: the walk
    stops after the block of the last finite score, and keeps JAX's
    survivors (a +inf score sorts first and is dead, as in JAX)."""
    from vrdone_tpu.ops import boxes as jboxes
    from vrdone_tpu_torch.ops import boxes as tboxes
    rng = np.random.default_rng(11)
    n = 1000
    xy = rng.uniform(0, 250, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 60, (n, 2))],
                           1).astype(np.float32)
    scores = np.full(n, -np.inf, np.float32)
    live = rng.choice(n, 150, replace=False)
    scores[live] = rng.uniform(size=150)
    scores[live[:5]] = scores[live[5]]      # ties keep their input order
    scores[live[6]] = np.inf
    for max_out in (20, 200):
        ji, jv = jboxes.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.4,
                            max_out=max_out, block=64)
        ti, tv = tboxes.nms(t(boxes), t(scores), 0.4, max_out=max_out,
                            block=64)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy()[tv.numpy()],
                                      np.asarray(ji)[np.asarray(jv)])
        assert 10 < tv.sum() < 150
