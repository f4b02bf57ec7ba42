"""The base, RDN, FGFA and DFF video detectors in the port
(``vrdone_tpu_torch/models/{base_rcnn,rdn,flownet}.py``, their training
forwards in ``models/detector_train.py``) against the JAX package on the
CPU, at the size of ``tests/test_detector_train.py::_method_det_and_batch``:
R (1, 1, 1), 5 classes, 64 x 96 images; RDN with 2 base stages, 4 groups,
base_num 4 and a 3-frame window, with the advanced (distillation) stage and
without; FGFA with a 3-frame window.

The flax parameters are drawn from the shapes of JAX's
``init_method_train_params`` (``tests/test_torch_detector.py::randomize``)
and cross with ``convert.load_params``; the RDN head's and the predictors'
kernels are damped to a tenth (``damp``), as the MEGA training test damps
MEGA's: at full scale the relation softmaxes saturate and the gradient is
float noise. Each RDN ``Wg`` bias is raised by 1, so that relu(Wg . PE)
stays away from 0, where the bias log(relu(.) + 1e-6) multiplies fp32
rounding by up to 1e6: drawn about 0, both frameworks' fp32 gradients of
``Wg1`` lie about 1e-2 of its max |g| from the fp64 gradient (measured on
this test's sample: JAX 1.04e-2, the port 1.41e-2), and 2.5e-2 apart. The
samplers' priorities are JAX's own draws.

A ReLU whose fp32 pre-activation lies within rounding of 0 can take
opposite sides in two fp32 forwards that sum in other orders, and moves the
gradients downstream of it by far more than rounding: on the FGFA sample
one such site among 7.15M (measured against the port's own fp64 forward)
moved C5's conv3 gradient by 6e-4 of its max |g|, while JAX's fp32 gradient
lay within 3.2e-7 of the port's fp64 one. So where a leaf's fp32 gradient
is off JAX's, the gap is bounded (at most ``FLIP_LEAVES`` leaves off, each
within ``FLIP_TOL`` x (1 + max |g_JAX|)), and the port's gradient computed
in fp64 (a float64 copy of the detector) is held to JAX's at ``GRAD_TOL``
instead: the port's arithmetic, free of the flip, must reproduce JAX's
gradient.

Tolerances, as ``tests/test_torch_detector_train.py`` states them: whole
videos in fp32 with valid slots equal, proposals within ``PROPOSAL_TOL``
(1e-2 pixel: the RPN's deltas come out of the random backbone with about
1e-5 relative fp32 noise, and decoding cancels anchor terms of +-200 pixels
to coordinates of a few pixels, so a coordinate moved 1.4e-3 pixel on the
RDN video), logits, deltas and RDN's features 5e-4 of max |ref|
(``tests/test_torch_detector.py``'s detect_video limits); in bf16 the deterministic maps (C4, FGFA's aggregate,
DFF's propagation, RDN's fc0) within ``MAX_TOL`` / ``MEAN_TOL`` of max |ref|
of JAX's bf16 (JAX's own bf16-to-fp32 limits, 1e-1 / 1e-2 through a warp),
and the bf16 detection outputs of the right shapes, fp32 and finite, as JAX's
bf16 tests check theirs; a sample's losses ``LOSS_TOL`` x (1 + |loss|), each
parameter's gradient ``GRAD_TOL`` x (1 + max |g_JAX|); one step's
parameters atol = rtol = 1e-5.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_detector import randomize
from tests.test_torch_detector_train import port_draw
from tools.export_params_npz import flatten_params
from vrdone_tpu.models import base_rcnn as jb
from vrdone_tpu.models import detector_train as jdt
from vrdone_tpu.models import flownet as jf
from vrdone_tpu.models import rdn as jr
from vrdone_tpu.models.detector import _cast_f32_leaves
from vrdone_tpu.train import optim as jopt
from vrdone_tpu_torch.convert import params_from_jax, params_to_jax
from vrdone_tpu_torch.models import base_rcnn as tb
from vrdone_tpu_torch.models import detector_train as tdt
from vrdone_tpu_torch.models import flownet as tf
from vrdone_tpu_torch.models import rdn as tr
from vrdone_tpu_torch.train import optim as topt
from vrdone_tpu_torch.utils.precision import cast_floating

torch.set_num_threads(1)

META = torch.device("meta")
H, W = 64, 96
NK = 8            # post_nms_top_n
B = 2             # the train step's batch
T = 3             # frames of a video
LOSS_TOL = 1e-4
GRAD_TOL = 1e-4
# leaves behind a flipped ReLU: the most of them, and the largest gap
# (the FGFA sample: 2 leaves, 6.0e-4)
FLIP_LEAVES, FLIP_TOL = 8, 1e-2
MAX_TOL, MEAN_TOL = 5e-2, 5e-3
PROPOSAL_TOL = 1e-2   # pixels
RDN_KW = dict(base_stage=2, groups=4, base_num=4, window=3, key_loc=1)
# name: (method, JAX class, port class, keyword arguments)
CASES = {
    "base": ("base", jb.BaseDetector, tb.BaseDetector, {}),
    "rdn": ("rdn", jr.RDNDetector, tr.RDNDetector,
            dict(RDN_KW, advanced_stage=1)),
    "rdn_base": ("rdn", jr.RDNDetector, tr.RDNDetector,
                 dict(RDN_KW, advanced_stage=0)),
    "fgfa": ("fgfa", jf.FGFADetector, tf.FGFADetector,
             dict(window=3, key_loc=1)),
    "dff": ("dff", jf.DFFDetector, tf.DFFDetector, {}),
}
JAX_DETECT = {"base": jb.base_detect_video, "rdn": jr.rdn_detect_video,
              "fgfa": jf.fgfa_detect_video, "dff": jf.dff_detect_video}
PORT_DETECT = {"base": tb.base_detect_video, "rdn": tr.rdn_detect_video,
               "fgfa": tf.fgfa_detect_video, "dff": tf.dff_detect_video}


def t(a):
    return torch.from_numpy(np.array(a))


def close(ours, theirs, tol):
    theirs = np.asarray(theirs, np.float32)
    scale = np.abs(theirs).max()
    assert scale > 0
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol * scale)


def damp(path, x):
    """A tenth of the RDN head's kernels and of the RPN's and the box
    predictors', and 1 added to each RDN ``Wg`` bias (see the module
    docstring)."""
    keys = [p.key for p in path]
    if keys[-1] == "kernel" and (keys[0] == "rdn" or keys[-2] in (
            "cls_score", "bbox_pred", "cls_logits")):
        return x * np.float32(0.1)
    if keys[0] == "rdn" and keys[-2].startswith("Wg"):
        return x + np.float32(1.0)
    return x


def make_batch(method, seed=7):
    """Two samples: key and reference frames (uniform noise), two GT boxes
    and a padded slot."""
    rng = np.random.default_rng(seed)
    n_ref = jdt.METHOD_REF_OFFSETS[method][2]
    gt_boxes = np.zeros((B, 3, 4), np.float32)
    gt_boxes[:, :2] = [[[8, 6, 50, 44], [40, 20, 90, 60]],
                       [[4, 10, 34, 50], [30, 2, 88, 30]]]
    return {"key": rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32),
            "ref": rng.uniform(0, 255, (B, n_ref, H, W, 3)).astype(
                np.float32),
            "gt_boxes": gt_boxes,
            "gt_labels": np.array([[2, 4, 0], [1, 5, 0]], np.int32),
            "gt_valid": np.array([[True, True, False]] * B)}


_SETUPS = {}


def setup(name):
    """JAX's detector and drawn parameters, the port's detector loaded from
    them, and a batch (built once a case)."""
    if name not in _SETUPS:
        method, jcls, tcls, kw = CASES[name]
        det = jcls(num_classes=5, resnet_layers=(1, 1, 1), **kw)
        batch = make_batch(method)
        sample = {"key": jnp.asarray(batch["key"][0]),
                  "ref": jnp.asarray(batch["ref"][0])}
        shapes = jax.eval_shape(lambda k: jdt.init_method_train_params(
            method, det, k, sample, jnp.asarray([H, W]), post_nms_top_n=NK),
            jax.random.key(0))
        params = {"params": jax.tree_util.tree_map_with_path(
            damp, randomize(shapes["params"], 1))}
        ours = tcls(num_classes=5, resnet_layers=(1, 1, 1), **kw,
                    device=META)
        ours.load_state_dict(params_from_jax(flatten_params(
            params["params"])), strict=True, assign=True)
        _SETUPS[name] = (method, det, params, ours, batch)
    return _SETUPS[name]


def frames(seed=4):
    return np.random.default_rng(seed).integers(0, 256, (T, H, W, 3),
                                                dtype=np.uint8)


def detect_kw(method):
    kw = {"rdn": dict(key_post_nms=NK), "dff": dict(key_interval=2,
                                                    post_nms_top_n=NK)}
    return kw.get(method, dict(post_nms_top_n=NK))


# -- whole videos ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_detect_video_matches_jax(name):
    method, det, params, ours, _ = setup(name)
    images, hw = frames(), np.asarray([H, W], np.float32)
    want = JAX_DETECT[method](det, params, images, hw, **detect_kw(method))
    got = PORT_DETECT[method](ours, images, hw, **detect_kw(method))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() > T
    np.testing.assert_allclose(got["proposals"], want["proposals"],
                               rtol=0, atol=PROPOSAL_TOL)
    np.testing.assert_allclose(got["proposal_scores"],
                               want["proposal_scores"], rtol=0, atol=1e-5)
    for k in set(got) - {"valid", "proposals", "proposal_scores"}:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        close(got[k], want[k], 5e-4)


def jax_bf16_map(method, det, params, images):
    """The map each method detects on, from bf16 parameters and frames, in
    JAX: C4 (base), the fc0 of the key proposals (RDN), the aggregate
    (FGFA), the propagated features (DFF)."""
    cp = _cast_f32_leaves(params, jnp.bfloat16)
    imgs = jnp.asarray(images, jnp.float32)
    hw = jnp.asarray([H, W])

    def fwd(m):
        c4 = m.features(imgs, compute_dtype=jnp.bfloat16)
        if method == "fgfa":
            return m.fgfa.aggregate_test(imgs[1:2], imgs,
                                         m.fgfa.precompute_frame(c4), 1)
        if method == "dff":
            return m.dff.propagate(imgs[1:2], imgs[:1], c4[:1])
        if method == "rdn":
            b, _, v = m.propose(c4[0], hw, post_nms_top_n=NK)
            return m.frame_fc0(c4[0], b, v), b, v
        return c4
    return jax.jit(lambda p: det.apply(p, method=fwd))(cp)


@pytest.mark.parametrize("name", ["base", "rdn", "fgfa", "dff"])
def test_detect_video_bf16(name):
    method, det, params, ours, _ = setup(name)
    images = frames(5)
    want = jax_bf16_map(method, det, params, images)
    c16 = cast_floating(ours, torch.bfloat16)
    imgs = t(images).float()
    with torch.no_grad():
        c4 = c16.features(imgs, torch.bfloat16)
        if method == "fgfa":
            got = c16.fgfa.aggregate_test(imgs[1:2], imgs,
                                          c16.fgfa.precompute_frame(c4), 1)
        elif method == "dff":
            got = c16.dff.propagate(imgs[1:2], imgs[:1], c4[:1])
        elif method == "rdn":
            # on JAX's proposals: no NMS decision in the comparison
            fc0, boxes, valid = (np.asarray(x) for x in want)
            got, want = c16.frame_fc0(c4[0], t(boxes), t(valid)), fc0
        else:
            got = c4
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    want = np.asarray(want, np.float32).reshape(got.shape)
    scale = np.abs(want).max()
    flow = 2 if method in ("fgfa", "dff") else 1
    assert np.abs(got - want).max() <= flow * MAX_TOL * scale
    assert np.abs(got - want).mean() <= flow * MEAN_TOL * scale

    hw = np.asarray([H, W], np.float32)
    out = PORT_DETECT[method](ours, images, hw, compute_dtype="bfloat16",
                              **detect_kw(method))
    ref = PORT_DETECT[method](ours, images, hw, **detect_kw(method))
    for k, v in out.items():
        assert v.shape == ref[k].shape, k
        assert v.dtype == ref[k].dtype, k
        assert np.isfinite(v).all(), k
    assert next(ours.parameters()).dtype == torch.float32


# -- training ---------------------------------------------------------------------

def sample_args(batch, i=0):
    return ({"key": batch["key"][i], "ref": batch["ref"][i]},
            batch["gt_boxes"][i], batch["gt_labels"][i],
            batch["gt_valid"][i])


def gradients(model, loss) -> dict:
    """Every parameter's gradient of ``loss`` under its flax key (zeros
    where the loss does not reach it, as JAX gives)."""
    names = [n for n, _ in model.named_parameters()]
    leaves = [p for _, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {k: v.astype(np.float64) for k, v in params_to_jax(
        {n: torch.zeros_like(p) if g is None else g
         for n, p, g in zip(names, leaves, grads)}).items()}


def off_leaves(got_g, want_g) -> dict:
    """The leaves whose gradient lies more than GRAD_TOL x (1 + max |g|)
    from JAX's."""
    worst = {k: np.abs(got_g[k] - g).max() / (1 + np.abs(g).max())
             for k, g in want_g.items()}
    return {k: v for k, v in worst.items() if v > GRAD_TOL}


def fp64_gradients(method, ours, sample, gtb, gtl, gtv, key) -> dict:
    """The port's gradient of the same sample's loss, computed in fp64 on
    a float64 copy of the detector (the frames enter in fp64)."""
    o64 = copy.deepcopy(ours).double()
    o64.features = functools.partial(type(ours).features, o64,
                                     compute_dtype=torch.float64)
    losses = tdt.method_detector_losses(
        method, o64, {k: t(v) for k, v in sample.items()}, (H, W), t(gtb),
        t(gtl), t(gtv), port_draw(key), post_nms_top_n=NK)
    return gradients(o64, losses["total_loss"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_method_losses_and_gradients_match_jax(name):
    method, det, params, ours, batch = setup(name)
    key = jax.random.key(5)
    sample, gtb, gtl, gtv = sample_args(batch)

    @jax.jit
    def run(params, sample, gtb, gtl, gtv):
        def loss_fn(params):
            out = jdt.method_detector_losses(
                method, det, params, sample, jnp.asarray([H, W]), gtb, gtl,
                gtv, key, post_nms_top_n=NK)
            return out["total_loss"], out
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, want), want_g = run(params, {k: jnp.asarray(v)
                                     for k, v in sample.items()},
                            jnp.asarray(gtb), jnp.asarray(gtl),
                            jnp.asarray(gtv))
    want_g = flatten_params(want_g["params"])
    got = tdt.method_detector_losses(
        method, ours, {k: t(v) for k, v in sample.items()}, (H, W), t(gtb),
        t(gtl), t(gtv), port_draw(key), post_nms_top_n=NK)
    for k, v in want.items():
        v = float(v)
        assert abs(got[k].item() - v) <= LOSS_TOL * (1 + abs(v)), (k, got[k],
                                                                   v)
    got_g = gradients(ours, got["total_loss"])
    assert sorted(got_g) == sorted(want_g)
    bad = off_leaves(got_g, want_g)
    if bad:
        # a ReLU at rounding distance from 0 (see the module docstring):
        # a bounded fp32 gap, and the port's fp64 gradient holds the leaves
        assert len(bad) <= FLIP_LEAVES, bad
        assert max(bad.values()) <= FLIP_TOL, bad
        got_g = fp64_gradients(method, ours, sample, gtb, gtl, gtv, key)
        bad = off_leaves(got_g, want_g)
    assert not bad, bad
    # the method's own machinery takes gradient, as JAX's test asks
    part = {"base": "head/", "rdn": "rdn/", "fgfa": "fgfa/",
            "dff": "dff/"}[method]
    assert sum(np.abs(g).sum() for k, g in got_g.items()
               if k.startswith(part)) > 0


@pytest.mark.parametrize("name", ["base", "rdn", "fgfa", "dff"])
def test_method_train_step_matches_jax(name):
    """One step at a batch of 2 against make_method_train_step with the
    same draws: the mean losses and every parameter."""
    method, det, params, _, batch = setup(name)
    sched = (1e-3, 500, (100000,), 0.1, 1e-3 / 3)
    tx = jopt.detector_sgd(jopt.multistep_schedule(*sched), params)
    step = jdt.make_method_train_step(method, det, tx, image_hw=(H, W),
                                      post_nms_top_n=NK)
    rng = jax.random.key(7)
    new, _, losses = step(params, tx.init(params),
                          {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    keys = jax.random.split(rng, B)

    ours = CASES[name][2](num_classes=5, resnet_layers=(1, 1, 1),
                          **CASES[name][3], device=META)
    ours.load_state_dict(params_from_jax(flatten_params(params["params"])),
                         strict=True, assign=True)
    opt = topt.detector_sgd(topt.multistep_schedule(*sched),
                            ours.named_parameters())
    got = tdt.detector_train_step(
        ours, opt, {k: t(v) for k, v in batch.items()},
        lambda i: port_draw(keys[i]), image_hw=(H, W), post_nms_top_n=NK,
        method=method)
    for k, v in losses.items():
        assert abs(got[k].item() - float(v)) <= LOSS_TOL * (1 + abs(float(v)))
    got_p = params_to_jax(ours.state_dict())
    for k, v in flatten_params(new["params"]).items():
        np.testing.assert_allclose(got_p[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


# -- the pieces ---------------------------------------------------------------------

def test_rdn_set_without_valid_keys_gives_zeros():
    """A window with no valid proposal: the attention's finite NEG_INF
    gives a uniform softmax, times validity 0, so zeros and no NaN."""
    _, _, _, ours, _ = setup("rdn")
    rng = np.random.default_rng(3)
    x = t(rng.standard_normal((5, 1024)).astype(np.float32))
    rois = t(np.tile([[4.0, 4.0, 30.0, 40.0]], (5, 1)).astype(np.float32))
    ref = tr.BoxSet(x, rois, torch.zeros(5, dtype=torch.bool))
    with torch.no_grad():
        out = ours.rdn.attention(x, rois, ref, 0)
    np.testing.assert_array_equal(
        out.numpy(), np.broadcast_to(ours.rdn.Wv0.bias.detach().numpy(),
                                     out.shape))


@pytest.mark.parametrize("name", sorted(CASES))
def test_method_params_round_trip(name):
    """Every leaf of the detector (FlowNetS's transposed convolutions, the
    RDN's grouped Wv kernels, C5, the two-FC head) crosses and comes back
    bit for bit; the flax names are the port's."""
    _, _, params, ours, _ = setup(name)
    flat = flatten_params(params["params"])
    mine = params_to_jax(ours.state_dict())
    assert sorted(mine) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["fgfa", "rdn"])
def test_graft_and_checkpoints_take_any_detector(name, tmp_path):
    """graft_backbone seeds C4 and C5 where each detector holds them (C5
    under ``c5`` for FGFA, under ``box_head/c5`` for RDN) as JAX's does,
    and a checkpoint of the detector restores bit for bit."""
    _, _, params, ours, _ = setup(name)
    rng = np.random.default_rng(12)
    c5 = "c5" if "c5" in params["params"] else "box_head"
    pkl = jax.tree.map(lambda x: rng.standard_normal(x.shape),
                       {"c4": params["params"]["backbone"],
                        "c5": (params["params"][c5] if c5 == "c5"
                               else params["params"][c5]["c5"])})
    want = flatten_params(jdt.graft_backbone(params, pkl)["params"])
    det = copy.deepcopy(ours)
    tdt.graft_backbone(det, pkl)
    got = params_to_jax(det.state_dict())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    opt = topt.detector_sgd(lambda s: 0.1, det.named_parameters())
    path = tdt.save_detector_checkpoint(str(tmp_path), 3, det, opt,
                                        np.random.default_rng(0))
    fresh = copy.deepcopy(ours)
    fresh_opt = topt.detector_sgd(lambda s: 0.1, fresh.named_parameters())
    assert tdt.restore_detector_checkpoint(path, fresh, fresh_opt,
                                           np.random.default_rng(1)) == 3
    for (n, a), b in zip(det.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n
