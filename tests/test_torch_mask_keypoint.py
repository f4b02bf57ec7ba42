"""The mask and keypoint RoI heads in the port
(``vrdone_tpu_torch/models/mask_keypoint.py``) against the JAX package on
the CPU: the heads at narrow widths (a two-conv mask tower, a dilated one,
the bare C4 predictor, a two-conv keypoint tower) on flax parameters drawn
from ``jax.eval_shape`` shapes (``tests/test_torch_detector.py::randomize``)
and crossed with ``convert.params_from_jax``; ``Deconv`` alone at odd sizes,
against JAX's and against torch's own ``ConvTranspose2d`` on the weight the
JAX docstring transplants; the targets, losses and post-processing.

Tolerances: head outputs ``FWD_TOL`` of max |ref| in fp32 and on a bf16
input with fp32 parameters wherever JAX promotes to fp32; bf16 paths within
``MAX_TOL`` / ``MEAN_TOL`` of max |ref| (JAX's own bf16-to-fp32 limits);
losses ``LOSS_TOL`` x (1 + |loss|); each parameter's gradient ``GRAD_TOL`` x
max |g_JAX|, with the bounded-flip fallback to the port's fp64 gradient of
``tests/test_torch_detector_methods.py``; targets, heatmap bins, validity
and the host post-processing exact. The keypoint Deconv's bias has an
analytically zero gradient (it shifts every bin of a heatmap, and each
heatmap's softmax cross-entropy gradient sums to 0 over its bins), so both
frameworks compute float noise there (2.6e-8 in JAX, 3.4e-8 in the port on
this test's case): it is held to ``GRAD_TOL`` x the largest max |g_JAX| of
the head's leaves instead.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_detector import randomize
from tools.export_params_npz import flatten_params
from vrdone_tpu.models import mask_keypoint as jm
from vrdone_tpu.models.detector import _cast_f32_leaves
from vrdone_tpu_torch.convert import params_from_jax, params_to_jax
from vrdone_tpu_torch.models import mask_keypoint as tm
from vrdone_tpu_torch.utils.precision import cast_floating

torch.set_num_threads(1)

META = torch.device("meta")
FWD_TOL = 1e-4
LOSS_TOL = 1e-4
GRAD_TOL = 1e-4
FLIP_LEAVES, FLIP_TOL = 8, 1e-2
MAX_TOL, MEAN_TOL = 5e-2, 5e-3
# leaves whose gradient is 0 analytically (see the module docstring)
ZERO_GRAD = ("kps_score_lowres/bias",)

# name: (JAX module, port module's keyword arguments, input shape (R, res,
# res, C)); the port takes the input width, flax reads it off the input
CASES = {
    "mask": (jm.MaskHead(num_classes=5, conv_layers=(16, 16)),
             dict(num_classes=5, conv_layers=(16, 16)), (6, 7, 7, 12)),
    "mask_dilated": (jm.MaskHead(num_classes=4, conv_layers=(8,),
                                 dilation=2),
                     dict(num_classes=4, conv_layers=(8,), dilation=2),
                     (5, 9, 9, 6)),
    "mask_c4": (jm.MaskHead(num_classes=5, conv_layers=(), dim_reduced=8),
                dict(num_classes=5, conv_layers=(), dim_reduced=8),
                (4, 7, 7, 16)),
    "keypoint": (jm.KeypointHead(num_keypoints=4, conv_layers=(16, 16)),
                 dict(num_keypoints=4, conv_layers=(16, 16)), (5, 7, 7, 12)),
}

_SETUPS = {}


def t(a):
    return torch.from_numpy(np.array(a))


def setup(name):
    """JAX's head and drawn parameters, the port's loaded from them, an
    input (built once a case)."""
    if name not in _SETUPS:
        head, kw, shape = CASES[name]
        x = np.random.default_rng(len(name)).standard_normal(shape).astype(
            np.float32)
        shapes = jax.eval_shape(lambda k: head.init(k, jnp.asarray(x)),
                                jax.random.key(0))
        params = {"params": randomize(shapes["params"], 2)}
        cls = tm.KeypointHead if name == "keypoint" else tm.MaskHead
        ours = cls(shape[-1], **kw, device=META)
        ours.load_state_dict(params_from_jax(flatten_params(
            params["params"])), strict=True, assign=True)
        apply = jax.jit(head.apply)
        _SETUPS[name] = (head, params, ours, x, apply)
    return _SETUPS[name]


def close(got, want, tol=FWD_TOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def bf16_close(got, want):
    want = np.asarray(want, np.float32)
    gap = np.abs(got.detach().float().numpy() - want)
    assert gap.max() <= MAX_TOL * np.abs(want).max()
    assert gap.mean() <= MEAN_TOL * np.abs(want).max()


# -- the heads -------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_head_matches_jax(name):
    _, params, ours, x, apply = setup(name)
    want = apply(params, jnp.asarray(x))
    res = x.shape[1] * (4 if name == "keypoint" else 2)
    assert want.shape[1:3] == (res, res)
    with torch.no_grad():
        close(ours(t(x)), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_head_bf16_matches_jax(name):
    """A bf16 input on fp32 parameters computes as JAX promotes it: fp32
    after the rounded input, except the bare C4 predictor, whose Deconv
    casts its kernel to the bf16 input (the 1x1 logits promote again); on
    a bf16 copy of the parameters the head runs bf16 throughout."""
    _, params, ours, x, apply = setup(name)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = apply(params, xb)
    with torch.no_grad():
        got = ours(t(x).bfloat16())
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    if name == "mask_c4":
        bf16_close(got, want)
    else:
        close(got, want)
    want = apply(_cast_f32_leaves(params, jnp.bfloat16), xb)
    with torch.no_grad():
        got = cast_floating(ours)(t(x).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    bf16_close(got, want)


def head_loss(name, out, lib, xnp):
    """The head's loss on fixed targets: the mask BCE on each roi's class
    channel with a padded roi, the keypoint cross entropy over valid
    keypoints with a masked roi."""
    rng = np.random.default_rng(9)
    r, res = out.shape[0], out.shape[1]
    weight = np.ones(r, np.float32)
    weight[-1] = 0.0
    if name == "keypoint":
        k = out.shape[-1]
        heatmaps = rng.integers(0, res * res, (r, k)).astype(np.int32)
        valid = (rng.uniform(size=(r, k)) > 0.3).astype(np.int32)
        return lib.keypoint_loss(out, xnp(heatmaps), xnp(valid),
                                 roi_weight=xnp(weight))
    labels = rng.integers(1, out.shape[-1], r).astype(np.int32)
    targets = (rng.uniform(size=(r, res, res)) > 0.5).astype(np.float32)
    return lib.mask_loss(out, xnp(labels), xnp(weight), xnp(targets))


def gradients(model, loss) -> dict:
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    return {k: v.astype(np.float64) for k, v in params_to_jax(
        dict(zip(names, grads))).items()}


def off_leaves(got_g, want_g) -> dict:
    largest = max(np.abs(g).max() for g in want_g.values())
    worst = {k: np.abs(got_g[k] - g).max()
             / (largest if k in ZERO_GRAD else np.abs(g).max())
             for k, g in want_g.items()}
    return {k: v for k, v in worst.items() if v > GRAD_TOL}


@pytest.mark.parametrize("name", sorted(CASES))
def test_head_loss_and_gradients_match_jax(name):
    head, params, ours, x, _ = setup(name)
    want, want_g = jax.jit(jax.value_and_grad(lambda p: head_loss(
        name, head.apply(p, jnp.asarray(x)), jm, jnp.asarray)))(params)
    want_g = flatten_params(want_g["params"])
    got = head_loss(name, ours(t(x)), tm, t)
    assert abs(got.item() - float(want)) <= LOSS_TOL * (1 + abs(float(want)))
    got_g = gradients(ours, got)
    assert sorted(got_g) == sorted(want_g)
    bad = off_leaves(got_g, want_g)
    if bad:
        # a ReLU at rounding distance from 0 (see the module docstring)
        assert len(bad) <= FLIP_LEAVES, bad
        assert max(bad.values()) <= FLIP_TOL, bad
        o64 = copy.deepcopy(ours).double()
        bad = off_leaves(gradients(o64, head_loss(
            name, o64(t(x).double()), tm, lambda a: t(a).double()
            if np.asarray(a).dtype == np.float32 else t(a))), want_g)
    assert not bad, bad


@pytest.mark.parametrize("name", sorted(CASES))
def test_head_params_round_trip(name):
    _, params, ours, _, _ = setup(name)
    flat = flatten_params(params["params"])
    mine = params_to_jax(ours.state_dict())
    assert sorted(mine) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)


@pytest.mark.parametrize("k,s,p,hw", [(2, 2, 0, (5, 7)), (4, 2, 1, (5, 7)),
                                      (3, 2, 1, (4, 3)), (3, 3, 0, (1, 5))])
def test_deconv_is_conv_transpose(k, s, p, hw):
    """``Deconv`` crossed from JAX at odd sizes equals JAX's, and a torch
    ``ConvTranspose2d`` weight W (in, out, kh, kw) transplanted as JAX's
    docstring says, W.transpose(2, 3, 0, 1)[::-1, ::-1], gives through the
    port exactly what ``ConvTranspose2d`` gives."""
    rng = np.random.default_rng(k * 10 + s)
    x = rng.standard_normal((2, *hw, 5)).astype(np.float32)
    ref = torch.nn.ConvTranspose2d(5, 3, k, stride=s, padding=p)
    with torch.no_grad():
        ref.weight.copy_(t(rng.standard_normal((5, 3, k, k))))
        ref.bias.copy_(t(rng.standard_normal(3)))
    params = {"params": {
        "kernel": ref.weight.detach().numpy().transpose(2, 3, 0, 1)[::-1,
                                                                    ::-1],
        "bias": ref.bias.detach().numpy()}}
    want = jm.Deconv(3, k, s, p).apply(params, jnp.asarray(x))
    ours = tm.Deconv(5, 3, k, s, p, device=META)
    ours.load_state_dict(params_from_jax(flatten_params(params["params"])),
                         assign=True)
    with torch.no_grad():
        got = ours(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        torch_ref = ref(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape[1:3] == ((hw[0] - 1) * s + k - 2 * p,
                              (hw[1] - 1) * s + k - 2 * p)
    close(got, want)
    close(got, torch_ref.numpy(), 1e-6)


# -- targets and losses -----------------------------------------------------------

def rois(rng, n, hm, wm, lo=-0.2):
    """``n`` xyxy boxes over an hm x wm frame, their corners from ``lo``
    of the frame on."""
    xy = rng.uniform(lo, 0.8, (n, 2)) * (wm, hm)
    wh = rng.uniform(0.05, 0.6, (n, 2)) * (wm, hm)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_project_masks_on_boxes_matches_jax():
    """Boxes inside, across and off the bitmap, and a box under a pixel
    wide (its crop floored at 1 px)."""
    rng = np.random.default_rng(3)
    bitmaps = (rng.uniform(size=(8, 40, 48)) > 0.5).astype(np.float32)
    boxes = rois(rng, 8, 40, 48)
    boxes[0] = [10.3, 5.2, 10.6, 30.0]
    boxes[1] = [-5.0, -5.0, 60.0, 50.0]
    for m in (7, 14):
        want = jm.project_masks_on_boxes(jnp.asarray(bitmaps),
                                         jnp.asarray(boxes), m)
        np.testing.assert_array_equal(
            tm.project_masks_on_boxes(t(bitmaps), t(boxes), m).numpy(),
            np.asarray(want))


def gt_case():
    """JAX's pipeline case (tests/test_mask_keypoint.py) with more
    proposals: two valid GT boxes with masks and keypoints, a padded
    slot."""
    gt_boxes = np.array([[8, 8, 24, 24], [30, 30, 44, 44], [0, 0, 0, 0]],
                        np.float32)
    gt_valid = np.array([True, True, False])
    gt_labels = np.array([2, 4, 0], np.int32)
    bitmaps = np.zeros((3, 48, 48), np.float32)
    bitmaps[0, 8:24, 8:24] = 1
    bitmaps[1, 30:44, 30:44] = 1
    proposals = np.array([[9, 9, 23, 23], [29, 31, 45, 43], [0, 40, 8, 47],
                          [8, 8, 24, 24], [31, 29, 44, 45], [6, 9, 25, 22],
                          [0, 0, 0, 0]], np.float32)
    pvalid = np.array([True] * 6 + [False])
    kp = np.zeros((3, 3, 3), np.float32)
    kp[0, :, :2] = [[12, 12], [20, 20], [24, 10]]    # the last on x2
    kp[0, :, 2] = [2, 2, 1]
    kp[1, :, :2] = [[35, 35], [40, 40], [50, 50]]    # the last outside
    kp[1, :, 2] = [0, 0, 2]
    return gt_boxes, gt_valid, gt_labels, bitmaps, proposals, pvalid, kp


def test_mask_targets_and_loss_match_jax():
    gtb, gtv, gtl, bitmaps, props, pvalid, _ = gt_case()
    want = jm.mask_head_targets(*(jnp.asarray(a) for a in (
        props, pvalid, gtb, gtl, gtv, bitmaps)), m=8)
    got = tm.mask_head_targets(*(t(a) for a in (
        props, pvalid, gtb, gtl, gtv, bitmaps)), m=8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].sum() >= 4
    logits = np.random.default_rng(4).standard_normal(
        (7, 8, 8, 6)).astype(np.float32)
    loss_w, grad_w = jax.value_and_grad(lambda lg: jm.mask_loss(
        lg, *want))(jnp.asarray(logits))
    lg = t(logits).requires_grad_()
    loss = tm.mask_loss(lg, *got)
    assert abs(loss.item() - float(loss_w)) <= LOSS_TOL * (1 + float(loss_w))
    (g,) = torch.autograd.grad(loss, lg)
    np.testing.assert_allclose(g.numpy(), np.asarray(grad_w), rtol=1e-5,
                               atol=1e-8)


def test_keypoints_to_heatmap_is_exact():
    """Keypoints inside, outside, on the right and bottom edges (bin hs -
    1), invisible, and on degenerate rois: a division by 0 gives +-inf or
    NaN, whose int32 conversion differs between the frameworks (XLA
    saturates, NaN to 0), but such a keypoint is invalid or on the
    boundary bin in both."""
    rng = np.random.default_rng(5)
    r, k, hs = 7, 5, 14
    boxes = rois(rng, r, 60, 80, lo=0.0)
    kp = np.zeros((r, k, 3), np.float32)
    kp[..., 0] = rng.uniform(boxes[:, :1] - 5, boxes[:, 2:3] + 5, (r, k))
    kp[..., 1] = rng.uniform(boxes[:, 1:2] - 5, boxes[:, 3:4] + 5, (r, k))
    kp[..., 2] = rng.integers(0, 3, (r, k))
    kp[0, 0, :2] = boxes[0, 2:4]
    kp[1, 1, 0] = boxes[1, 2]
    boxes[2] = [10, 10, 10, 20]
    boxes[3] = [0, 0, 0, 0]
    kp[2, 0] = [10, 15, 2]
    kp[3, 0] = [0, 0, 2]
    want = jm.keypoints_to_heatmap(jnp.asarray(kp), jnp.asarray(boxes), hs)
    got = tm.keypoints_to_heatmap(t(kp), t(boxes), hs)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].sum() > 5


def test_keypoint_targets_and_loss_match_jax():
    gtb, gtv, _, _, props, pvalid, kp = gt_case()
    want = jm.keypoint_head_targets(*(jnp.asarray(a) for a in (
        props, pvalid, gtb, gtv, kp)), heatmap_size=14)
    got = tm.keypoint_head_targets(*(t(a) for a in (
        props, pvalid, gtb, gtv, kp)), heatmap_size=14)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].sum() >= 2
    pos, heatmaps, valid = got
    logits = np.random.default_rng(6).standard_normal(
        (7, 14, 14, 3)).astype(np.float32)
    for weight in (None, pos):
        loss_w, grad_w = jax.value_and_grad(lambda lg: jm.keypoint_loss(
            lg, *want[1:], roi_weight=None if weight is None else want[0]))(
            jnp.asarray(logits))
        lg = t(logits).requires_grad_()
        loss = tm.keypoint_loss(lg, heatmaps, valid, roi_weight=weight)
        assert abs(loss.item() - float(loss_w)) <= \
            LOSS_TOL * (1 + float(loss_w))
        (g,) = torch.autograd.grad(loss, lg)
        np.testing.assert_allclose(g.numpy(), np.asarray(grad_w), rtol=1e-5,
                                   atol=1e-8)


# -- post-processing ------------------------------------------------------------------

def test_post_processing_matches_jax():
    """select_mask_probs on the device, then the host copies on its output:
    paste_masks_in_image and heatmaps_to_keypoints equal JAX's."""
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((4, 6, 6, 5)).astype(np.float32)
    labels = np.array([1, 3, 2, 4])
    want = np.asarray(jm.select_mask_probs(jnp.asarray(logits),
                                           jnp.asarray(labels)))
    probs = tm.select_mask_probs(t(logits), t(labels)).numpy()
    np.testing.assert_allclose(probs, want, rtol=1e-6, atol=1e-7)
    boxes = np.array([[4, 6, 20, 25], [0, 0, 10, 10], [30, 20, 47, 31],
                      [-3, 5, 12, 40]], np.float32)
    np.testing.assert_array_equal(
        tm.paste_masks_in_image(want, boxes, (32, 48)),
        jm.paste_masks_in_image(want, boxes, (32, 48)))
    maps = rng.standard_normal((4, 12, 12, 3)).astype(np.float32)
    for g, w in zip(tm.heatmaps_to_keypoints(maps, boxes),
                    jm.heatmaps_to_keypoints(maps, boxes)):
        np.testing.assert_array_equal(g, w)
