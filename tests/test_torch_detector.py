"""The port's detector (``vrdone_tpu_torch.models.detector`` and the box
ops, ResNet and RPN under it) against ``vrdone_tpu.models.detector`` on the
same inputs and converted parameters, at the size of
``tests/test_detector.py::_tiny_detector`` (R (1, 1, 1), stage 2, 4 groups,
base_num 4, window 3) on a 96 x 128 canvas.

Tolerances (fp32): box ops 1e-5 (RoIAlign is two products of bilinear
weights); NMS and proposal selection exact on identical inputs; the
backbone, RPN and C5 1e-4 of the output's largest magnitude (a dozen
chained convolutions summed in other orders); the whole video 5e-4 of the
largest magnitude (the above, then fc0, the MEGA stream and the
predictors). The whole-video comparison also requires the same proposals:
the RPN logits of these weights are spread (variance 1/fan_in kernels), so
no near-tie flips a top-k or NMS keep between the frameworks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tools.export_params_npz import flatten_params
from vrdone_tpu.models import detector as jd
from vrdone_tpu.models import rpn as jrpn
from vrdone_tpu.models.mega import BoxSet, flatten_set
from vrdone_tpu.ops import boxes as jboxes
from vrdone_tpu_torch.convert import (load_params, params_from_jax,
                                      params_to_jax)
from vrdone_tpu_torch.models import detector as td
from vrdone_tpu_torch.models import rpn as trpn
from vrdone_tpu_torch.ops import boxes as tboxes

torch.set_num_threads(1)

CPU = torch.device("cpu")
T, H, W, NK = 4, 96, 128, 8
KW = dict(num_classes=5, resnet_layers=(1, 1, 1), stage=2, groups=4,
          base_num=4, window=3, key_loc=1, global_size=2, global_res_stage=1)


def t(a):
    return torch.from_numpy(np.asarray(a))


def rand_boxes(rng, n, hw=(H, W)):
    xy = rng.uniform(-10, hw[1] * 0.8, (n, 2))
    wh = rng.uniform(2, hw[0] * 0.6, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def randomize(shapes, seed):
    """Every leaf from numpy: kernels with variance 1/fan_in, frozen-BN
    scales and variances in [0.5, 1.5], the rest small."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name, shape = path[-1].key, x.shape
        if name == "kernel":
            fan_in = shape[1] if len(shape) == 3 else np.prod(shape[:-1])
            bound = np.sqrt(3.0 / fan_in)
            return rng.uniform(-bound, bound, shape).astype(np.float32)
        if name in ("weight", "running_var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def init_run(det, key_post_nms):
    """detect_and_track.init_detector_params' traced function: touches every
    parameter of the detection path."""
    def run(m, canvas, hw):
        c4 = m.features(canvas[None])[0]
        kb, _, kv = m.propose(c4, hw, post_nms_top_n=key_post_nms)
        rb, _, rv = m.propose(c4, hw, post_nms_top_n=det.base_num)
        key_fc0 = m.frame_fc0(c4, kb, kv)
        ref_fc0 = m.frame_fc0(c4, rb, rv)
        win = BoxSet(jnp.repeat(ref_fc0[None], det.window, 0),
                     jnp.repeat(rb[None], det.window, 0),
                     jnp.repeat(rv[None], det.window, 0))
        glob = flatten_set(BoxSet(ref_fc0[None], rb[None], rv[None]))
        x = m.enhance(key_fc0, kb, kv, win, None, glob, key_is_fc0=True)
        return m.box_head.predictions(x)
    return run


@pytest.fixture(scope="module")
def detectors():
    """The tiny JAX detector with drawn parameters, and the port's loaded
    from them; a 4-frame uint8 video."""
    det = jd.MegaDetector(**KW)
    run = init_run(det, NK)
    canvas = jnp.zeros((H, W, 3), jnp.float32)
    hw = jnp.asarray([H, W], jnp.float32)
    shapes = jax.eval_shape(
        lambda r: det.init(r, canvas, hw, method=run), jax.random.key(0))
    params = {"params": randomize(shapes["params"], 0)}
    ours = td.MegaDetector(**KW, device=CPU)
    load_params(ours, flatten_params(params["params"]))
    images = np.random.default_rng(4).integers(0, 256, (T, H, W, 3),
                                               dtype=np.uint8)
    return det, params, ours, images


# -- box ops ----------------------------------------------------------------

@pytest.mark.parametrize("n,thr,max_out,block", [
    (300, 0.5, None, 64),    # across blocks
    (300, 0.7, 40, 64),      # max_out cuts the survivors
    (37, 0.3, 50, 256),      # fewer boxes than max_out, one block
])
def test_box_iou_and_nms_match_jax(n, thr, max_out, block):
    rng = np.random.default_rng(n + int(10 * thr))
    boxes = rand_boxes(rng, n, (200, 300))
    scores = rng.uniform(size=n).astype(np.float32)
    scores[::7] = -np.inf          # suppressed / invalid entries
    scores[3::11] = scores[2]      # ties keep their input order
    np.testing.assert_allclose(
        tboxes.box_iou(t(boxes[:20]), t(boxes)).numpy(),
        np.asarray(jboxes.box_iou(jnp.asarray(boxes[:20]),
                                  jnp.asarray(boxes))), rtol=1e-5, atol=1e-6)
    ji, jv = jboxes.nms(jnp.asarray(boxes), jnp.asarray(scores), thr,
                        max_out=max_out, block=block)
    ti, tv = tboxes.nms(t(boxes), t(scores), thr, max_out=max_out,
                        block=block)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy()[tv.numpy()],
                                  np.asarray(ji)[np.asarray(jv)])
    assert 0 < tv.sum() < n


def test_roi_align_matches_jax():
    rng = np.random.default_rng(1)
    for c, h, w in ((16, 9, 13), (8, 13, 9)):   # both contraction orders
        feat = rng.standard_normal((c, h, w)).astype(np.float32)
        rois = rand_boxes(rng, 11, (16 * h, 16 * w))
        rois[0] = [0, 0, 1, 1]                   # under one bin
        want = jboxes.roi_align(jnp.asarray(feat), jnp.asarray(rois),
                                spatial_scale=1 / 16, output_size=(7, 5),
                                sampling_ratio=2)
        got = tboxes.roi_align(t(feat), t(rois), spatial_scale=1 / 16,
                               output_size=(7, 5), sampling_ratio=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


# -- backbone, RPN, C5 ------------------------------------------------------

def close(ours, theirs, tol):
    theirs = np.asarray(theirs)
    scale = np.abs(theirs).max()
    assert scale > 0
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol * scale)


def test_backbone_rpn_c5_match_jax(detectors):
    det, params, ours, images = detectors

    def fwd(m, imgs, rois):
        c4 = m.features(imgs)
        logits, deltas = m.rpn_head(c4)
        return c4, logits, deltas, m.box_head.pooled_features(c4[0], rois)

    rois = rand_boxes(np.random.default_rng(2), 6)
    want = jax.jit(lambda p, i, r: det.apply(p, i, r, method=fwd))(
        params, jnp.asarray(images[:2]), jnp.asarray(rois))
    with torch.no_grad():
        c4 = ours.features(t(images[:2]))
        logits, deltas = ours.rpn(c4)
        pooled = ours.box_head.pooled_features(c4[0], t(rois))
    close(c4.permute(0, 2, 3, 1).numpy(), want[0], 1e-4)
    close(logits.numpy(), want[1], 1e-4)
    close(deltas.numpy(), want[2], 1e-4)
    close(pooled.numpy(), want[3], 1e-4)


def test_select_proposals_identical_keeps():
    rng = np.random.default_rng(3)
    anchors = jrpn.make_anchors(6, 8)
    np.testing.assert_array_equal(trpn.make_anchors(6, 8), anchors)
    n = anchors.shape[0]
    logits = rng.standard_normal(n).astype(np.float32)
    logits[5] = logits[9]          # a tie
    deltas = (0.1 * rng.standard_normal((n, 4))).astype(np.float32)
    for pre, post in ((6000, 8), (200, 50)):
        want = jrpn.select_proposals(
            jnp.asarray(anchors), jnp.asarray(logits), jnp.asarray(deltas),
            jnp.asarray([H, W]), pre_nms_top_n=pre, post_nms_top_n=post)
        got = trpn.select_proposals(t(anchors), t(logits), t(deltas), (H, W),
                                    pre_nms_top_n=pre, post_nms_top_n=post)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-6, atol=1e-6)


# -- the slice as a whole -----------------------------------------------------

def test_detect_video_matches_jax(detectors):
    """JAX on the CPU takes its dense attention with the position-bias
    Pallas kernel in interpret mode; the port on the CPU the plain bias."""
    det, params, ours, images = detectors
    hw = np.asarray([H, W], np.float32)
    want = jd.detect_video(det, params, images, hw, key_post_nms=NK)
    got = td.detect_video(ours, images, hw, key_post_nms=NK)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() > T
    np.testing.assert_allclose(got["proposals"], want["proposals"],
                               rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got["proposal_scores"],
                               want["proposal_scores"], rtol=0, atol=1e-5)
    for k in ("visual", "cls_logits", "bbox_deltas"):
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32
        close(got[k], want[k], 5e-4)

    res = td.postprocess_frame(got["proposals"][0], got["cls_logits"][0],
                               got["bbox_deltas"][0], got["valid"][0],
                               (H, W), score_thresh=0.01)
    ref = jd.postprocess_frame(got["proposals"][0], got["cls_logits"][0],
                               got["bbox_deltas"][0], got["valid"][0],
                               (H, W), score_thresh=0.01)
    np.testing.assert_array_equal(res["labels"], ref["labels"])
    np.testing.assert_allclose(res["boxes"], ref["boxes"], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(res["scores"], ref["scores"], rtol=1e-6)


def test_extract_video_features_matches_jax(detectors):
    det, params, ours, images = detectors
    rng = np.random.default_rng(5)
    rois = np.stack([rand_boxes(rng, 5) for _ in range(T)])
    valid = rng.uniform(size=(T, 5)) > 0.3
    valid[:, 0] = True
    want = jd.extract_video_features(det, params, images, rois, valid,
                                     batch=3)
    got = td.extract_video_features(ours, images, rois, valid, batch=3)
    close(got, want, 5e-4)
    assert np.abs(got[~valid]).max() == 0.0


def test_detector_params_round_trip(detectors):
    """The whole detector tree (2-D convs, frozen BN, GroupedLinear kernels,
    MEGA's u) crosses and comes back unchanged; the head's embedding is
    64-dim in both packages, the one width the bias kernels take."""
    det, params, ours, _ = detectors
    flat = flatten_params(params["params"])
    assert any(k.endswith("l_Wv0/kernel") for k in flat)
    back = params_to_jax(params_from_jax(flat))
    assert list(back) == list(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    mine = params_to_jax(ours.state_dict())
    assert sorted(mine) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(mine[k], flat[k])
    assert ours.mega.embed_dim == jd.make_mega_head(det).embed_dim == 64


# -- test-time augmentation ---------------------------------------------------

@pytest.mark.parametrize("scale,hflip", [(1.0, True), (0.75, False),
                                         (0.75, True)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_view_frames_match_jax(detectors, scale, hflip, dtype):
    images = detectors[3].astype(dtype)
    want = jd._ViewFrames(images, scale=scale, hflip=hflip)
    got = td._ViewFrames(images, scale=scale, hflip=hflip)
    assert len(got) == len(want) == T
    for i in range(T):
        assert got[i].dtype == want[i].dtype
        np.testing.assert_array_equal(got[i], want[i])


def test_detect_video_tta_matches_jax(detectors):
    """Identity, hflip, 0.75x and its flip (four detect_video calls in
    each framework), merged per class. Each view's outputs carry the
    whole-video gap of test_detect_video_matches_jax (5e-4 of the largest
    magnitude), so the merged scores are held within 1e-4 and the boxes
    within 1e-2 of a pixel on the 96 x 128 canvas; labels and counts
    equal."""
    det, params, ours, images = detectors
    hw = np.asarray([H, W], np.float32)
    kw = dict(scales=(0.75,), hflip=True, key_post_nms=NK,
              score_thresh=0.01)
    want = jd.detect_video_tta(det, params, images, hw, **kw)
    got = td.detect_video_tta(ours, images, hw, **kw)
    assert len(got) == len(want) == T
    worst = [0.0, 0.0]
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"boxes", "scores", "labels"}
        np.testing.assert_array_equal(g["labels"], w["labels"])
        assert len(w["boxes"]) > 0
        worst[0] = max(worst[0], np.abs(g["boxes"] - w["boxes"]).max())
        worst[1] = max(worst[1], np.abs(g["scores"] - w["scores"]).max())
        assert (g["boxes"] >= 0).all()
        assert (g["boxes"][:, 0::2] <= W - 1).all()
        assert (g["boxes"][:, 1::2] <= H - 1).all()
    assert worst[0] <= 1e-2 and worst[1] <= 1e-4
