"""MEGA detector training in the port (``vrdone_tpu_torch/models/
detector_train.py``, ``train/optim.py::detector_sgd``, ``models/rpn.py::
encode_boxes``, ``MEGAHead.build_memory`` / ``enhance_train``) against the
JAX package on the CPU, at the size of ``tests/test_detector_train.py``:
R (1, 1, 1), stage 2, 4 groups, base_num 4, window 3, 64 x 64 images with
1 local, 1 memory and 1 global frame, post_nms_top_n 8, and three GT slots
of which the last is padding.

The flax parameter tree is JAX's ``init_train_params``' (its shapes); the
values are drawn as ``tests/test_torch_detector.py`` draws them, with the
MEGA head's and the predictors' kernels damped (``damp``), and cross with
``convert.load_params``. The samplers' priorities are JAX's own draws
(``jax.random.uniform`` from the keys its step splits), fed to the port.
Tolerances: matcher labels, sampler weights and RPN labels equal; single
losses 1e-5 relative; the whole sample's losses 1e-4 x (1 + |loss|) and
each parameter's gradient 1e-4 x (1 + max |g_JAX|) of JAX's leaf (a dozen
chained convolutions, RoIAlign and the MEGA stages summed in other
orders); the SGD 1e-6; one train step's parameters atol = rtol = 1e-5.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.test_torch_detector import randomize
from tools.export_params_npz import flatten_params
from vrdone_tpu.models import detector as jd
from vrdone_tpu.models import detector_train as jdt
from vrdone_tpu.models import rpn as jrpn
from vrdone_tpu.train import optim as jopt
from vrdone_tpu_torch.convert import (flax_key, load_params,
                                      params_from_jax, params_to_jax)
from vrdone_tpu_torch.convert_resnet import convert
from vrdone_tpu_torch.models import detector as td
from vrdone_tpu_torch.models import detector_train as tdt
from vrdone_tpu_torch.models import rpn as trpn
from vrdone_tpu_torch.train import optim as topt

torch.set_num_threads(1)

CPU = torch.device("cpu")
KW = dict(num_classes=5, resnet_layers=(1, 1, 1), stage=2, groups=4,
          base_num=4, window=3, key_loc=1, global_size=2)
H = W = 64
NK = 8            # post_nms_top_n
B = 2             # the train step's batch
LOSS_TOL = 1e-4
GRAD_TOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def rand_boxes(rng, n, hw=(H, W)):
    xy = rng.uniform(-4, hw[1] * 0.7, (n, 2))
    wh = rng.uniform(2, hw[0] * 0.6, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def jax_draws(key, n_rpn, n_box):
    """The priorities JAX's mega_detector_losses draws from a sample key."""
    r1, r2 = jax.random.split(key)
    return (np.asarray(jax.random.uniform(r1, (n_rpn,))),
            np.asarray(jax.random.uniform(r2, (n_box,))))


def port_draw(key):
    """A ``Draw`` that hands the port JAX's priorities of ``key``."""
    def draw(n_rpn, n_box):
        p1, p2 = jax_draws(key, n_rpn, n_box)
        return t(p1), t(p2)
    return draw


def damp(path, x):
    """A tenth of the MEGA head's and the RPN's and box head's predictor
    kernels: at full scale the MEGA softmaxes saturate, and the gradient
    becomes float noise (the port's own gradient moves by up to 1.3e-3 of
    a leaf's max |g| between one and four CPU threads; at a tenth, by
    2e-6)."""
    keys = [p.key for p in path]
    if keys[-1] == "kernel" and (keys[0] == "mega" or keys[-2] in (
            "cls_score", "bbox_pred", "cls_logits")):
        return x * np.float32(0.1)
    return x


@pytest.fixture(scope="module")
def setup():
    """JAX's detector and its init_train_params, the port's detector
    loaded from them, and a batch of two samples: key, local, memory and
    global frames, two GT boxes and a padded slot."""
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 255, (B, 4, H, W, 3)).astype(np.float32)
    gt_boxes = np.zeros((B, 3, 4), np.float32)
    gt_boxes[:, :2] = [[[8, 6, 40, 44], [30, 20, 62, 60]],
                       [[4, 10, 34, 50], [20, 2, 58, 30]]]
    batch = {"key": frames[:, 0], "local": frames[:, 1:2],
             "mem": frames[:, 2:3], "glob": frames[:, 3:4],
             "gt_boxes": gt_boxes,
             "gt_labels": np.array([[2, 4, 0], [1, 5, 0]], np.int32),
             "gt_valid": np.array([[True, True, False]] * B)}
    det = jd.MegaDetector(**KW)
    hw = jnp.asarray([H, W])
    shapes = jax.eval_shape(lambda k: jdt.init_train_params(
        det, k, jnp.asarray(batch["key"][0]),
        jnp.asarray(batch["local"][0]), jnp.asarray(batch["mem"][0]),
        jnp.asarray(batch["glob"][0]), hw, post_nms_top_n=NK),
        jax.random.key(0))
    params = {"params": jax.tree_util.tree_map_with_path(
        damp, randomize(shapes["params"], 0))}
    ours = td.MegaDetector(**KW, device=CPU)
    load_params(ours, flatten_params(params["params"]))
    return det, params, ours, batch


def sample(batch, i=0, mem=None):
    return (batch["key"][i], batch["local"][i],
            batch["mem"][i] if mem is None else mem, batch["glob"][i],
            batch["gt_boxes"][i], batch["gt_labels"][i], batch["gt_valid"][i])


def port_losses(ours, batch, key, i=0, mem=None):
    key_img, loc, mem, glob, gtb, gtl, gtv = (t(x) for x in
                                              sample(batch, i, mem))
    return tdt.mega_detector_losses(ours, key_img, loc, mem, glob, (H, W),
                                    gtb, gtl, gtv, port_draw(key),
                                    post_nms_top_n=NK)


@pytest.fixture(scope="module")
def jax_loss_grad(setup):
    """JAX's losses of sample 0 and their gradient, from one
    value_and_grad."""
    det, params, _, batch = setup
    key = jax.random.key(5)

    @jax.jit
    def run(params, *args):
        def loss_fn(params):
            out = jdt.mega_detector_losses(
                det, params, *args[:3], args[3], jnp.asarray([H, W]),
                *args[4:], key, post_nms_top_n=NK)
            return out["total_loss"], out
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, losses), grads = run(params, *(jnp.asarray(x)
                                       for x in sample(batch)))
    return key, {k: float(v) for k, v in losses.items()}, \
        flatten_params(grads["params"])


# -- the pieces -------------------------------------------------------------

def test_encode_boxes_matches_jax():
    rng = np.random.default_rng(1)
    ref, props = rand_boxes(rng, 40), rand_boxes(rng, 40)
    props[:5, 2:] = props[:5, :2]           # degenerate: the 1-pixel clamp
    ref[5:8] = 0.0                          # padded GT
    for weights in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        want = np.asarray(jrpn.encode_boxes(jnp.asarray(ref),
                                            jnp.asarray(props), weights))
        got = trpn.encode_boxes(t(ref), t(props), weights).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# candidate 0 is each GT's best, at IoU 0.49 (ignored by the RPN's
# thresholds unless force-matched); the padded slots also name it
MATCH_CASES = {
    # a padded slot after the valid GT: its False is the last write
    "padded_after": ([[0, 0, 20, 20], [0, 0, 0, 0]], [True, False], -1),
    # the padded slot first: the valid GT's True stands
    "padded_before": ([[0, 0, 0, 0], [0, 0, 20, 20]], [False, True], 1),
    # two valid GTs naming candidate 0, then a padded slot
    "two_valid": ([[0, 0, 20, 20], [1, 1, 21, 21], [0, 0, 0, 0]],
                  [True, True, False], -1),
}


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
@pytest.mark.parametrize("force,high,low", [(True, 0.7, 0.3),
                                            (False, 0.5, 0.5)])
def test_match_boxes_matches_jax(case, force, high, low):
    rng = np.random.default_rng(2)
    gt, valid, label0 = MATCH_CASES[case]
    gt, valid = np.asarray(gt, np.float32), np.asarray(valid)
    cands = np.concatenate([[[0, 0, 14, 14]], 50 + rand_boxes(rng, 30),
                            [[8, 8, 30, 30]]]).astype(np.float32)
    want = jdt.match_boxes(jnp.asarray(cands), jnp.asarray(gt),
                           jnp.asarray(valid), high=high, low=low,
                           force_match=force)
    got = tdt.match_boxes(t(cands), t(gt), t(valid), high=high, low=low,
                          force_match=force)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(got.matched_idx.numpy(),
                                  np.asarray(want.matched_idx))
    assert int(got.labels[0]) == (label0 if force else 0)


@pytest.mark.parametrize("n_pos,num,frac", [(10, 64, 0.5), (80, 64, 0.5),
                                            (3, 256, 0.25), (0, 16, 0.5)])
def test_balanced_sample_matches_jax(n_pos, num, frac):
    rng = np.random.default_rng(n_pos)
    labels = np.array([1] * n_pos + [0] * 100 + [-1] * 20)
    rng.shuffle(labels)
    key = jax.random.key(n_pos)
    pw, nw = jdt.balanced_sample(jnp.asarray(labels), key, num_samples=num,
                                 pos_fraction=frac)
    prio = np.asarray(jax.random.uniform(key, (len(labels),)))
    gpw, gnw = tdt.balanced_sample(t(labels), t(prio), num_samples=num,
                                   pos_fraction=frac)
    np.testing.assert_array_equal(gpw.numpy(), np.asarray(pw))
    np.testing.assert_array_equal(gnw.numpy(), np.asarray(nw))
    assert int(gpw.sum()) == min(n_pos, int(num * frac))


def test_rpn_losses_match_jax():
    rng = np.random.default_rng(3)
    anchors = jrpn.make_anchors(6, 6)
    gt = np.array([[30, 30, 80, 90], [100, 20, 160, 70], [0, 0, 0, 0]],
                  np.float32)
    valid = np.array([True, True, False])
    obj = rng.standard_normal(len(anchors)).astype(np.float32)
    deltas = (0.3 * rng.standard_normal((len(anchors), 4))).astype(np.float32)
    key = jax.random.key(3)
    want = jax.jit(jdt.rpn_losses)(*(jnp.asarray(x) for x in (
        anchors, obj, deltas, gt, valid)), key)
    prio = np.asarray(jax.random.uniform(key, (len(anchors),)))
    got = tdt.rpn_losses(*(t(x) for x in (anchors, obj, deltas, gt, valid,
                                          prio)))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-5)
    assert float(want["loss_rpn_reg"]) > 0


def test_box_head_losses_match_jax():
    rng = np.random.default_rng(4)
    p, k = 40, 5
    props = rand_boxes(rng, p, (96, 96))
    gt = np.array([[10, 10, 50, 50], [40, 30, 90, 80], [0, 0, 0, 0]],
                  np.float32)
    props[:3] = gt + 1.0                     # positives
    pvalid = np.ones(p, bool)
    pvalid[-4:] = False
    gtl = np.array([3, 5, 0], np.int32)
    gtv = np.array([True, True, False])
    logits = rng.standard_normal((p, k + 1)).astype(np.float32)
    deltas = rng.standard_normal((p, 4 * (k + 1))).astype(np.float32)
    key = jax.random.key(4)
    want = jax.jit(jdt.box_head_losses)(*(jnp.asarray(x) for x in (
        props, pvalid, logits, deltas, gt, gtl, gtv)), key)
    prio = np.asarray(jax.random.uniform(key, (p,)))
    got = tdt.box_head_losses(*(t(x) for x in (props, pvalid, logits, deltas,
                                               gt, gtl, gtv, prio)))
    for name, v in want.items():
        np.testing.assert_allclose(got[name].item(), float(v), rtol=1e-5)
    assert float(want["loss_box_reg"]) > 0


# -- the whole sample ---------------------------------------------------------

def test_mega_losses_and_gradients_match_jax(setup, jax_loss_grad):
    _, _, ours, batch = setup
    key, want, want_g = jax_loss_grad
    ours.zero_grad()
    got = port_losses(ours, batch, key)
    for k, v in want.items():
        assert abs(got[k].item() - v) <= LOSS_TOL * (1 + abs(v)), (k, got[k],
                                                                   v)
    names = [n for n, _ in ours.named_parameters()]
    params = [p for _, p in ours.named_parameters()]
    grads = torch.autograd.grad(got["total_loss"], params, allow_unused=True)
    got_g = params_to_jax({n: torch.zeros_like(p) if g is None else g
                           for n, p, g in zip(names, params, grads)})
    assert sorted(got_g) == sorted(want_g)
    worst = {}
    for k, g in want_g.items():
        scale = 1 + np.abs(g).max()
        err = np.abs(got_g[k] - g).max()
        worst[k] = err / scale
    bad = {k: v for k, v in worst.items() if v > GRAD_TOL}
    assert not bad, bad
    mega = sum(np.abs(g).sum() for k, g in got_g.items()
               if k.startswith("mega/"))
    backbone = sum(np.abs(g).sum() for k, g in got_g.items()
                   if k.startswith("backbone/"))
    assert mega > 0 and backbone > 0


def test_memory_frames_change_the_loss(setup, jax_loss_grad):
    """The training scheme reads its memory frames (the tier-1 counterpart
    of tests/test_detector_train.py's slow end-to-end test): another
    memory frame gives another loss, and no gradient."""
    _, _, ours, batch = setup
    key = jax_loss_grad[0]
    with torch.no_grad():
        a = port_losses(ours, batch, key)["total_loss"].item()
        other = np.random.default_rng(9).uniform(
            0, 255, batch["mem"][0].shape).astype(np.float32)
        b = port_losses(ours, batch, key, mem=other)["total_loss"].item()
    assert np.isfinite(a) and abs(a - b) > 1e-7


def test_training_forward_takes_the_dense_route(setup, monkeypatch):
    """The port's detector (and its head view) takes neither fused route
    in training, as JAX trains it."""
    _, _, ours, batch = setup
    seen = []
    real = ours.mega.enhance_train.__func__

    def spy(head, *a, **kw):
        seen.append((head.fused_pe_bias, head.fused_attention))
        return real(head, *a, **kw)

    monkeypatch.setattr(type(ours.mega), "enhance_train", spy)
    with torch.no_grad():
        port_losses(ours, batch, jax.random.key(1))
    assert seen == [(False, False)]


# -- the optimizer and the step ---------------------------------------------

def test_bias_mask_matches_jax(setup):
    _, params, ours, _ = setup
    want = flatten_params(jopt.bias_mask(params["params"]))
    got = {flax_key(n, p): m for (n, p), m in zip(
        ours.named_parameters(), topt.bias_mask(ours.named_parameters())
        .values())}
    assert got == {k: bool(v) for k, v in want.items()}
    assert got["backbone/stem_bn/bias"] and not got[
        "backbone/stem_bn/running_var"]


def test_detector_sgd_matches_optax(setup):
    """Three updates from the same parameters and gradients, with a
    multistep schedule across its warmup and a milestone, weight decay on
    the bias leaves too, and a gradient whose norm the clip cuts."""
    _, params, _, _ = setup
    p = params["params"]
    sub = {"rpn": {k: p["rpn"][k] for k in ("cls_logits", "bbox_pred")},
           "box_head": {"cls_score":
                                         p["box_head"]["cls_score"]},
           "backbone": {"stem_bn": p["backbone"]["stem_bn"]},
           "mega": {"l_u0": p["mega"]["l_u0"], "l_Wv0": p["mega"]["l_Wv0"]}}
    rng = np.random.default_rng(6)
    grads = [jax.tree.map(lambda x, s=s: np.asarray(
        s * rng.standard_normal(x.shape), np.float32), sub)
        for s in (1e-3, 1.0, 1e-4)]
    sched_j = jopt.multistep_schedule(0.01, 2, (2,), 0.1, 0.01 / 3)
    sched_t = topt.multistep_schedule(0.01, 2, (2,), 0.1, 0.01 / 3)
    tx = jopt.detector_sgd(sched_j, sub, weight_decay_bias=1e-3)
    state = tx.init(sub)
    ours = {k: v.clone() for k, v in
            params_from_jax(flatten_params(sub)).items()}
    names = list(ours)
    opt = topt.detector_sgd(sched_t, [(n, ours[n]) for n in names],
                            weight_decay_bias=1e-3)
    want = sub
    norms = []
    for g in grads:
        norms.append(float(optax.global_norm(g)))
        upd, state = tx.update(g, state, want)
        want = optax.apply_updates(want, upd)
        g_t = params_from_jax(flatten_params(g))
        opt.update([ours[n] for n in names], [g_t[n].clone() for n in names])
        got = params_to_jax(ours)
        for k, v in flatten_params(want).items():
            np.testing.assert_allclose(got[k], np.asarray(v), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    assert norms[1] > 10.0 > max(norms[0], norms[2])   # the clip bites once
    # a frozen-BN running_var takes a non-bias update: decayed, lr x 1
    rv = flatten_params(sub)["backbone/stem_bn/running_var"]
    assert not np.allclose(got["backbone/stem_bn/running_var"], rv)


def test_train_step_matches_jax(setup):
    """One step at a batch of 2 against make_detector_train_step with the
    same draws: the mean losses and every parameter."""
    det, params, _, batch = setup
    sched_j = jopt.multistep_schedule(1e-3, 500, (100000,), 0.1, 1e-3 / 3)
    tx = jopt.detector_sgd(sched_j, params)
    step = jdt.make_detector_train_step(det, tx, image_hw=(H, W),
                                        post_nms_top_n=NK)
    rng = jax.random.key(7)
    new, _, losses = step(params, tx.init(params),
                          {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    keys = jax.random.split(rng, B)

    ours = td.MegaDetector(**KW, device=CPU)
    load_params(ours, flatten_params(params["params"]))
    opt = topt.detector_sgd(
        topt.multistep_schedule(1e-3, 500, (100000,), 0.1, 1e-3 / 3),
        ours.named_parameters())
    got = tdt.detector_train_step(
        ours, opt, {k: t(v) for k, v in batch.items()},
        lambda i: port_draw(keys[i]), image_hw=(H, W), post_nms_top_n=NK)
    for k, v in losses.items():
        assert abs(got[k].item() - float(v)) <= LOSS_TOL * (1 + abs(float(v)))
    got_p = params_to_jax(ours.state_dict())
    for k, v in flatten_params(new["params"]).items():
        np.testing.assert_allclose(got_p[k], np.asarray(v), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


# -- initial weights ----------------------------------------------------------

def torchvision_state_dict(det, rng):
    """A torchvision-named ResNet state dict (drawn values) whose C1-C4 and
    C5 match the port detector's backbone and C5 head."""
    sd = {}
    for name, v in det.state_dict().items():
        if name.startswith("backbone.stem."):
            tv = "conv1.weight"
        elif name.startswith("backbone.stem_bn."):
            tv = "bn1." + name.rsplit(".", 1)[1]
        elif name.startswith(("backbone.layer", "box_head.c5.layer")):
            parts = name.split(".")[1:] if name.startswith("backbone") \
                else name.split(".")[2:]
            layer, block, mod = parts[0], parts[1][len("block"):], parts[2]
            if mod == "downsample_conv":
                tv = f"{layer}.{block}.downsample.0.weight"
            elif mod == "downsample_bn":
                tv = f"{layer}.{block}.downsample.1.{parts[-1]}"
            elif mod.startswith("conv"):
                tv = f"{layer}.{block}.{mod}.weight"
            else:
                tv = f"{layer}.{block}.{mod}.{parts[-1]}"
        else:
            continue
        sd[tv] = rng.standard_normal(tuple(v.shape))
    return sd


def test_graft_backbone_matches_jax(setup, tmp_path):
    """A pickle written by the port's convert (float64 leaves) grafts into
    the port as into JAX's tree; nothing outside C1-C5 moves."""
    _, params, _, _ = setup
    ours = td.MegaDetector(**KW, device=CPU)
    load_params(ours, flatten_params(params["params"]))
    sd = torchvision_state_dict(ours, np.random.default_rng(8))
    pkl_path = tmp_path / "r.pkl"
    with open(pkl_path, "wb") as f:
        pickle.dump(convert(sd, layers=(1, 1, 1, 3)), f)
    with open(pkl_path, "rb") as f:
        pkl = pickle.load(f)
    want = flatten_params(jdt.graft_backbone(params, pkl)["params"])
    before = {k: v.copy() for k, v in params_to_jax(ours.state_dict()).items()}
    tdt.graft_backbone(ours, pkl)
    got = params_to_jax(ours.state_dict())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        moved = not np.array_equal(got[k], before[k])
        assert moved == k.startswith(("backbone/", "box_head/c5/")), k
    bad = dict(pkl, c5={"layer4": {}})
    with pytest.raises(ValueError, match="leaves differ"):
        tdt.graft_backbone(ours, bad)


def test_finetune_restores_weights_only(setup, tmp_path):
    """load_finetune_params reads a detector checkpoint's .npz: every
    weight, and nothing of the optimizer or the iteration."""
    _, _, ours, _ = setup
    opt = topt.detector_sgd(lambda s: 0.1, ours.named_parameters())
    opt.count = 7
    path = tdt.save_detector_checkpoint(str(tmp_path), 7, ours, opt,
                                        np.random.default_rng(0))
    assert os.path.exists(path[:-4] + ".state.pt")
    assert tdt.latest_checkpoint(str(tmp_path)) == path
    fresh = td.MegaDetector(**KW, device=CPU,
                            generator=torch.Generator().manual_seed(3))
    fresh_opt = topt.detector_sgd(lambda s: 0.1, fresh.named_parameters())
    tdt.load_finetune_params(fresh, path)
    for (n, a), b in zip(ours.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n
    assert fresh_opt.count == 0 and not fresh_opt.trace
    rng = np.random.default_rng(1)
    assert tdt.restore_detector_checkpoint(path, fresh, fresh_opt, rng) == 7
    assert fresh_opt.count == 7
    assert rng.integers(1 << 30) == np.random.default_rng(0).integers(
        1 << 30)
