"""The port's training path against the JAX package's, on the CPU: band
attention gradients, drop path, the matcher, every loss, the optimizer and
EMA, the batch packer and loader, and a 3-step train trajectory.

Tolerances (fp32 on both sides, JAX at "highest" matmul precision):
  * 1e-5 for single ops (band attention and its gradients, losses): sums of
    a few hundred products taken in another order;
  * exact for drop path, the matcher's assignments and the batches;
  * 1e-6 relative for the schedule and three optimizer updates;
  * 2e-4 on the per-step losses and 2e-3 relative parameter drift for the
    3-step trajectory, the whole model's error (5e-4 on its outputs,
    tests/test_torch_model.py) carried through Adam's normalised updates.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.synth_corpus import make_vidvrd_corpus
from tests.test_torch_model import jax_model_and_params, port_config
from tests.test_train_trajectory import _deterministic_cfg, _make_batch
from tools.export_params_npz import flatten_params
from vrdone_tpu.data import batching as jbatching
from vrdone_tpu.data.datasets import VidVRDDataset as JVidVRDDataset
from vrdone_tpu.data.loader import TrainLoader as JTrainLoader
from vrdone_tpu.models import losses as jlosses
from vrdone_tpu.models.maskvrd import compute_losses as jcompute_losses
from vrdone_tpu.ops import hungarian as jhung
from vrdone_tpu.ops import masked as jmasked
from vrdone_tpu.ops.pallas.band_attention import band_attention_pallas
from vrdone_tpu.train import optim as jopt
from vrdone_tpu.train.loop import TrainState as JTrainState
from vrdone_tpu.train.loop import train_step as jtrain_step
from vrdone_tpu_torch.convert import params_from_jax, params_to_jax
from vrdone_tpu_torch.data import batching as tbatching
from vrdone_tpu_torch.data.datasets import VidVRDDataset as TVidVRDDataset
from vrdone_tpu_torch.data.loader import TrainLoader as TTrainLoader
from vrdone_tpu_torch.models import losses as tlosses
from vrdone_tpu_torch.models.maskvrd import compute_losses as tcompute_losses
from vrdone_tpu_torch.ops import hungarian as thung
from vrdone_tpu_torch.ops import masked as tmasked
from vrdone_tpu_torch.ops.band_attention import band_attention_plain
from vrdone_tpu_torch.train import optim as topt
from vrdone_tpu_torch.train.loop import create_train_state, train_step

torch.set_num_threads(1)

CPU = torch.device("cpu")


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# band attention gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [1, 3, 4])
def test_band_attention_grads_match_jax(w):
    """The port's plain band attention, forward and gradients of a
    random-weighted sum, against the Pallas kernel's own custom VJP
    (interpret mode) and autodiff through the dense JAX form. T = 64 is two
    Pallas blocks of 32; partial masks leave invalid keys in valid bands
    and whole invalid rows."""
    rng = np.random.default_rng(w)
    b, h, d, t_len, block = 2, 2, 16, 64, 32
    q, k, v = (rng.standard_normal((b, t_len, h * d)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(t_len)[None] < np.array([[t_len], [41]])
    mask[0, 17] = False
    wt = rng.standard_normal((b, t_len, h * d)).astype(np.float32)
    win = 2 * w + 1

    def jloss(fn):
        return lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_) * wt)

    pallas = functools.partial(band_attention_pallas, kv_mask=jnp.asarray(mask),
                               n_head=h, window_size=win, block=block,
                               interpret=True)
    dense = functools.partial(jmasked.band_attention,
                              kv_mask=jnp.asarray(mask), n_head=h,
                              window_size=win)

    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = band_attention_plain(tq, tk, tv, t(mask), n_head=h,
                               window_size=win)
    grads = torch.autograd.grad((out * t(wt)).sum(), (tq, tk, tv))
    for fn in (pallas, dense):
        jout = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   atol=1e-5, rtol=1e-5)
        jgrads = jax.grad(jloss(fn), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        for g, jg in zip(grads, jgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5,
                                       rtol=1e-5)
    # an invalid query row passes no gradient back, whatever its upstream
    assert (grads[0][1, 41:] == 0).all()


# ---------------------------------------------------------------------------
# drop path and dropout
# ---------------------------------------------------------------------------

def test_drop_path_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 5, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jmasked.drop_path(jnp.asarray(x), key, 0.3, deterministic=False)
    u = jax.random.uniform(key, (64, 1, 1), dtype=jnp.float32)
    got = tmasked.drop_path_with(t(x), t(u).reshape(64), 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_drop_path_and_dropout_rates():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(20000, 2)
    kept = tmasked.drop_path(x, 0.3, True, gen)[:, 0] != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    assert torch.allclose(tmasked.drop_path(x, 0.3, True, gen)[kept.nonzero()
                          [:1, 0]], torch.full((1, 2), 1 / 0.7))
    assert tmasked.drop_path(x, 0.3, False, gen) is x
    kept = tmasked.dropout(x, 0.2, True, gen) != 0
    assert abs(kept.float().mean().item() - 0.8) < 0.02
    with pytest.raises(ValueError, match="Generator"):
        tmasked.drop_path(x, 0.3, True, None)


# ---------------------------------------------------------------------------
# the matcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 5, 9, 12])
def test_subset_dp_matches_jax(g):
    """Same cost, same row_for_col, bit for bit: random costs, invalid
    columns, and integer costs with exact ties."""
    rng = np.random.default_rng(g)
    q, n = max(g, 9), 6
    cost = rng.standard_normal((n, q, g)).astype(np.float32)
    cost[3:] = rng.integers(0, 3, (n - 3, q, g)).astype(np.float32)
    valid = rng.random((n, g)) < 0.7
    valid[:, 0] = True
    jr, jm = jhung.batched_match(jnp.asarray(cost), jnp.asarray(valid))
    tr, tm = thung.match_padded(t(cost), t(valid))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_hungarian_fallback_cost_matches_jax():
    """Above 12 columns both run the augmenting-path Hungarian; ties may
    resolve differently, so compare the assignment's cost."""
    rng = np.random.default_rng(14)
    n, q, g = 3, 16, 14
    cost = rng.standard_normal((n, q, g)).astype(np.float32)
    valid = np.ones((n, g), bool)
    valid[1, 10:] = False
    jr, _ = jhung.batched_match(jnp.asarray(cost), jnp.asarray(valid))
    tr, _ = thung.match_padded(t(cost), t(valid))
    jr, tr = np.asarray(jr), tr.numpy()
    for b in range(n):
        cols = np.nonzero(valid[b])[0]
        assert len(set(tr[b])) == g
        np.testing.assert_allclose(cost[b, tr[b, cols], cols].sum(),
                                   cost[b, jr[b, cols], cols].sum(),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_inputs(seed=0, b=3, q=5, g=4, tl=20, k=7):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, q, k + 1)).astype(np.float32)
    masks = (2 * rng.standard_normal((b, q, tl))).astype(np.float32)
    labels = rng.integers(1, k + 1, (b, g)).astype(np.int32)
    segs = np.zeros((b, g, 2), np.int32)
    gmasks = np.zeros((b, g, tl), np.float32)
    valid = rng.random((b, g)) < 0.7
    valid[:, 0] = True
    lens = np.array([tl, 13, 7][:b])
    for i in range(b):
        for j in range(g):
            s = int(rng.integers(0, lens[i] - 2))
            e = int(rng.integers(s + 2, lens[i] + 1))
            if valid[i, j]:
                segs[i, j] = [s, e]
                gmasks[i, j, s:e] = 1
    seq = np.arange(tl)[None] < lens[:, None]
    return logits, masks, labels, gmasks, segs, valid, seq


def test_pairwise_and_matching_costs_match_jax():
    logits, masks, labels, gmasks, segs, valid, seq = _loss_inputs()
    for i in range(logits.shape[0]):
        args = (logits[i], masks[i], labels[i], gmasks[i], segs[i], valid[i],
                seq[i])
        tgt = jlosses.fuzzy_targets(gmasks[i], segs[i], seq[i], 0.85)
        pairs = [
            (jlosses.fuzzy_targets(gmasks[i], segs[i], seq[i], 0.85),
             tlosses.fuzzy_targets(t(gmasks[i]), t(segs[i]), t(seq[i]),
                                   0.85)),
            (jlosses.pairwise_class_cost(logits[i], labels[i]),
             tlosses.pairwise_class_cost(t(logits[i]), t(labels[i]))),
            (jlosses.pairwise_focal_cost(masks[i], tgt, seq[i]),
             tlosses.pairwise_focal_cost(t(masks[i]), t(tgt), t(seq[i]))),
            (jlosses.pairwise_dice_cost(masks[i], tgt, seq[i]),
             tlosses.pairwise_dice_cost(t(masks[i]), t(tgt), t(seq[i]))),
        ]
        for sr in (None, 0.85):
            kw = dict(cost_class=1.0, cost_mask=5.0, cost_dice=5.0,
                      scale_range=sr)
            pairs.append((jlosses.matching_cost(*args, **kw),
                          tlosses.matching_cost(*(t(a) for a in args), **kw)))
        for want, got in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)


def test_matched_losses_match_jax():
    logits, masks, labels, gmasks, segs, valid, seq = _loss_inputs(1)
    n, tl = masks.shape[0] * masks.shape[1], masks.shape[-1]
    pred = masks[:, :4].reshape(-1, tl)
    tgt = gmasks.reshape(-1, tl)
    sg = segs.reshape(-1, 2)
    lm = np.repeat(seq, 4, axis=0)
    pv = valid.reshape(-1)
    nm = np.float32(pv.sum())
    target = np.where(np.random.default_rng(2).random((3, 5)) < 0.5, 0,
                      np.random.default_rng(3).integers(1, 8, (3, 5)))
    pairs = [
        (jlosses.classification_loss(logits, target, 0.1),
         tlosses.classification_loss(t(logits), t(target), 0.1)),
        (jlosses.matched_focal_loss(pred, tgt, lm, pv, nm),
         tlosses.matched_focal_loss(t(pred), t(tgt), t(lm), t(pv), t(nm))),
        (jlosses.matched_dice_loss(pred, tgt, lm, pv, nm),
         tlosses.matched_dice_loss(t(pred), t(tgt), t(lm), t(pv), t(nm))),
        (jlosses.matched_focal_fuzzy_loss(pred, tgt, sg, lm, pv, nm, 0.85),
         tlosses.matched_focal_fuzzy_loss(t(pred), t(tgt), t(sg), t(lm),
                                          t(pv), t(nm), 0.85)),
        (jlosses.matched_dice_fuzzy_loss(pred, tgt, sg, lm, pv, nm, 0.85),
         tlosses.matched_dice_fuzzy_loss(t(pred), t(tgt), t(sg), t(lm),
                                         t(pv), t(nm), 0.85)),
    ]
    assert n == 15
    for want, got in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("fuzzy", [False, True])
def test_compute_losses_matches_jax(fuzzy):
    """Deep supervision (two auxiliary levels), padded items and invalid
    columns: every loss term and the total, under the same names."""
    cfg = _deterministic_cfg()
    cfg = dataclasses.replace(cfg, with_fuzzy=fuzzy,
                              scale_range=0.85 if fuzzy else None)
    logits, masks, labels, gmasks, segs, valid, seq = _loss_inputs(
        4, b=3, q=5, g=5, tl=20, k=cfg.num_classes)
    rng = np.random.default_rng(5)
    preds = {"pred_logits": logits, "pred_masks": masks, "aux_outputs": [
        {"pred_logits": rng.standard_normal(logits.shape).astype(np.float32),
         "pred_masks": rng.standard_normal(masks.shape).astype(np.float32)}
        for _ in range(2)]}
    gt = {"seq_mask": seq, "item_valid": np.array([True, True, False]),
          "gt_labels": labels, "gt_masks": gmasks, "gt_segs": segs,
          "gt_valid": valid}
    want = jcompute_losses(cfg, jax.tree.map(jnp.asarray, preds),
                           jax.tree.map(jnp.asarray, gt))
    got = tcompute_losses(port_config(cfg), {
        "pred_logits": t(logits), "pred_masks": t(masks),
        "aux_outputs": [{k: t(v) for k, v in a.items()}
                        for a in preds["aux_outputs"]]},
        {k: t(v) for k, v in gt.items()})
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# optimizer and EMA
# ---------------------------------------------------------------------------

TC = {"type": "AdamW", "training_lr": 1e-3, "weight_decay": 0.05,
      "clip_grad_l2norm": 1.0, "warmup": True, "warmup_epochs": 1,
      "total_epoch": 2, "schedule_type": "cosine"}


@pytest.mark.parametrize("over", [{}, {"schedule_type": "multistep",
                                       "schedule_steps": [1],
                                       "schedule_gamma": 0.5},
                                  {"warmup": False}])
def test_schedule_matches_jax(over):
    tc = {**TC, **over}
    tree = {"a": {"kernel": jnp.zeros((2, 2))}}
    _, jsched = jopt.build_optimizer(tree, tc, 5)
    _, tsched = topt.build_optimizer([], tc, 5)
    for step in range(13):
        np.testing.assert_allclose(tsched(step), float(jsched(step)),
                                   rtol=1e-6, atol=1e-12)
    if over.get("warmup", True):
        assert tsched(0) == 0.0


def test_optimizer_update_matches_optax():
    """Three updates of a small tree against optax: decay only on kernel
    leaves (never on a LayerNorm ``weight``), and a clip that triggers."""
    rng = np.random.default_rng(0)
    flat = {"blk/query/kernel": rng.standard_normal((3, 4)),
            "blk/query/bias": rng.standard_normal(4),
            "blk/ln/weight": rng.standard_normal(4),
            "blk/conv/kernel": rng.standard_normal((3, 2, 4)),
            "mlp/layers_0_kernel": rng.standard_normal((1, 3, 4)),
            "query_embed": rng.standard_normal((5, 4))}
    flat = {k: v.astype(np.float32) for k, v in flat.items()}
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    tx, _ = jopt.build_optimizer(tree, TC, 2)
    jstate = tx.init(tree)
    tparams = params_from_jax(flat)
    names = list(tparams)
    opt, _ = topt.build_optimizer(tparams.items(), TC, 2)
    assert dict(zip(names, opt.decay)) == {
        "blk.query.weight": True, "blk.query.bias": False,
        "blk.ln.weight": False, "blk.conv.weight": True,
        "mlp.layers_0_kernel": True, "query_embed": False}
    jtree = tree
    tlist = [tparams[n].clone() for n in names]
    for step in range(3):
        gflat = {k: (3.0 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in flat.items()}
        gtree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jtree),
            [jnp.asarray(gflat[k]) for k in _flat_keys(jtree)])
        updates, jstate = tx.update(gtree, jstate, jtree)
        jtree = optax.apply_updates(jtree, updates)
        tgrads = params_from_jax(gflat)
        opt.update(tlist, [tgrads[n].clone() for n in names])
    got = params_to_jax(dict(zip(names, tlist)))
    want = dict(zip(_flat_keys(jtree), jax.tree.leaves(jtree)))
    for k in flat:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def _flat_keys(tree):
    return ["/".join(p.key for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_ema_update_matches_jax():
    rng = np.random.default_rng(1)
    e, p = (rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2))
    want = jopt.ema_update({"x": jnp.asarray(e)}, {"x": jnp.asarray(p)},
                           0.99)["x"]
    got = [t(e).clone()]
    topt.ema_update(got, [t(p)], 0.99)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEPS = 3


def test_three_step_trajectory_matches_jax():
    """The JAX ``train_step`` under ``jax.jit`` against the port's, from the
    same converted weights on the same batch (drop path 0): every loss term
    per step, then the parameters and EMA after three steps, skipping the
    leaves whose gradient is at float-noise level (key biases: softmax is
    invariant to them; see tests/test_train_trajectory.py::_max_rel_drift).
    """
    cfg = _deterministic_cfg()
    tc = {**TC, "ema_decay": 0.9}
    _, params = jax_model_and_params(cfg, seed=1)
    _, jbatch = _make_batch(cfg, seed=1)
    nbatch = {k: np.asarray(v) for k, v in jbatch.items()}

    tx, _ = jopt.build_optimizer(params, tc, 5)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         ema_params=jax.tree.map(jnp.copy, params),
                         opt_state=tx.init(params), tx=tx, ema_decay=0.9)
    step_fn = jax.jit(functools.partial(jtrain_step, cfg=cfg))
    tstate, _ = create_train_state(port_config(cfg), tc, 5, device=CPU,
                                   flax_params=flatten_params(params))
    tbatch = {k: t(v) for k, v in nbatch.items()}
    grads_seen = {}
    for step in range(STEPS):
        jstate, jl = step_fn(jstate, jbatch, jax.random.key(0))
        tstate, tl = train_step(tstate, tbatch, None)
        assert set(tl) == set(jl)
        for k in jl:
            np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=2e-4,
                                       atol=2e-4, err_msg=f"{k} step {step}")
        if step == 0:
            # moments after the lr-0 first update are the first gradients
            names = [n for n, _ in tstate.model.named_parameters()]
            grads_seen = params_to_jax(dict(zip(
                names, tstate.optimizer.moments["mu"])))
    assert tstate.step == STEPS
    names = [n for n, _ in tstate.model.named_parameters()]
    for got_list, want_tree in ((tstate.params(), jstate.params),
                                (tstate.ema_params, jstate.ema_params)):
        got = params_to_jax(dict(zip(names, got_list)))
        want = flatten_params(want_tree)
        assert got.keys() == want.keys()
        worst = 0.0
        for k, w in want.items():
            if np.abs(grads_seen[k]).max() < 1e-9:
                continue
            rel = np.abs(got[k] - w).max() / (np.abs(w).max() + 1e-6)
            worst = max(worst, rel)
        assert worst < 2e-3, worst


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def _pairs(rng, n, t_max, c, g_max):
    pairs = []
    for _ in range(n):
        tl = int(rng.integers(3, t_max + 1))
        ng = int(rng.integers(1, g_max + 3))
        segs = np.sort(rng.integers(0, tl, (ng, 2)), axis=1)
        segs[:, 1] += 1
        masks = np.zeros((ng, t_max), np.float32)
        for j, (s, e) in enumerate(segs):
            masks[j, s:e] = 1
        pairs.append({"so_feat": rng.standard_normal((tl, c))
                      .astype(np.float32),
                      "preds": rng.integers(1, 9, ng), "segs": segs,
                      "masks": masks})
    return pairs


def test_pack_train_batch_matches_jax():
    rng = np.random.default_rng(0)
    for n in (0, 3, 8):
        pairs = _pairs(rng, n, 12, 5, 4)
        want = jbatching.pack_train_batch(pairs, 6, 12, 4, 5)
        got = tbatching.pack_train_batch(pairs, 6, 12, 4, 5)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_train_loader_matches_jax(tmp_path):
    """Both loaders over the same synthetic corpus: the same batches in
    the same order for two epochs."""
    root = str(tmp_path)
    dirs = make_vidvrd_corpus(root, n_videos=4, n_frames=40, seed=0)
    config = {"ann_dir": dirs["ann_dir"], "info_dir": f"{root}/info",
              "gt_boxfeatures_dir": dirs["gt_boxfeatures_dir"],
              "test_boxfeatures_dir": dirs["gt_boxfeatures_dir"],
              "cache_dir": f"{root}/cache", "cache_tag": "T",
              "feat_stride": 1, "max_seq_len": 48, "split": "train",
              "cut_max_preds": True, "proposal_max_preds": 9,
              "num_pairs": 2}
    fdim = 2 * 8 + 5 + 16
    jl = JTrainLoader(JVidVRDDataset(dict(config)), 2, 4, 48, 9, fdim,
                      seed=3)
    tl = TTrainLoader(TVidVRDDataset(dict(config)), 2, 4, 48, 9, fdim,
                      seed=3)
    assert tl.steps_per_epoch() == jl.steps_per_epoch() > 0
    for epoch in range(2):
        jb, tb = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(jb) == len(tb) == jl.steps_per_epoch()
        for a, b in zip(jb, tb):
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
