"""Sequence and tensor parallelism of the port (``vrdone_tpu_torch/
parallel``: ``mesh.make_layout``, ``collectives``) on a four-process gloo
world on the CPU, held against the JAX package.

One start of four ranks (the module fixture ``world``) runs every
four-rank check: three train steps of ``tests/test_train_step.py::
tiny_cfg`` (T = 48 over a (1, 1, 2) pyramid: 48 / 24 / 12 frames, window
7, drop path on, deep supervision) in each of dp 1 x sp 4 (interior ranks
with both neighbours, 3 frames a rank at the coarsest level), dp 2 x sp 2,
dp 2 x tp 2 and dp 1 x tp 2 x sp 2 (tp_min_size 256, as JAX's own test
sets it), then each collective against its one-process op under dp 1 x
sp 4, value and gradient. In this process the port's one-process step
and the JAX package's ``train_step`` run on the global batch from the same
flax parameters and the same draws.

JAX's sp and tp steps equal its dp step (``tests/test_train_step.py``),
which is one program on the global batch, so every layout's losses are
held to JAX's at JAX's own tolerance there, rtol 2e-4, atol 1e-5, and its
parameters and EMA (tp shards gathered whole) with
``tests/test_torch_parallel.py``'s rule: atol = rtol = 1e-5 on every leaf
whose first gradient is above float noise, the Adam-step bound on the
others. The ranks of a layout agree bit for bit. The collectives are held
to their one-process ops at the single-op tolerance, 1e-5.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_model import REPO, jax_model_and_params, port_config
from tests.test_torch_parallel import (TC, RecordedDraws, assert_leaves_close,
                                       child_env, free_port, jax_steps,
                                       to_jax)
from tests.test_train_step import synth_batch, tiny_cfg
from tools.export_params_npz import flatten_params
from vrdone_tpu.config import ModelConfig as JModelConfig
from vrdone_tpu.config import PredictorConfig as JPredictorConfig
from vrdone_tpu.models.maskvrd import MaskVRD as JMaskVRD
from vrdone_tpu.parallel.mesh import make_mesh, tp_shardings
from vrdone_tpu_torch.config import load_yaml_config, model_config_from_yaml
from vrdone_tpu_torch.convert import flax_key
from vrdone_tpu_torch.models.maskvrd import MaskVRD
from vrdone_tpu_torch.ops import masked as tmasked
from vrdone_tpu_torch.parallel import collectives, mesh
from vrdone_tpu_torch.train.loop import (create_train_state, step_generator,
                                         train_step)

torch.set_num_threads(1)

CPU = torch.device("cpu")
RANKS = 4
STEPS = 3
SEED = 11
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-5   # tests/test_train_step.py's
OP_TOL = 1e-5
# name: (n_dp, n_tp, n_sp, tp_min_size)
LAYOUTS = {"dp1_sp4": (1, 1, 4, 1 << 16), "dp2_sp2": (2, 1, 2, 1 << 16),
           "dp2_tp2": (2, 2, 1, 256), "dp1_tp2_sp2": (1, 2, 2, 256)}

RANK_CODE = r"""
import os, pickle, sys, types
import torch
torch.set_num_threads(1)
from vrdone_tpu_torch.convert import load_npz
from vrdone_tpu_torch.models import losses as LO
from vrdone_tpu_torch.models.backbone import SOSBackbone
from vrdone_tpu_torch.ops import masked as mops
from vrdone_tpu_torch.parallel import collectives, mesh
from vrdone_tpu_torch.train import checkpoint
from vrdone_tpu_torch.train.checkpoint import state_payload
from vrdone_tpu_torch.train.loop import (create_train_state, step_generator,
                                         train_step)

root = sys.argv[1]
rank, world, device = mesh.init_distributed("cpu")
with open(os.path.join(root, "setup.pkl"), "rb") as f:
    cfg, tc, batch, layouts, steps, seed = pickle.load(f)
params = load_npz(os.path.join(root, "params.npz"))
out = {"layouts": {}, "ops": {}}
for name, (n_dp, n_tp, n_sp, tp_min) in layouts.items():
    lay = mesh.make_layout(n_dp, n_tp, n_sp)
    state, _ = create_train_state(cfg, tc, 5, device=device,
                                  flax_params=params, layout=lay,
                                  tp=n_tp > 1, tp_min_size=tp_min)
    rows = mesh.local_batch_slice(batch["feats"].shape[0], lay)
    local = mesh.time_slice({k: torch.from_numpy(v[rows])
                             for k, v in batch.items()}, lay)
    res = {"coords": (lay.dp, lay.tp, lay.sp), "losses": [],
           "shapes": {k: tuple(v.shape) for k, v in local.items()},
           "sharded": sorted(state.tp_dims)}
    for step in range(steps):
        state, losses = train_step(state, local, step_generator(seed, step))
        res["losses"].append({k: v.item() for k, v in losses.items()})
    whole = state_payload(state, epoch=0, batch_size=0)
    res["params"] = {k: v.numpy() for k, v in whole["params"].items()}
    res["ema"] = {k: v.numpy() for k, v in whole["ema_params"].items()}
    out["layouts"][name] = res
    if n_tp > 1:
        # rank 0 writes the whole state; a fresh state of the same layout
        # restores this rank's shards of the parameters, EMA and moments
        path = os.path.join(root, f"{name}.ckpt")
        checkpoint.save_checkpoint(path, state, epoch=0, batch_size=8)
        fresh, _ = create_train_state(cfg, tc, 5, device=device,
                                      flax_params=params, layout=lay,
                                      tp=True, tp_min_size=tp_min)
        fresh, epoch, _ = checkpoint.restore_checkpoint(path, fresh)
        res["restored"] = epoch == 1 and fresh.step == state.step and all(
            torch.equal(a, b) for a, b in zip(
                [*fresh.params(), *fresh.ema_params,
                 *sum(fresh.optimizer.moments.values(), [])],
                [*state.params(), *state.ema_params,
                 *sum(state.optimizer.moments.values(), [])]))

# -- each collective against its one-process op, under dp 1 x sp 4 --------
lay = mesh.make_layout(1, 1, world)


def leaf(x):
    return x.detach().clone().requires_grad_()


def check(name, op, xs, masks=(), params=(), time_axes=None, out_axis=1,
          kind="cols"):
    # op over the global inputs in one process, and over this rank's
    # columns time-sharded: the rank's columns of the output ("cols"), the
    # whole output on every rank ("whole", weighted 1/n_sp in the
    # objective) or the rank's partial sum of it ("partial", summed over
    # the ranks to compare); the gradient of each input's columns, and each
    # parameter's gradient summed over the ranks
    time_axes = time_axes or [1] * (len(xs) + len(masks))
    gen = torch.Generator().manual_seed(7)
    xg = [leaf(x) for x in xs]
    y = op(*xg, *masks)
    g = torch.randn(y.shape, generator=gen, dtype=y.dtype)
    for p in params:
        p.grad = None
    (y * g).sum().backward()
    want_p = [p.grad.clone() for p in params]

    def cols(x, axis):
        t = x.shape[axis] // lay.n_sp
        return x.narrow(axis, lay.sp * t, t)

    xl = [leaf(cols(x, a)) for x, a in zip(xs, time_axes)]
    ml = [cols(m, a) for m, a in zip(masks, time_axes[len(xs):])]
    for p in params:
        p.grad = None
    with collectives.time_sharded(lay):
        yl = op(*xl, *ml)
    if kind == "cols":
        want_y, gl = cols(y, out_axis), cols(g, out_axis)
    else:
        want_y, gl = y, (g / lay.n_sp if kind == "whole" else g)
    (yl * gl).sum().backward()
    if kind == "partial":
        yl = mesh.all_reduce_sum(yl.detach().clone())
    err = {"value": (yl - want_y).abs().max().item(),
           "scale": want_y.abs().max().item()}
    for i, (x, a) in enumerate(zip(xg, time_axes)):
        err[f"grad {i}"] = (xl[i].grad - cols(x.grad, a)).abs().max().item()
    for i, (p, w) in enumerate(zip(params, want_p)):
        got = mesh.all_reduce_sum(p.grad.clone())
        err[f"param grad {i}"] = (got - w).abs().max().item()
    out["ops"][name] = err


gen = torch.Generator().manual_seed(3)
b, t, c, heads = 2, 48, 8, 2
x = torch.randn(b, t, c, generator=gen)
mask = torch.arange(t)[None] < torch.tensor([t, 29])[:, None]
w3 = torch.randn(c, c, 3, generator=gen, requires_grad=True)
wd = torch.randn(c, 1, 3, generator=gen, requires_grad=True)
bias = torch.randn(c, generator=gen, requires_grad=True)
check("conv k3 s1", lambda x, m: mops.masked_conv1d(x, m, w3, bias)[0],
      [x], [mask], [w3, bias])
check("conv k3 s2 depthwise",
      lambda x, m: mops.masked_conv1d(x, m, wd, stride=2, groups=c)[0],
      [x], [mask], [wd])
check("max-pool k3 s2", lambda x: mops.max_pool1d(x, kernel=3, stride=2,
                                                   padding=1), [x])
# a coarsest level of 3 frames a rank: a halo of one shard (window 7), of
# more than one (window 9)
xs = x[:, :12]
ms = mask[:, :12].clone()
ms[1, 7:] = False
pe = torch.randn(heads, 9, generator=gen, requires_grad=True)
for window in (7, 9):
    check(f"band attention window {window} at 3 frames a rank",
          lambda q, k, v, m: mops.band_attention(q, k, v, m, n_head=heads,
                                                 window_size=window),
          [xs, xs.flip(1), xs * 0.5], [ms])
    check(f"band attention window {window} rel_pe at 3 frames a rank",
          lambda q, k, v, m: mops.band_attention(
              q, k, v, m, n_head=heads, window_size=window,
              rel_pe=pe[:, :window]), [xs, xs.flip(1), xs * 0.5], [ms], [pe])
check("band attention window 7 at 12 frames a rank",
      lambda q, k, v, m: mops.band_attention(q, k, v, m, n_head=heads,
                                             window_size=7),
      [x, x.flip(1), x * 0.5], [mask])
check("full attention, keys gathered",
      lambda q, k, v, m: mops.full_attention(q, k, v, m, n_head=heads,
                                             allow_kernel=False),
      [x, x.flip(1), x * 0.5], [mask])

# the time reductions: costs and losses over (..., T) with T last
q = gq = 4
pred = torch.randn(b, q, t, generator=gen) * 3
tgt = (torch.rand(b, gq, t, generator=gen) > 0.6).float()
segs = torch.tensor([[[3, 20], [10, 11], [30, 48], [0, 2]],
                     [[0, 29], [5, 9], [12, 27], [1, 3]]])


axes3 = [2, 2, 1]
check("pairwise focal cost",
      lambda p, g, m: LO.pairwise_focal_cost(p, g, m),
      [pred, tgt], [mask], time_axes=axes3, kind="whole")
check("pairwise dice cost",
      lambda p, g, m: LO.pairwise_dice_cost(p, g, m),
      [pred, tgt], [mask], time_axes=axes3, kind="whole")
flat_m = mask[:, None].expand(b, gq, t).reshape(-1, t)
valid = torch.tensor([True, True, False, True] * 2)
n_masks = torch.tensor(6.0)
# the focal loss is each rank's partial sum, the dice loss whole on each
for name, fn, how in (("matched focal fuzzy loss",
                       LO.matched_focal_fuzzy_loss, "partial"),
                      ("matched dice fuzzy loss",
                       LO.matched_dice_fuzzy_loss, "whole")):
    check(name, lambda p, g, m: fn(p, g, segs.reshape(-1, 2), m, valid,
                                   n_masks, 0.85)[None],
          [pred.reshape(-1, t), tgt.reshape(-1, t)], [flat_m], kind=how)
check("fuzzy_targets",
      lambda g, m: LO.fuzzy_targets(g, segs, m, 0.85),
      [tgt], [mask], time_axes=[2, 1], out_axis=2)
table = torch.randn(t, c, generator=gen)
ns = types.SimpleNamespace(training=True, max_len=t, pos_embd=table)
check("_pe", lambda x: x + SOSBackbone._pe(ns, x.shape[1])[None], [x])

mesh.barrier()
mesh.shutdown()
with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


def start_ranks(root: str) -> list:
    code = os.path.join(root, "rank.py")
    with open(code, "w") as f:
        f.write(RANK_CODE)
    port = str(free_port())
    return [subprocess.Popen(
        [sys.executable, code, root], cwd=REPO,
        env=child_env(RANK=str(r), WORLD_SIZE=str(RANKS), LOCAL_RANK=str(r),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                      PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]


def jax_config(tcfg) -> JModelConfig:
    """The port's configuration in the JAX package's dataclasses (the
    inverse of ``port_config``)."""
    d = dataclasses.asdict(tcfg)
    d["predictor"] = JPredictorConfig(**d["predictor"])
    return JModelConfig(**d)


def port_steps(cfg, params, batch):
    """The port's one-process steps on the global batch, each step's
    draws recorded (what the JAX steps then take)."""
    state, schedule = create_train_state(port_config(cfg), TC, 5,
                                         device=CPU,
                                         flax_params=flatten_params(params))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    draws, losses = [], []
    for step in range(STEPS):
        rec = RecordedDraws(step_generator(SEED, step), 0)
        state, l = train_step(state, tb, rec)
        draws.append(rec.record)
        losses.append({k: v.item() for k, v in l.items()})
        if step == 0:
            first = [m.clone() for m in state.optimizer.moments["mu"]]
    names = [n for n, _ in state.model.named_parameters()]
    return types.SimpleNamespace(
        draws=draws, losses=losses,
        lr_sum=sum(schedule(t) for t in range(STEPS)),
        first_grad={n: 10 * m.numpy() for n, m in zip(names, first)})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sequence_parallel"))
    cfg = tiny_cfg()
    _, params = jax_model_and_params(cfg, seed=1)
    batch = synth_batch(np.random.default_rng(9), cfg)
    np.savez(os.path.join(root, "params.npz"), **flatten_params(params))
    with open(os.path.join(root, "setup.pkl"), "wb") as f:
        pickle.dump((port_config(cfg), TC, batch, LAYOUTS, STEPS, SEED), f)
    ranks = start_ranks(root)
    try:
        one = port_steps(cfg, params, batch)
        ref = jax_steps(cfg, params, batch, one.draws)
    finally:
        outs = [p.communicate(timeout=600)[0] for p in ranks]
    for p, out in zip(ranks, outs):
        assert p.returncode == 0, out[-4000:]
    got = []
    for r in range(RANKS):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return types.SimpleNamespace(root=root, cfg=cfg, batch=batch, ranks=got,
                                 one=one, ref=ref)


# ---------------------------------------------------------------------------
# the layouts' train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_steps_match_jax(world, layout):
    """Three steps of ``layout`` against the JAX package's single-process
    ``train_step`` on the global batch: every loss term at JAX's sp/tp
    tolerance, the whole parameters and EMA by the float-noise-leaf
    rule."""
    ref, one = world.ref, world.one
    assert world.cfg.droppath > 0 and one.draws[0]
    grads = to_jax(one.first_grad)
    for out in world.ranks:
        res = out["layouts"][layout]
        for step in range(STEPS):
            got, want = res["losses"][step], ref.losses[step]
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                           atol=LOSS_ATOL,
                                           err_msg=f"{layout} {k} {step}")
        for kind in ("params", "ema"):
            assert_leaves_close(to_jax(res[kind]), getattr(ref, kind), grads,
                                one.lr_sum, f"{layout} {kind}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_ranks_agree_and_hold_their_part(world, layout):
    """The ranks' coordinates are make_mesh's row-major ones, each holds
    its rows and columns of the global batch, the tp ranks hold shards, and
    all agree bit for bit on the losses and the whole parameters."""
    n_dp, n_tp, n_sp, _ = LAYOUTS[layout]
    b, t = world.batch["feats"].shape[:2]
    outs = [out["layouts"][layout] for out in world.ranks]
    for r, res in enumerate(outs):
        assert res["coords"] == (r // (n_tp * n_sp), (r // n_sp) % n_tp,
                                 r % n_sp)
        assert res["shapes"]["feats"][:2] == (b // n_dp, t // n_sp)
        assert res["shapes"]["gt_masks"][2] == t // n_sp
        assert bool(res["sharded"]) == (n_tp > 1)
        assert res["losses"] == outs[0]["losses"]
        for kind in ("params", "ema"):
            for k, v in res[kind].items():
                np.testing.assert_array_equal(v, outs[0][kind][k])


@pytest.mark.parametrize("layout", ["dp2_tp2", "dp1_tp2_sp2"])
def test_tp_checkpoint_is_whole_and_restores_shards(world, layout):
    """A tensor-parallel run's checkpoint holds the whole parameters (what
    one process's ``MaskVRD`` and ``eval_torch.py`` load), equal to the
    ranks' gathered ones; every rank restores its shards of the
    parameters, EMA and moments bit for bit."""
    from vrdone_tpu_torch.train.checkpoint import restore_params_for_eval
    path = os.path.join(world.root, f"{layout}.ckpt")
    model = MaskVRD(port_config(world.cfg), device=CPU)
    model.load_state_dict(torch.load(path, weights_only=True)["params"],
                          strict=True)
    ema = restore_params_for_eval(path)
    res = world.ranks[0]["layouts"][layout]
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), res["params"][k])
        np.testing.assert_array_equal(ema[k].numpy(), res["ema"][k])
    assert all(out["layouts"][layout]["restored"] for out in world.ranks)


def test_sharded_leaves_are_jax_tp_shardings():
    """``mesh.tp_plan`` shards the leaves JAX's ``tp_shardings`` shards, at
    tp_min_size 256 and at its default 1 << 16, on configs/vidvrd.yaml's
    shapes (JAX's from ``jax.eval_shape``, the port's on the meta
    device)."""
    raw = load_yaml_config(os.path.join(REPO, "configs", "vidvrd.yaml"))
    tcfg = model_config_from_yaml(raw)
    jcfg = jax_config(tcfg)
    t = tcfg.max_seq_len
    c = 2 * tcfg.visual_dim + tcfg.bbox_so_dim + 2 * tcfg.bbox_entity_dim
    shapes = jax.eval_shape(JMaskVRD(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((2, t, c)), jnp.ones((2, t), bool))
    model = MaskVRD(tcfg, device=torch.device("meta"))
    jmesh = make_mesh(n_dp=1, n_tp=2)
    for min_size in (256, 1 << 16):
        specs = flatten_params(jax.tree.map(
            lambda s: "tp" in str(s.spec),
            tp_shardings(jmesh, shapes["params"], min_size)))
        plan = mesh.tp_plan(model, 2, min_size)
        got = {flax_key(n, p) for n, p in model.named_parameters()
               if n in plan}
        want = {k for k, v in specs.items() if v}
        assert got == want and got, (min_size, got ^ want)


def test_time_split_refusal_states_the_rule():
    """A max_seq_len that the shards of the coarsest level do not divide
    refuses with the rule; VidVRD's 96 over (2, 2, 3) takes n_sp 2 and 3."""
    for n_sp in (2, 3):
        mesh.check_time_split(96, n_sp, 2, 3)
    with pytest.raises(ValueError, match="divisible by n_sp x "
                       "scale_factor"):
        mesh.check_time_split(96, 5, 2, 3)
    with pytest.raises(ValueError, match="the world has 1"):
        mesh.make_layout(1, 1, 2)
    assert mesh.make_layout() == mesh.default_layout() == mesh.Layout()


# ---------------------------------------------------------------------------
# the collectives against their one-process ops
# ---------------------------------------------------------------------------

OPS = ["conv k3 s1", "conv k3 s2 depthwise", "max-pool k3 s2",
       "band attention window 7 at 3 frames a rank",
       "band attention window 7 rel_pe at 3 frames a rank",
       "band attention window 9 at 3 frames a rank",
       "band attention window 9 rel_pe at 3 frames a rank",
       "band attention window 7 at 12 frames a rank",
       "full attention, keys gathered", "pairwise focal cost",
       "pairwise dice cost", "matched focal fuzzy loss",
       "matched dice fuzzy loss", "fuzzy_targets", "_pe"]


@pytest.mark.parametrize("op", OPS)
def test_collective_matches_one_process_op(world, op):
    """``op`` under dp 1 x sp 4 on every rank: its columns of the output
    (or the whole output of a time reduction), the gradient of its input
    columns and the parameters' gradients summed over the ranks equal the
    one-process op's within the single-op tolerance."""
    for r, out in enumerate(world.ranks):
        err = out["ops"][op]
        scale = max(1.0, err.pop("scale"))
        for k, v in err.items():
            assert v <= OP_TOL * scale, (op, r, k, v)


def test_step_draws_take_their_time_columns():
    """Under time sharding a dropout draw is the rank's columns of the draw
    at the level's global length (and a drop-path draw its rows), so the
    sp ranks of one dp index draw what one process draws; outside it the
    draws are rows only, as before."""
    x = torch.ones(4, 12, 3)
    whole = (tmasked.drop_path(x, 0.4, True, torch.Generator().manual_seed(2)),
             tmasked.dropout(x, 0.3, True, torch.Generator().manual_seed(2)))
    for sp in range(4):
        draws = [tmasked.StepDraws(torch.Generator().manual_seed(2), 4, 0, 4,
                                   sp) for _ in range(2)]
        part = x[:, 3 * sp:3 * sp + 3]
        with collectives.time_sharded(mesh.Layout(n_sp=4, sp=sp)):
            got = (tmasked.drop_path(part, 0.4, True, draws[0]),
                   tmasked.dropout(part, 0.3, True, draws[1]))
        for g, w in zip(got, whole):
            torch.testing.assert_close(g, w[:, 3 * sp:3 * sp + 3], rtol=0,
                                       atol=0)
    untouched = tmasked.StepDraws(torch.Generator().manual_seed(2), 4, 0, 4, 1)
    torch.testing.assert_close(tmasked.dropout(x, 0.3, True, untouched),
                               whole[1], rtol=0, atol=0)
