"""bf16 training and remat of the relation model's train step: the port
against the JAX package on the CPU.

Tolerances (the measurements quoted print with
``python -m tests.test_torch_bf16_train``):
- ``PALLAS_TOL`` (1.6e-2 of max |ref|, ``tests/test_torch_bf16.py``) for
  ``band_backward_plain`` on bf16 streams against the VJP of the Pallas
  kernel in interpret mode: the same promotions (P and dS in fp32, each
  gradient rounded to bf16 once), the scale applied at another place
  (measured: 3.6e-3 to 8.0e-3 on dQ and dK, dV bit for bit). On fp32
  streams 1e-5, the limit the backward kernels are held to against
  autograd of the plain version.
- the matchings of one bf16 forward: JAX's, or where bf16 flips a
  near-tie, an assignment whose cost under JAX's cost matrix is within
  ``MATCH_TIE_TOL`` 1e-2 of JAX's optimum: the two frameworks' bf16 costs
  of one assignment lie up to 8.9e-3 apart, so closer assignments are
  ties at bf16's resolution. Here two of the nine (level, item) matchings
  flip, the worst 3.0e-4 above JAX's optimum.
- 5e-2 relative on each loss term of one bf16 step, the bound of JAX's own
  ``tests/test_train_step.py::test_bf16_train_step`` (measured 1.6e-2;
  the bf16-vs-fp32 gap is 9.5e-3 in JAX, 2.1e-2 in the port).
- the step's first gradients (the AdamW first moments): ``BF16_GRAD_NORM``
  0.15 for |dg| / |g| over the whole model, and ``BF16_GRAD_LEAF`` 0.5 of
  the leaf's max for each leaf above 3% of the model's largest gradient
  (measured 7.6e-2 and 0.29). Each framework's own bf16-vs-fp32 gap is as
  large (JAX 8.3e-2 by norm and 0.19 on those leaves, the port 6.7e-2 and
  0.31): bf16 rounds at other places in the two, so their bf16 gradients
  differ by about as much as each differs from fp32. The smaller leaves,
  cancelling sums such as the attention's key and query projections,
  carry bf16 noise up to 0.88 of their max between the frameworks (0.89
  between the port's bf16 and fp32), so they are skipped, as
  ``tests/test_torch_train.py`` skips the fp32 noise-level leaves.
- remat against the plain step: bit for bit (the recompute runs the same
  CPU ops on the same values, and draws the same masks); against JAX's
  remat step, the fp32 trajectory test's 2e-4 on the losses.
"""

import dataclasses
import functools

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_bf16 import PALLAS_TOL, rel_err
from tests.test_torch_model import jax_model_and_params, port_config
from tests.test_torch_train import TC
from tests.test_train_trajectory import _deterministic_cfg, _make_batch
from tests.test_model_parity import small_cfg
from tools.export_params_npz import flatten_params
from vrdone_tpu.models import losses as jlosses
from vrdone_tpu.models.maskvrd import _match as jmatch
from vrdone_tpu.ops import masked as jmasked
from vrdone_tpu.ops.pallas.band_attention import band_attention_pallas
from vrdone_tpu.train import optim as jopt
from vrdone_tpu.train.loop import TrainState as JTrainState
from vrdone_tpu.train.loop import train_step as jtrain_step
from vrdone_tpu.utils.precision import cast_floating as jax_cast_floating
from vrdone_tpu_torch.convert import params_to_jax
from vrdone_tpu_torch.models.maskvrd import match
from vrdone_tpu_torch.ops import masked as tmasked
from vrdone_tpu_torch.ops.band_attention import (band_attention_plain,
                                                 band_backward_plain,
                                                 band_lse_plain, band_rowsum)
from vrdone_tpu_torch.train.loop import (create_train_state, step_generator,
                                         train_step)
from vrdone_tpu_torch.utils.precision import cast_floating

torch.set_num_threads(1)

CPU = torch.device("cpu")
BF16_LOSS_TOL = 5e-2
BF16_GRAD_NORM = 0.15
BF16_GRAD_LEAF = 0.5
MATCH_TIE_TOL = 1e-2
TC1 = {**TC, "ema_decay": 0.9}


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the band backward's plain version, and Dr
# ---------------------------------------------------------------------------

def band_case(w, seed):
    """T = 64 in two Pallas blocks of 32; partial masks leave invalid keys
    in valid bands and whole invalid rows (as
    tests/test_torch_train.py::test_band_attention_grads_match_jax). The
    streams and the upstream gradient hold bf16 values, as fp32 arrays."""
    rng = np.random.default_rng(seed)
    b, h, d, t_len = 2, 2, 16, 64
    q, k, v, dout = (rng.standard_normal((b, t_len, h * d)).astype(np.float32)
                     for _ in range(4))
    q, k, v, dout = (np.asarray(jnp.asarray(x, jnp.bfloat16)
                                .astype(jnp.float32)) for x in (q, k, v, dout))
    mask = np.arange(t_len)[None] < np.array([[t_len], [41]])
    mask[0, 17] = False
    return q, k, v, dout, mask, dict(n_head=h, window_size=2 * w + 1)


def plain_backward(q, k, v, dout, mask, kw):
    """``band_backward_plain`` from the plain forward's lse and Dr."""
    out = band_attention_plain(q, k, v, mask, **kw)
    return band_backward_plain(q, k, v, mask, band_lse_plain(q, k, mask, **kw),
                               band_rowsum(dout, out, kw["n_head"]), dout,
                               **kw)


@pytest.mark.parametrize("w", [1, 3, 4])
def test_band_backward_plain_matches_pallas_vjp(w):
    """On bf16 streams ``band_backward_plain`` against ``jax.vjp`` of the
    Pallas kernel (interpret mode, its own custom VJP: _dq_kernel and
    _dkv_kernel) on the same streams, each gradient bf16 and within
    PALLAS_TOL; on fp32 streams it is autograd of ``band_attention_plain``
    within 1e-5. An invalid query row gets dQ = 0 from any upstream."""
    q, k, v, dout, mask, kw = band_case(w, seed=10 + w)
    tm = t(mask)
    got = plain_backward(*(t(x).to(torch.bfloat16) for x in (q, k, v, dout)),
                         tm, kw)
    jq, jk, jv, jdout = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, dout))
    _, pullback = jax.vjp(functools.partial(
        band_attention_pallas, kv_mask=jnp.asarray(mask), block=32,
        interpret=True, **kw), jq, jk, jv)
    for name, g, jg in zip("qkv", got, pullback(jdout)):
        assert g.dtype == torch.bfloat16 and jg.dtype == jnp.bfloat16, name
        assert rel_err(g, jg) < PALLAS_TOL, (name, rel_err(g, jg))
    assert (got[0][~tm] == 0).all()

    leaves = [t(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(band_attention_plain(*leaves, tm, **kw),
                               leaves, t(dout))
    got = plain_backward(t(q), t(k), t(v), t(dout), tm, kw)
    for g, r in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_band_rowsum_widens_bf16_to_fp32():
    """Dr of bf16 streams is JAX's: the fp32 sum of the products of dO and
    O widened to fp32 (``band_attention.py:251-252``), (B, H, T) fp32."""
    q, k, v, dout, mask, kw = band_case(3, seed=2)
    h = kw["n_head"]
    out = band_attention_plain(*(t(x).to(torch.bfloat16) for x in (q, k, v)),
                               t(mask), **kw)
    got = band_rowsum(t(dout).to(torch.bfloat16), out, h)
    b, tl, c = out.shape
    jo = jnp.asarray(out.float().numpy(), jnp.bfloat16)
    jdo = jnp.asarray(dout, jnp.bfloat16)
    want = jnp.sum((jdo.astype(jnp.float32) * jo.astype(jnp.float32))
                   .reshape(b, tl, h, c // h), axis=-1).transpose(0, 2, 1)
    assert got.dtype == torch.float32 and got.shape == (b, h, tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the bf16 draws
# ---------------------------------------------------------------------------

def test_bf16_draws_lie_below_one_and_keep_jax_share():
    """bf16 drop-path uniforms are JAX's: multiples of 2^-7 in [0, 1), all
    128 of them drawn, never 1.0 (a rounded fp32 draw above 1 - 2^-9
    would be); the shares drop path and dropout keep on bf16 inputs equal
    JAX's within four binomial standard deviations of their difference.
    Dropout draws fp32 uniforms on bf16 inputs, as flax's does."""
    gen = torch.Generator().manual_seed(0)
    like = torch.zeros(1, dtype=torch.bfloat16)
    u = tmasked._uniform((1 << 20,), gen, like).float()
    ju = np.asarray(jax.random.uniform(jax.random.key(0), (1 << 20,),
                                       jnp.bfloat16), np.float32)
    assert u.max() < 1.0 and ju.max() < 1.0 and u.min() >= 0.0
    np.testing.assert_array_equal(np.unique(u.numpy()), np.unique(ju))
    assert len(np.unique(ju)) == 128

    n, p = 200_000, 0.3
    ones = torch.ones(n, 1, dtype=torch.bfloat16)
    got = (tmasked.drop_path(ones, p, True, gen) != 0).float().mean().item()
    want = float((jmasked.drop_path(jnp.ones((n, 1), jnp.bfloat16),
                                    jax.random.key(1), p, False) != 0)
                 .mean())
    spread = 4 * np.sqrt(2 * want * (1 - want) / n)
    assert abs(got - want) < spread, (got, want)

    x = tmasked.dropout(ones, p, True, gen)
    assert x.dtype == torch.bfloat16
    got = (x != 0).float().mean().item()
    jx = fnn.Dropout(p).apply({}, jnp.ones((n, 1), jnp.bfloat16),
                              deterministic=False,
                              rngs={"dropout": jax.random.key(2)})
    want = float((jx != 0).mean())
    assert abs(got - want) < 4 * np.sqrt(2 * want * (1 - want) / n), \
        (got, want)


# ---------------------------------------------------------------------------
# the train step in bf16, and remat
# ---------------------------------------------------------------------------

def jax_step(cfg, params, jbatch):
    """One JAX ``train_step`` under ``jax.jit`` from ``params``: the losses
    as floats and the new state."""
    tx, _ = jopt.build_optimizer(params, TC1, 5)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        ema_params=jax.tree.map(jnp.copy, params),
                        opt_state=tx.init(params), tx=tx, ema_decay=0.9)
    state, losses = jax.jit(functools.partial(jtrain_step, cfg=cfg))(
        state, jbatch, jax.random.key(0))
    return state, {k: float(v) for k, v in losses.items()}


def first_moments(opt_state) -> dict:
    """The AdamW first moments of an optax state, by flattened name."""
    mu = next(s.mu for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    return {k: np.asarray(v) for k, v in flatten_params(mu).items()}


def bf16_matchings(cfg, jm, params, jbatch, model) -> list:
    """The matchings of one bf16 training-mode forward of the port's
    ``model`` and of JAX's on the same weights and batch, for every
    (level, item): whether they differ, how far the port's assignment
    costs above JAX's optimum under JAX's cost matrix, and how far the two
    frameworks' costs of JAX's assignment lie apart, each over JAX's
    optimal cost."""
    tbatch = {k: t(v) for k, v in jbatch.items()}
    with torch.no_grad():
        preds = cast_floating(model).train()(
            tbatch["feats"].to(torch.bfloat16), tbatch["seq_mask"])
    levels = [preds, *preds["aux_outputs"]]
    rows, valid = match(port_config(cfg),
                        torch.stack([p["pred_logits"] for p in levels]),
                        torch.stack([p["pred_masks"] for p in levels]),
                        tbatch)
    jpreds = jax.jit(lambda p, x, m: jm.apply(
        {"params": jax_cast_floating(p)}, x.astype(jnp.bfloat16), m,
        deterministic=False))(params, jbatch["feats"], jbatch["seq_mask"])
    jlevels = [jpreds, *jpreds["aux_outputs"]]
    assert len(jlevels) == len(levels) == 3
    gt = {k: jnp.asarray(v) for k, v in jbatch.items()}
    kw = dict(cost_class=cfg.cost_class, cost_mask=cfg.cost_mask,
              cost_dice=cfg.cost_dice, scale_range=cfg.scale_range)

    def cost(logits, masks, b, cols):
        return np.asarray(jlosses.matching_cost(
            logits[b], masks[b], gt["gt_labels"][b], gt["gt_masks"][b],
            gt["gt_segs"][b], gt["gt_valid"][b], gt["seq_mask"][b],
            **kw))[:, cols]

    out = []
    for i, (tp, jp) in enumerate(zip(levels, jlevels)):
        jlogits, jmasks = (jp[k].astype(jnp.float32)
                           for k in ("pred_logits", "pred_masks"))
        jrows = np.asarray(jmatch(cfg, jlogits, jmasks, gt)[0])
        for b, cols in enumerate(valid.numpy()):
            mine, theirs = rows[i, b].numpy()[cols], jrows[b][cols]
            idx = np.arange(cols.sum())
            jcost = cost(jlogits, jmasks, b, cols)
            tcost = cost(jnp.asarray(tp["pred_logits"].numpy()),
                         jnp.asarray(tp["pred_masks"].numpy()), b, cols)
            best = jcost[theirs, idx].sum()
            out.append(dict(
                level=i, item=b, flipped=not np.array_equal(mine, theirs),
                gap=(jcost[mine, idx].sum() - best) / abs(best),
                cost_gap=abs(tcost[theirs, idx].sum() - best) / abs(best)))
    return out


def test_bf16_train_step_matches_jax():
    """One bf16 step of a tiny config (drop path 0) from the same converted
    weights on the same batch as JAX's ``train_step`` with
    ``compute_dtype="bfloat16"``: the same matchings at every level, or a
    near-tie within MATCH_TIE_TOL, every loss term within 5e-2, the first
    gradients within BF16_GRAD_NORM and BF16_GRAD_LEAF, and the masters,
    moments and EMA fp32."""
    cfg = dataclasses.replace(_deterministic_cfg(), compute_dtype="bfloat16")
    jm, params = jax_model_and_params(cfg, seed=1)
    _, jbatch = _make_batch(cfg, seed=1)
    tbatch = {k: t(v) for k, v in jbatch.items()}
    tstate, _ = create_train_state(port_config(cfg), TC1, 5, device=CPU,
                                   flax_params=flatten_params(params))
    # the matchings of the step's forward, on the weights it starts from
    for m in bf16_matchings(cfg, jm, params, jbatch, tstate.model):
        assert not m["flipped"] or m["gap"] <= MATCH_TIE_TOL, m

    jstate, jl = jax_step(cfg, params, jbatch)
    tstate, tl = train_step(tstate, tbatch, None)
    assert set(tl) == set(jl)
    for k in jl:
        assert abs(tl[k].item() - jl[k]) <= BF16_LOSS_TOL * abs(jl[k]), \
            (k, tl[k].item(), jl[k])

    names = [n for n, _ in tstate.model.named_parameters()]
    got = params_to_jax(dict(zip(names, tstate.optimizer.moments["mu"])))
    want = first_moments(jstate.opt_state)
    assert got.keys() == want.keys()
    norm = np.sqrt(sum(((got[k] - w) ** 2).sum() for k, w in want.items())
                   / sum((w ** 2).sum() for w in want.values()))
    assert norm < BF16_GRAD_NORM, norm
    top = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        if np.abs(w).max() >= 0.03 * top:
            err = np.abs(got[k] - w).max() / np.abs(w).max()
            assert err < BF16_GRAD_LEAF, (k, err)
    for tensors in (tstate.params(), tstate.ema_params,
                    *tstate.optimizer.moments.values()):
        assert all(x.dtype == torch.float32 for x in tensors)


@pytest.mark.parametrize("dtype,policy", [("float32", "full"),
                                          ("float32", "dots"),
                                          ("bfloat16", "dots")])
def test_remat_step_equals_plain_step(dtype, policy):
    """A step with remat equals the step without, bit for bit, with drop
    path and dropout on: the recompute draws the masks the forward drew
    (a redrawn mask would move the gradients)."""
    cfg = port_config(small_cfg(with_fuzzy=True, scale_range=0.85,
                                droppath=0.3, fuse_path_drop=0.2,
                                dropout=0.1))
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    _, jbatch = _make_batch(cfg, seed=1)
    batch = {k: t(v) for k, v in jbatch.items()}
    states, losses = [], []
    for remat in (False, True):
        state, _ = create_train_state(
            dataclasses.replace(cfg, remat=remat, remat_policy=policy), TC1,
            5, device=CPU, generator=torch.Generator().manual_seed(0))
        state, loss = train_step(state, batch, step_generator(0, 0))
        states.append(state)
        losses.append(loss)
    assert losses[0].keys() == losses[1].keys()
    for k in losses[0]:
        assert torch.equal(losses[0][k], losses[1][k]), k
    plain, remat = states
    for a, b in zip([*plain.params(), *plain.optimizer.moments["mu"]],
                    [*remat.params(), *remat.optimizer.moments["mu"]]):
        assert torch.equal(a, b)
    # drop path is on: another draw moves the losses
    other, _ = create_train_state(cfg, TC1, 5, device=CPU,
                                  generator=torch.Generator().manual_seed(0))
    _, loss = train_step(other, batch, step_generator(0, 1))
    assert not torch.equal(loss["total_loss"], losses[0]["total_loss"])


def test_remat_step_matches_jax():
    """The port's remat step (policy "dots") against JAX's ``remat=True``
    step from the same converted weights on the same batch (drop path 0):
    every loss term within 2e-4, as the fp32 trajectory test holds them."""
    cfg = dataclasses.replace(_deterministic_cfg(), remat=True,
                              remat_policy="dots")
    _, params = jax_model_and_params(cfg, seed=1)
    _, jbatch = _make_batch(cfg, seed=1)
    tstate, _ = create_train_state(port_config(cfg), TC1, 5, device=CPU,
                                   flax_params=flatten_params(params))
    _, jl = jax_step(cfg, params, jbatch)
    _, tl = train_step(tstate, {k: t(v) for k, v in jbatch.items()}, None)
    assert set(tl) == set(jl)
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), jl[k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the measured gaps the tolerances above cite:
#     python -m tests.test_torch_bf16_train
# ---------------------------------------------------------------------------

def _step_gaps() -> None:
    """One step of the tiny config in fp32 and in bf16 through both
    frameworks: each loss term's and the first gradients' gaps (by norm,
    and the worst leaf above 3% of the model's largest gradient), port
    bf16 against JAX bf16 and each framework's bf16 against its fp32."""
    base = _deterministic_cfg()
    _, params = jax_model_and_params(base, seed=1)
    _, jbatch = _make_batch(base, seed=1)
    tbatch = {k: t(v) for k, v in jbatch.items()}
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, compute_dtype=dtype)
        jstate, jl = jax_step(cfg, params, jbatch)
        tstate, _ = create_train_state(port_config(cfg), TC1, 5, device=CPU,
                                       flax_params=flatten_params(params))
        tstate, tl = train_step(tstate, tbatch, None)
        names = [n for n, _ in tstate.model.named_parameters()]
        runs["jax", dtype] = jl, first_moments(jstate.opt_state)
        runs["port", dtype] = ({k: v.item() for k, v in tl.items()},
                               params_to_jax(dict(zip(
                                   names, tstate.optimizer.moments["mu"]))))
    ref = runs["jax", "float32"][1]
    top = max(np.abs(w).max() for w in ref.values())
    for a, b in ((("port", "bfloat16"), ("jax", "bfloat16")),
                 (("jax", "bfloat16"), ("jax", "float32")),
                 (("port", "bfloat16"), ("port", "float32"))):
        (la, ga), (lb, gb) = runs[a], runs[b]
        loss = max(abs(la[k] - lb[k]) / abs(lb[k]) for k in lb)
        norm = np.sqrt(sum(((ga[k] - w) ** 2).sum() for k, w in gb.items())
                       / sum((w ** 2).sum() for w in gb.values()))
        leaf = [max(np.abs(ga[k] - w).max() / np.abs(w).max()
                    for k, w in gb.items() if np.abs(ref[k]).max() >= floor)
                for floor in (0.03 * top, 1e-9)]
        print(f"{a} vs {b}: loss terms {loss:.2e}, first gradients "
              f"{norm:.2e} by norm, worst leaf above 3% {leaf[0]:.2e}, "
              f"of all {leaf[1]:.2e}")


if __name__ == "__main__":
    for w in (1, 3, 4):
        q, k, v, dout, mask, kw = band_case(w, seed=10 + w)
        got = plain_backward(*(t(x).to(torch.bfloat16)
                               for x in (q, k, v, dout)), t(mask), kw)
        _, pullback = jax.vjp(functools.partial(
            band_attention_pallas, kv_mask=jnp.asarray(mask), block=32,
            interpret=True, **kw), *(jnp.asarray(x, jnp.bfloat16)
                                     for x in (q, k, v)))
        gaps = [rel_err(g, jg) for g, jg in
                zip(got, pullback(jnp.asarray(dout, jnp.bfloat16)))]
        print(f"band_backward_plain vs the Pallas VJP, bf16, w={w}: dQ, dK, "
              f"dV {gaps[0]:.2e}, {gaps[1]:.2e}, {gaps[2]:.2e} of max |ref|")
    _step_gaps()
    cfg = dataclasses.replace(_deterministic_cfg(), compute_dtype="bfloat16")
    jm, params = jax_model_and_params(cfg, seed=1)
    _, jbatch = _make_batch(cfg, seed=1)
    tstate, _ = create_train_state(port_config(cfg), TC1, 5, device=CPU,
                                   flax_params=flatten_params(params))
    found = bf16_matchings(cfg, jm, params, jbatch, tstate.model)
    flips = [m for m in found if m["flipped"]]
    print(f"bf16 matchings: {len(flips)} of {len(found)} differ from JAX's, "
          f"the worst {max([m['gap'] for m in flips], default=0):.2e} above "
          f"JAX's optimum; the two frameworks' costs of JAX's assignment "
          f"{max(m['cost_gap'] for m in found):.2e} apart at most")
