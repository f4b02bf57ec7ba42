"""Flash training of the full attention (``VRDONE_FLASH_TRAIN=1``) on the
CPU: the plain versions of K7's lse and of the K8 / K9 backward
(``ops/full_attention.py``), the ``FullAttention`` function that trains
through them, and three train steps with the opt-in on, against torch
autograd and the JAX side.

Tolerances:
  * fp32, 1e-5 of max |ref|: the lse (times 1 + |lse|) and the three
    gradients against autograd of ``full_attention_plain`` and against the
    VJP of the Pallas library's own plain reference (``mha_reference``,
    whose backward takes its fp32 sums in another order);
  * bf16, ``PALLAS_TOL`` (``tests/test_torch_bf16.py``, 1.6e-2 of max
    |ref|): the port's plain backward rounds P and dS to bf16 before their
    products, as the library's backward kernels do, where autograd of the
    plain version and ``mha_reference``'s backward keep both in fp32;
  * the three opt-in steps against JAX's ``train_step``, which trains
    dense on the CPU: ``tests/test_torch_train.py``'s 2e-4 on each loss and
    2e-3 relative parameter drift.

A row with no valid key is left out of the JAX comparison (the library
reference gives it uniform weights over the masked keys; the port pins its
output to 0): there the port's dQ, and the dK and dV of its item's keys,
are pinned to exactly 0.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas.ops.tpu import flash_attention as jfa

from tests.test_torch_bf16 import PALLAS_TOL, rel_err
from tests.test_torch_model import jax_model_and_params, port_config
from tests.test_torch_train import TC
from tests.test_train_trajectory import _deterministic_cfg, _make_batch
from tools.export_params_npz import flatten_params
from vrdone_tpu.train import optim as jopt
from vrdone_tpu.train.loop import TrainState as JTrainState
from vrdone_tpu.train.loop import train_step as jtrain_step
from vrdone_tpu_torch.convert import params_to_jax
from vrdone_tpu_torch.ops import full_attention as tfa
from vrdone_tpu_torch.ops import masked as tmasked
from vrdone_tpu_torch.ops.band_attention import band_rowsum
from vrdone_tpu_torch.train.loop import create_train_state, train_step

torch.set_num_threads(1)

CPU = torch.device("cpu")
FP32_TOL = 1e-5
# (B, Tq, Tk, heads, d): Tq = Tk with padded keys (item 2 has none), the
# predictor's 9 queries over 64 keys, and d = 64
CASES = {"padded": (3, 48, 48, 2, 32), "tq9_tk64": (3, 9, 64, 2, 32),
         "d64": (3, 48, 48, 2, 64)}
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def case_inputs(name: str, seed: int = 0):
    """q, k, v, dout (fp32 numpy, B, T, H*d) and the key mask: item 0 whole,
    item 1 padded with an invalid key inside, item 2 with no valid key."""
    b, tq, tk, h, d = CASES[name]
    rng = np.random.default_rng(seed)
    q, dout = (rng.standard_normal((b, tq, h * d)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.standard_normal((b, tk, h * d)).astype(np.float32)
            for _ in range(2))
    mask = np.arange(tk)[None] < np.array([tk, tk * 2 // 3, 0])[:, None]
    mask[1, 3] = False
    return q, k, v, dout, mask


def port_backward(q, k, v, dout, mask, h, dtype):
    """The port's lse and plain backward on ``dtype`` streams, and autograd
    of the plain forward on the same streams."""
    tq, tk, tv, tdo = (torch.from_numpy(x).to(dtype) for x in (q, k, v, dout))
    tm = torch.from_numpy(mask)
    qkv = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = tfa.full_attention_plain(*qkv, tm, n_head=h)
    dense = torch.autograd.grad(out, qkv, tdo)
    lse = tfa.full_attention_lse_plain(tq, tk, tm, n_head=h)
    got = tfa.full_attention_backward_plain(
        tq, tk, tv, tm, lse, band_rowsum(tdo, out.detach(), h), tdo,
        n_head=h)
    return lse, got, dense


def heads_first(x, h):
    b, t, c = x.shape
    return x.reshape(b, t, h, c // h).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_backward_plain_matches_autograd(case, dtype):
    """``full_attention_backward_plain`` from the lse against torch
    autograd of ``full_attention_plain`` on the same streams, rows without
    a valid key included (both give them zero gradients)."""
    *arrays, mask = case_inputs(case)
    h = CASES[case][3]
    _, got, dense = port_backward(*arrays, mask, h, DTYPES[dtype])
    for g, w in zip(got, dense):
        assert g.dtype == w.dtype == DTYPES[dtype]
        err = ((g.float() - w.float()).abs().max()
               / w.float().abs().max()).item()
        assert err <= (FP32_TOL if dtype == "fp32" else PALLAS_TOL), err


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_lse_and_backward_match_library_reference(case, dtype):
    """The port's lse and plain backward against the Pallas library's own
    plain reference on the JAX side: l and m of ``mha_reference_no_custom_
    vjp(..., save_residuals=True)`` and ``jax.vjp`` of ``mha_reference``
    (q scaled by 1/sqrt(d) and sm_scale 1, the form its backward takes),
    kv segment ids from the key mask. JAX takes the port's bf16 values
    widened to fp32. The item without a valid key is left out, and there
    the port's gradients are pinned to 0."""
    q, k, v, dout, mask = case_inputs(case, seed=1)
    b, _, _, h, d = CASES[case]
    dt = DTYPES[dtype]
    lse, got, _ = port_backward(q, k, v, dout, mask, h, dt)
    # the values the port saw, in fp32, heads first
    q, k, v, dout = (torch.from_numpy(x).to(dt).float().numpy()
                     for x in (q, k, v, dout))
    scale = 1.0 / np.sqrt(d)
    qh, kh, vh, doh = (jnp.asarray(heads_first(x, h)) for x in (q, k, v,
                                                                  dout))
    seg = jfa.SegmentIds(jnp.ones(q.shape[:2], jnp.int32),
                         jnp.asarray(mask, jnp.int32))
    _, l, m = jfa.mha_reference_no_custom_vjp(qh * scale, kh, vh, None, seg,
                                              save_residuals=True)
    out, vjp = jax.vjp(
        lambda q_, k_, v_: jfa.mha_reference(q_, k_, v_, None, seg,
                                             sm_scale=1.0),
        qh * scale, kh, vh)
    jdq, jdk, jdv = vjp(doh)
    want = [np.asarray(g).transpose(0, 2, 1, 3).reshape(x.shape)
            for g, x in ((jdq * scale, q), (jdk, k), (jdv, v))]
    keep = mask.any(-1)
    want_lse = np.asarray(m + jnp.log(l))[keep]
    lse_err = np.abs(lse.numpy()[keep] - want_lse) / (1 + np.abs(want_lse))
    assert lse_err.max() <= FP32_TOL, lse_err.max()
    assert np.isposinf(lse.numpy()[~keep]).all()
    tol = FP32_TOL if dtype == "fp32" else PALLAS_TOL
    for g, w in zip(got, want):
        assert rel_err(g[keep], w[keep]) <= tol, rel_err(g[keep], w[keep])
        assert (g[~keep] == 0).all()


def test_invalid_keys_get_zero_dk_dv():
    """An invalid key, inside a padded item or past its length, gets exactly
    zero dK and dV, as does every key of the item without a valid key; the
    rows of that item get zero dQ."""
    q, k, v, dout, mask = case_inputs("padded", seed=2)
    _, (dq, dk, dv), _ = port_backward(q, k, v, dout, mask, 2,
                                       torch.float32)
    invalid = torch.from_numpy(~mask)
    assert (dk[invalid] == 0).all() and (dv[invalid] == 0).all()
    assert (dq[2] == 0).all() and (dk[0] != 0).any() and (dq[1] != 0).any()


def counting(monkeypatch):
    """Count ``FullAttention``'s forwards and the plain backward's calls
    in ``ops.masked.full_attention``."""
    seen = types.SimpleNamespace(forward=0, backward=0)
    fn, plain = tfa.FullAttention, tfa.full_attention_backward_plain

    def apply(*args):
        seen.forward += 1
        return fn.apply(*args)

    def backward(*args, **kw):
        seen.backward += 1
        return plain(*args, **kw)

    monkeypatch.setattr(tmasked, "FullAttention",
                        types.SimpleNamespace(apply=apply))
    monkeypatch.setattr(tfa, "full_attention_backward_plain", backward)
    return seen


@pytest.mark.parametrize("flash", [False, True])
def test_full_attention_dispatch(monkeypatch, flash):
    """With ``FLASH_TRAIN`` a call that needs a gradient runs
    ``FullAttention`` (its plain versions on the CPU) and a call that does
    not the plain forward; without it no call takes the function. Both give
    the dense form's output and gradients."""
    monkeypatch.setattr(tmasked, "FLASH_TRAIN", flash)
    seen = counting(monkeypatch)
    q, k, v, dout, mask = (torch.from_numpy(x)
                           for x in case_inputs("tq9_tk64", seed=3))
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tmasked.full_attention(*qkv, mask, n_head=2, allow_kernel=False)
    grads = torch.autograd.grad(out, qkv, dout)
    ref_in = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = tfa.full_attention_plain(*ref_in, mask, n_head=2)
    want = torch.autograd.grad(ref, ref_in, dout)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=FP32_TOL, atol=FP32_TOL)
    with torch.no_grad():
        tmasked.full_attention(*qkv, mask, n_head=2, allow_kernel=False)
    assert (seen.forward, seen.backward) == ((1, 1) if flash else (0, 0))


STEPS = 3


def test_flash_train_steps_match_jax(monkeypatch):
    """Three train steps of a narrow VidOR-shaped model (``use_local``
    off, so every S/O cross-attention is a full attention; T = 64) with
    ``FLASH_TRAIN`` on, every full attention through ``FullAttention``'s
    plain route, against JAX's jitted ``train_step`` (dense on the CPU)
    from the same converted weights on the same batch (drop path 0): each
    loss term per step, then the parameters and EMA after three steps, the
    float-noise leaves skipped as ``tests/test_torch_train.py`` skips
    them."""
    monkeypatch.setattr(tmasked, "FLASH_TRAIN", True)
    seen = counting(monkeypatch)
    cfg = dataclasses.replace(_deterministic_cfg(), max_seq_len=64)
    assert not cfg.use_local
    tc = {**TC, "ema_decay": 0.9}
    _, params = jax_model_and_params(cfg, seed=2)
    _, jbatch = _make_batch(cfg, seed=2)
    tx, _ = jopt.build_optimizer(params, tc, 5)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         ema_params=jax.tree.map(jnp.copy, params),
                         opt_state=tx.init(params), tx=tx, ema_decay=0.9)
    step_fn = jax.jit(functools.partial(jtrain_step, cfg=cfg))
    tstate, _ = create_train_state(port_config(cfg), tc, 5, device=CPU,
                                   flax_params=flatten_params(params))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    names = [n for n, _ in tstate.model.named_parameters()]
    for step in range(STEPS):
        jstate, jl = step_fn(jstate, jbatch, jax.random.key(0))
        tstate, tl = train_step(tstate, tbatch, None)
        assert set(tl) == set(jl)
        for k in jl:
            np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=2e-4,
                                       atol=2e-4, err_msg=f"{k} step {step}")
        if step == 0:
            grads_seen = params_to_jax(dict(zip(
                names, tstate.optimizer.moments["mu"])))
            # every full attention of the step: 4 a S/O mutual layer, 2 a
            # predictor layer, each forward once and backward once
            per_step = (4 * cfg.backbone_arch[1]
                        + 2 * cfg.predictor.num_layers)
            assert seen.forward == seen.backward == per_step, seen
    for got_list, want_tree in ((tstate.params(), jstate.params),
                                (tstate.ema_params, jstate.ema_params)):
        got = params_to_jax(dict(zip(names, got_list)))
        want = flatten_params(want_tree)
        worst = max(np.abs(got[k] - w).max() / (np.abs(w).max() + 1e-6)
                    for k, w in want.items()
                    if np.abs(grads_seen[k]).max() >= 1e-9)
        assert worst < 2e-3, worst
