"""bf16 with the relative-position bias (``use_rel_pe``): the port against
the JAX package on the CPU. The band op with a bf16 ``rel_pe`` (the plain
version of K4's bf16 instance) against JAX's dense form and the Pallas
kernel in interpret mode, its gradients (d rel_pe included) against
``jax.vjp`` of the dense form on bf16 leaves, and one bf16 train step of a
tiny ``use_rel_pe`` config, with and without remat, against JAX's. The
bf16 ``MaskVRD`` forward with ``use_rel_pe`` is a case of
``tests/test_torch_bf16.py::test_maskvrd_bf16_matches_jax``.

Tolerances, each a share of max |ref|:
- ``OP_TOL`` and ``PALLAS_TOL`` (``tests/test_torch_bf16.py``) for the op:
  the plain version widens the bf16 table to fp32 and adds it to the fp32
  scaled score before the key mask, as the dense form promotes it, and
  agrees with it bit for bit in every case here; against the Pallas
  kernel, which scales the fp32 dot and rounds the unnormalised P, 2.7e-3
  to 6.3e-3.
- ``OP_TOL`` for the gradients: autograd of the plain version rounds the
  gradient of P and of each bf16 leaf where JAX's VJP of the dense form
  rounds them; measured 0 to 1.1e-4 (d rel_pe bit for bit).
- ``BF16_LOSS_TOL`` (``tests/test_torch_bf16_train.py``) on each loss term
  of the step (measured 3.8e-5 to 1.3e-2).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_bf16 import OP_TOL, PALLAS_TOL, rel_err
from tests.test_torch_bf16_train import BF16_LOSS_TOL, TC1, jax_step, t
from tests.test_torch_model import jax_model_and_params, port_config
from tests.test_torch_relpe import pe_case
from tests.test_train_trajectory import _deterministic_cfg, _make_batch
from tools.export_params_npz import flatten_params
from vrdone_tpu.ops import masked as jops
from vrdone_tpu.ops.pallas.band_attention import band_attention_pallas
from vrdone_tpu_torch.ops import band_attention as tband
from vrdone_tpu_torch.ops import masked as tops
from vrdone_tpu_torch.train.loop import create_train_state, train_step

torch.set_num_threads(1)

CPU = torch.device("cpu")


def bf16_pe_case(seed, t_len, window_size):
    """``pe_case``'s streams, key mask and N(0, 1) table at B=2, H=2, d=8,
    rounded to bf16 (float32 arrays holding bf16 values)."""
    q, k, v, mask, pe = pe_case(seed, 2, t_len, 2, 8, window_size)
    q, k, v, pe = (np.asarray(jnp.asarray(a, jnp.bfloat16)
                              .astype(jnp.float32)) for a in (q, k, v, pe))
    return q, k, v, mask, pe


def to_torch_bf16(*arrays):
    return [torch.tensor(a).to(torch.bfloat16) for a in arrays]


def to_jax_bf16(*arrays):
    return [jnp.asarray(a, jnp.bfloat16) for a in arrays]


@pytest.mark.parametrize("t_len", [12, 17, 130])
@pytest.mark.parametrize("window_size", [7, 8, 9])
def test_band_attention_pe_bf16_matches_jax(t_len, window_size):
    """``band_attention_pe_plain`` and the CPU dispatch on bf16 streams and
    a bf16 table against JAX's dense ``band_attention(rel_pe=...)`` and the
    Pallas kernel in interpret mode, at odd and even windows (an even one
    clamps the bias index) and T below and above the Pallas block and one
    past a 16-row tile of the bf16 kernel; the output is bf16 in all
    three, and the bias moves it."""
    q, k, v, mask, pe = bf16_pe_case(t_len + window_size, t_len, window_size)
    kw = dict(n_head=2, window_size=window_size)
    tq, tk, tv, tpe = to_torch_bf16(q, k, v, pe)
    tmask = torch.from_numpy(mask)
    ours = tband.band_attention_pe_plain(tq, tk, tv, tmask, tpe, **kw)
    assert ours.dtype == torch.bfloat16
    jq, jk, jv, jpe = to_jax_bf16(q, k, v, pe)
    dense = jops.band_attention(jq, jk, jv, jnp.asarray(mask), rel_pe=jpe,
                                **kw)
    assert dense.dtype == jnp.bfloat16
    assert rel_err(ours, dense) < OP_TOL
    pallas = band_attention_pallas(jq, jk, jv, jnp.asarray(mask),
                                   rel_pe=jpe, interpret=True, **kw)
    assert pallas.dtype == jnp.bfloat16
    assert rel_err(ours, pallas) < PALLAS_TOL
    launches = (tband.pe_launches, tband.pe_bf16_launches)
    assert torch.equal(tops.band_attention(tq, tk, tv, tmask, rel_pe=tpe,
                                           **kw), ours)
    assert (tband.pe_launches, tband.pe_bf16_launches) == launches
    plain = tband.band_attention_plain(tq, tk, tv, tmask, **kw)
    assert (ours.float() - plain.float()).abs().max() > 1e-2


@pytest.mark.parametrize("window_size", [7, 8])
def test_band_attention_pe_bf16_grads_match_jax(window_size):
    """dq, dk, dv and d rel_pe of the CPU dispatch on bf16 leaves against
    ``jax.vjp`` of the dense form on the same bf16 leaves, each gradient
    bf16, with a nonzero upstream gradient on invalid query rows."""
    q, k, v, mask, pe = bf16_pe_case(window_size, 40, window_size)
    g = np.asarray(jnp.asarray(
        np.random.default_rng(1).standard_normal(q.shape), jnp.bfloat16
    ).astype(jnp.float32))
    kw = dict(n_head=2, window_size=window_size)
    _, vjp = jax.vjp(lambda q_, k_, v_, p_: jops.band_attention(
        q_, k_, v_, jnp.asarray(mask), rel_pe=p_, **kw),
        *to_jax_bf16(q, k, v, pe))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    leaves = [x.requires_grad_() for x in to_torch_bf16(q, k, v, pe)]
    out = tops.band_attention(*leaves[:3], torch.from_numpy(mask),
                              rel_pe=leaves[3], **kw)
    got = torch.autograd.grad(out, leaves, to_torch_bf16(g)[0])
    for name, a, b in zip(("dq", "dk", "dv", "drel_pe"), got, want):
        assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16, name
        assert rel_err(a, b) < OP_TOL, (name, rel_err(a, b))
    assert np.abs(np.asarray(want[3], np.float32)).max() > 1e-3


@pytest.mark.parametrize("remat", [False, True])
def test_bf16_rel_pe_train_step_matches_jax(remat):
    """One bf16 step of a tiny ``use_local`` + ``use_rel_pe`` config (drop
    path 0; with remat, policy "dots", on both sides) from the same
    converted weights on the same batch as JAX's ``train_step`` with
    ``compute_dtype="bfloat16"``: every loss term within BF16_LOSS_TOL, the
    bias gets a gradient (the step runs at the warm-up's lr 0), and a second
    step moves it; the masters stay fp32."""
    cfg = dataclasses.replace(_deterministic_cfg(), use_local=True,
                              use_rel_pe=True, compute_dtype="bfloat16",
                              remat=remat, remat_policy="dots")
    _, params = jax_model_and_params(cfg, seed=1)
    _, jbatch = _make_batch(cfg, seed=1)
    tbatch = {k: t(v) for k, v in jbatch.items()}
    state, _ = create_train_state(port_config(cfg), TC1, 5, device=CPU,
                                  flax_params=flatten_params(params))
    names = [n for n, _ in state.model.named_parameters()]
    pe = [i for i, n in enumerate(names) if n.endswith("rel_pe")]
    assert len(pe) == 5
    before = [state.params()[i].detach().clone() for i in pe]

    _, jl = jax_step(cfg, params, jbatch)
    state, tl = train_step(state, tbatch, None)
    assert set(tl) == set(jl)
    for k in jl:
        assert abs(tl[k].item() - jl[k]) <= BF16_LOSS_TOL * abs(jl[k]), \
            (k, tl[k].item(), jl[k])
    assert all(state.optimizer.moments["mu"][i].abs().max() > 0 for i in pe)
    state, losses = train_step(state, tbatch, None)
    assert all(torch.isfinite(v) for v in losses.values())
    assert all((state.params()[i] - b).abs().max() > 0
               for i, b in zip(pe, before))
    assert all(x.dtype == torch.float32 for x in state.params())
