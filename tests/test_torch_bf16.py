"""bf16 serving of the relation model: the port against the JAX package on
the CPU, both with ``cast_floating`` parameters and bf16 features.

Tolerances, each a share of max |ref| (PERF.md section 2):
- ``OP_TOL`` 4e-3 for the plain band and full attention against JAX's
  dense forms on bf16 streams: one bf16 step (2^-8) at half the largest
  output, room for an fp32 sum taken in another order to move a rounding.
  Both take the scores in fp32 from the widened operands (JAX's numpy
  scale makes ``qh * scale`` fp32) and round the normalised P to bf16;
  every case here agrees bit for bit.
- ``PALLAS_TOL`` 1.6e-2 for the band form against the Pallas kernel in
  interpret mode, which scales the fp32 dot and rounds the unnormalised P:
  two roundings placed elsewhere (5.3e-3 to 7.0e-3 measured here).
- ``MODEL_TOL`` 5e-2 for the heads of a tiny MaskVRD: bf16 activations
  through some forty layers, each framework rounding to bf16 in its own
  places (a bias added after the product's rounding or fused before it,
  elementwise chains fused in fp32 by XLA). Measured here: pred_logits
  2.0e-2 to 4.2e-2, pred_masks 0.7e-2 to 1.3e-2, about the gap between
  each framework's bf16 and fp32 heads (JAX 2.1e-2 to 2.9e-2 on the
  logits, the port 3.2e-2 to 3.4e-2). With ``use_rel_pe`` (the bias drawn
  N(0, 1), as every other non-kernel leaf here) bf16 moves the heads
  further in both frameworks: JAX's own bf16 logits lie 3.4e-2 and
  6.2e-2 from its fp32 ones (``use_local`` off, on), the port's 4.6e-2 and
  5.8e-2 from JAX's bf16 and 3.3e-2 and 5.1e-2 from fp32, while the band
  attention with the bias agrees with JAX's bit for bit. So those cases
  are held to the larger of MODEL_TOL and JAX's own bf16-to-fp32 gap on
  the same head.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from torch import nn

from tests.test_model_parity import small_cfg
from tests.test_torch_model import (inputs, jax_model_and_params,
                                    port_config)
from tools.export_params_npz import flatten_params
from vrdone_tpu.ops import masked as jmasked
from vrdone_tpu.ops.pallas.band_attention import band_attention_pallas
from vrdone_tpu.utils.precision import cast_floating as jax_cast_floating
from vrdone_tpu_torch.convert import flax_key, load_params
from vrdone_tpu_torch.models.maskvrd import MaskVRD
from vrdone_tpu_torch.ops.band_attention import band_attention_plain
from vrdone_tpu_torch.ops.full_attention import full_attention_plain
from vrdone_tpu_torch.train.loop import create_train_state
from vrdone_tpu_torch.utils.precision import cast_floating

torch.set_num_threads(1)

OP_TOL = 4e-3
PALLAS_TOL = 1.6e-2
MODEL_TOL = 5e-2
CPU = torch.device("cpu")


def bf16_streams(b, tq, tk, c, seed, invalid_from=None):
    """q (B, Tq, C), k and v (B, Tk, C) rounded to bf16 (as float32 numpy
    arrays holding bf16 values), and a key mask whose last sequence loses
    its keys from ``invalid_from`` on and whose first loses every third."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, c)).astype(np.float32)
               for t in (tq, tk, tk))
    q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
               for x in (q, k, v))
    mask = np.ones((b, tk), bool)
    mask[0, ::3] = False
    if invalid_from is not None:
        mask[-1, invalid_from:] = False
    return q, k, v, mask


def to_torch_bf16(*arrays):
    return [torch.tensor(a).to(torch.bfloat16) for a in arrays]


def to_jax_bf16(*arrays):
    return [jnp.asarray(a, jnp.bfloat16) for a in arrays]


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("b,t,c,n_head,window,invalid_from", [
    (2, 40, 32, 4, 7, 25),     # T not a multiple of the Pallas block
    (2, 96, 64, 2, 9, 60),     # VidOR's half window, d = 32
    (3, 17, 48, 4, 3, None),   # d = 12, odd T
    # one past a 16-row tile of the bf16 kernel: its widest band (w = 15,
    # d = 8), and d = 64 with an invalid stretch
    (2, 17, 16, 2, 31, 12),
    (2, 33, 128, 2, 9, 20),
])
def test_band_plain_bf16_matches_jax(b, t, c, n_head, window, invalid_from):
    """The bf16 plain band attention against JAX's dense ``band_attention``
    and against the Pallas kernel in interpret mode, on the same bf16
    streams; the output is bf16 in all three."""
    q, k, v, mask = bf16_streams(b, t, t, c, seed=t, invalid_from=invalid_from)
    got = band_attention_plain(*to_torch_bf16(q, k, v), torch.from_numpy(mask),
                               n_head=n_head, window_size=window)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = to_jax_bf16(q, k, v)
    dense = jmasked.band_attention(jq, jk, jv, jnp.asarray(mask),
                                   n_head=n_head, window_size=window)
    assert dense.dtype == jnp.bfloat16
    assert rel_err(got, dense) < OP_TOL
    pallas = band_attention_pallas(jq, jk, jv, jnp.asarray(mask),
                                   n_head=n_head, window_size=window,
                                   interpret=True)
    assert pallas.dtype == jnp.bfloat16
    assert rel_err(got, pallas) < PALLAS_TOL


@pytest.mark.parametrize("b,tq,tk,c,n_head,invalid_from", [
    (2, 40, 40, 32, 4, 25),
    (2, 9, 12, 64, 2, 5),      # the predictor's queries against 12 keys
    (3, 9, 33, 24, 3, None),   # d = 8
])
def test_full_plain_bf16_matches_jax(b, tq, tk, c, n_head, invalid_from):
    """The bf16 plain full attention against JAX's dense ``full_attention``
    on the same bf16 streams (every row keeps a valid key)."""
    q, k, v, mask = bf16_streams(b, tq, tk, c, seed=tq + tk,
                                 invalid_from=invalid_from)
    got = full_attention_plain(*to_torch_bf16(q, k, v), torch.from_numpy(mask),
                               n_head=n_head)
    assert got.dtype == torch.bfloat16
    want = jmasked.full_attention(*to_jax_bf16(q, k, v), jnp.asarray(mask),
                                  n_head=n_head)
    assert want.dtype == jnp.bfloat16
    assert rel_err(got, want) < OP_TOL


def test_cast_floating_matches_jax():
    """The port's ``cast_floating`` of a converted model gives every
    parameter the dtype JAX's gives the same leaf, leaves the model it was
    given in fp32, and keeps integer and bool buffers as they are."""
    cfg = small_cfg(use_local=True)
    _, params = jax_model_and_params(cfg)
    tm = MaskVRD(port_config(cfg), device=CPU)
    load_params(tm, flatten_params(params))
    want = {k: str(v.dtype) for k, v in
            flatten_params(jax_cast_floating(params)).items()}
    got = {flax_key(n, t): str(t.dtype).removeprefix("torch.")
           for n, t in cast_floating(tm).state_dict().items()}
    assert got == want
    assert set(want.values()) == {"bfloat16"}
    assert all(p.dtype == torch.float32 for p in tm.parameters())

    holder = nn.Module()
    holder.register_buffer("count", torch.arange(3))
    holder.register_buffer("flag", torch.ones(2, dtype=torch.bool))
    holder.register_buffer("table", torch.ones(2))
    holder.weight = nn.Parameter(torch.ones(2))
    out = cast_floating(holder)
    assert out.count.dtype == torch.int64 and out.flag.dtype == torch.bool
    assert out.table.dtype == out.weight.dtype == torch.bfloat16


def _levels_and_heads(mod, x, m):
    pyramid, masks = mod.backbone(x, m)
    fpn, _ = mod.neck(pyramid, masks)
    return pyramid, fpn, mod(x, m)


@pytest.mark.parametrize("use_local,use_rel_pe", [
    pytest.param(False, False, id="False"),
    pytest.param(True, False, id="True"),
    pytest.param(False, True, id="False-rel_pe"),
    pytest.param(True, True, id="True-rel_pe")])
def test_maskvrd_bf16_matches_jax(use_local, use_rel_pe):
    """A tiny MaskVRD (2 layers a stage, narrow widths) in bf16: cast
    parameters and bf16 features through the port and through JAX. The
    heads agree within MODEL_TOL x max |ref| (with ``use_rel_pe``, the
    larger of that and JAX's own bf16-to-fp32 gap) and are fp32; every
    pyramid and FPN level has JAX's dtype."""
    cfg = small_cfg(use_local=use_local, use_rel_pe=use_rel_pe)
    jm, params = jax_model_and_params(cfg)
    tm = MaskVRD(port_config(cfg), device=CPU)
    load_params(tm, flatten_params(params))
    tm = cast_floating(tm)
    x, mask = inputs(cfg)
    levels_and_heads = jax.jit(
        lambda p, x, m: jm.apply({"params": p}, x, m,
                                 method=_levels_and_heads))
    jpyr, jfpn, jout = levels_and_heads(
        jax_cast_floating(params), jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(mask))
    limits = {}
    if use_rel_pe:
        j32 = levels_and_heads(params, jnp.asarray(x), jnp.asarray(mask))[2]
        for i, (j16, j32) in enumerate(zip([jout, *jout["aux_outputs"]],
                                           [j32, *j32["aux_outputs"]])):
            for key in ("pred_logits", "pred_masks"):
                limits[i, key] = max(MODEL_TOL, rel_err(
                    torch.from_numpy(np.array(j16[key])), j32[key]))
    tx, tmask = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask)
    with torch.no_grad():
        tpyr, tmasks = tm.backbone(tx, tmask)
        tfpn, _ = tm.neck(tpyr, tmasks)
        tout = tm(tx, tmask)
    def names(*arrays):
        return [str(a.dtype).removeprefix("torch.") for a in arrays]

    assert names(*tpyr) == names(*jpyr) == ["bfloat16"] * len(jpyr)
    assert names(tfpn) == names(jfpn) == ["bfloat16"]
    levels = [("", tout, jout)] + [
        (f"aux {i} ", a, b) for i, (a, b) in enumerate(
            zip(tout["aux_outputs"], jout["aux_outputs"]))]
    assert len(levels) == 3
    for i, (name, t, j) in enumerate(levels):
        for key in ("pred_logits", "pred_masks"):
            assert t[key].dtype == torch.float32, name + key
            assert j[key].dtype == jnp.float32, name + key
            err = rel_err(t[key], j[key])
            assert err < limits.get((i, key), MODEL_TOL), (name + key, err)
    np.testing.assert_array_equal(tout["output_mask"].numpy(),
                                  np.asarray(jout["output_mask"]))


def test_abs_pe_has_no_bf16_path():
    """With ``use_abs_pe`` the fp32 sinusoid table promotes the streams and
    JAX's next convolution refuses the mixed dtypes; the port refuses the
    same model with a TypeError of its own."""
    cfg = small_cfg(use_abs_pe=True)
    jm, params = jax_model_and_params(cfg)
    x, mask = inputs(cfg)
    with pytest.raises(TypeError):
        jax.jit(jm.apply)({"params": jax_cast_floating(params)},
                          jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask))
    tm = cast_floating(MaskVRD(port_config(cfg), device=CPU))
    with pytest.raises(TypeError, match="use_abs_pe"):
        tm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask))


def test_bfloat16_config_builds_and_serves_fp32():
    """``compute_dtype: bfloat16`` is read by the train loop only, as in the
    JAX package: the model builds from such a config and gives the fp32
    config's heads on the same weights, and ``create_train_state`` accepts
    it and keeps fp32 masters, EMA and optimizer moments."""
    cfg = small_cfg()
    _, params = jax_model_and_params(cfg)
    flat = flatten_params(params)
    x, mask = (torch.from_numpy(a) for a in inputs(cfg))
    heads = []
    for dtype in ("float32", "bfloat16"):
        pcfg = dataclasses.replace(port_config(cfg), compute_dtype=dtype)
        tm = MaskVRD(pcfg, device=CPU)
        load_params(tm, flat)
        with torch.no_grad():
            heads.append(tm(x, mask))
    for key in ("pred_logits", "pred_masks"):
        assert heads[1][key].dtype == torch.float32
        assert torch.equal(heads[0][key], heads[1][key])
    bcfg = dataclasses.replace(port_config(cfg), compute_dtype="bfloat16")
    state, _ = create_train_state(
        bcfg, {"type": "AdamW", "training_lr": 1e-3, "total_epoch": 2,
               "warmup": False, "schedule_type": "cosine"}, 5, device=CPU,
        flax_params=flat)
    for tensors in (state.params(), state.ema_params,
                    *state.optimizer.moments.values()):
        assert tensors and all(x.dtype == torch.float32 for x in tensors)
