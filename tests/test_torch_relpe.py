"""Relative-position bias (``use_rel_pe``) in the port against the JAX
package: the band op with ``rel_pe`` (the plain version of the K4 kernel)
against the dense oracle ``masked.band_attention(rel_pe=...)`` and the
Pallas kernel in interpret mode, its gradients (d rel_pe included) against
``jax.vjp``, the layers and the whole MaskVRD on converted parameters, the
converter and the decay mask, and a port train step.

Tolerances: 1e-5 for the op and its gradients (fp32, one softmax), 1e-4 for
a layer, 5e-4 for the whole model (as ``tests/test_torch_model.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_model_parity import small_cfg
from tests.test_torch_layers import close, jax_and_torch, randomize, seq
from tests.test_torch_model import inputs, jax_model_and_params, port_config
from tests.test_train_trajectory import _deterministic_cfg, _make_batch
from tools.export_params_npz import flatten_params
from vrdone_tpu.models import layers as jl
from vrdone_tpu.ops import masked as jops
from vrdone_tpu.ops.pallas.band_attention import band_attention_pallas
from vrdone_tpu.train import optim as jopt
from vrdone_tpu_torch.convert import (is_flax_kernel, load_params,
                                      params_from_jax, params_to_jax)
from vrdone_tpu_torch.models import layers as tl
from vrdone_tpu_torch.models.maskvrd import MaskVRD
from vrdone_tpu_torch.ops import band_attention as tband
from vrdone_tpu_torch.ops import masked as tops
from vrdone_tpu_torch.train import optim as topt
from vrdone_tpu_torch.train.loop import create_train_state, train_step

torch.set_num_threads(1)

OP_TOL = 1e-5
CPU = torch.device("cpu")


def pe_case(seed, b, t, h, d, window_size):
    """q, k, v (B, T, H*d), a key mask with a short row and an invalid key
    inside a valid stretch, and an N(0, 1) rel_pe (H, window_size)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h * d)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(t)[None] < np.array([t, max(2, t // 3)])[:, None]
    mask[0, t // 2] = False
    rel_pe = rng.standard_normal((h, window_size)).astype(np.float32)
    return q, k, v, mask, rel_pe


@pytest.mark.parametrize("t", [12, 130])
@pytest.mark.parametrize("window_size", [7, 8, 9])
def test_band_attention_pe_matches_jax(t, window_size):
    """The plain version and the CPU dispatch against the dense oracle and
    the Pallas kernel (interpret mode), at odd and even windows (an even
    one clamps the bias index), T below and above the Pallas block."""
    h = 2
    q, k, v, mask, pe = pe_case(t + window_size, 2, t, h, 8, window_size)
    args = [jnp.asarray(a) for a in (q, k, v, mask)]
    kw = dict(n_head=h, window_size=window_size)
    ours = tband.band_attention_pe_plain(
        *(torch.from_numpy(a) for a in (q, k, v, mask, pe)), **kw)
    close(ours, jops.band_attention(*args, rel_pe=jnp.asarray(pe), **kw),
          OP_TOL)
    close(ours, band_attention_pallas(*args, rel_pe=jnp.asarray(pe),
                                      block=128, interpret=True, **kw),
          OP_TOL)
    launches = tband.pe_launches
    torch.testing.assert_close(
        tops.band_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)),
                            rel_pe=torch.from_numpy(pe), **kw),
        ours, rtol=0, atol=0)
    assert tband.pe_launches == launches
    # the bias moves the output
    assert (ours - tband.band_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v, mask)), **kw)
            ).abs().max() > 1e-2


@pytest.mark.parametrize("window_size", [7, 8])
def test_band_attention_pe_grads_match_jax(window_size):
    """dq, dk, dv and d rel_pe of the CPU dispatch against ``jax.vjp`` of
    the dense oracle, with a nonzero upstream gradient on invalid query
    rows."""
    h = 2
    q, k, v, mask, pe = pe_case(window_size, 2, 40, h, 8, window_size)
    g = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)
    kw = dict(n_head=h, window_size=window_size)
    _, vjp = jax.vjp(lambda q_, k_, v_, p_: jops.band_attention(
        q_, k_, v_, jnp.asarray(mask), rel_pe=p_, **kw),
        *(jnp.asarray(a) for a in (q, k, v, pe)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, pe)]
    out = tops.band_attention(*leaves[:3], torch.from_numpy(mask),
                              rel_pe=leaves[3], **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv", "drel_pe"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=OP_TOL,
                                   rtol=OP_TOL, err_msg=name)
    assert np.abs(np.asarray(want[3])).max() > 1e-3


def test_band_attention_pe_kernel_refuses_cpu():
    q, k, v, mask, pe = (torch.from_numpy(a)
                         for a in pe_case(0, 2, 10, 2, 8, 7))
    with pytest.raises(ValueError, match="CUDA device"):
        tband.band_attention_pe_cuda(q, k, v, mask, pe, n_head=2,
                                     window_size=7)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavour,win", [("conv", 7), ("conv_qkv", 8),
                                         ("local", 7), ("local", 9)])
def test_local_attention_with_rel_pe(flavour, win):
    rng = np.random.default_rng(5)
    c, h = 32, 4
    x, mask = seq(rng, 2, 20, c, [20, 9])
    y, _ = seq(rng, 2, 20, c, [20, 9])
    if flavour == "local":
        jm = jl.LocalMHA(c, h, window_size=win, use_rel_pe=True)
        tm = tl.LocalMHA(c, h, window_size=win, use_rel_pe=True, device=CPU)
    else:
        qkv = flavour == "conv_qkv"
        jm = jl.LocalConvMHA(c, h, window_size=win, n_qx_stride=1,
                             n_kv_stride=1, qkv_api=qkv, use_rel_pe=True)
        tm = tl.LocalConvMHA(c, h, window_size=win, n_qx_stride=1,
                             n_kv_stride=1, qkv_api=qkv, use_rel_pe=True,
                             device=CPU)
    inputs_ = (x, y, y, mask, mask)
    params = jax_and_torch(jm, tm, *inputs_)
    assert params["params"]["rel_pe"].shape == (h, win)
    jo, _ = jax.jit(jm.apply)(params, *(jnp.asarray(a) for a in inputs_))
    to, _ = tm(*(torch.from_numpy(a) for a in inputs_))
    close(to, jo)


@pytest.mark.parametrize("strides,win", [((1, 1), 9), ((2, 2), 9)])
def test_transformer_block_with_rel_pe(strides, win):
    """The stem's and a branch's block, forward and d rel_pe."""
    rng = np.random.default_rng(6)
    c, h = 32, 4
    x, mask = seq(rng, 3, 24, c, [24, 11, 5])
    jm = jl.TransformerBlock(c, h, n_ds_strides=strides, mha_win_size=win,
                             use_rel_pe=True)
    tm = tl.TransformerBlock(c, h, n_ds_strides=strides, mha_win_size=win,
                             use_rel_pe=True, device=CPU)
    params = jax_and_torch(jm, tm, x, mask)
    jo, _ = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(mask))
    to, _ = tm(torch.from_numpy(x), torch.from_numpy(mask))
    close(to, jo)
    g = rng.standard_normal(to.shape).astype(np.float32)

    def loss(pe):
        p = {"params": {**params["params"],
                        "attn": {**params["params"]["attn"], "rel_pe": pe}}}
        return (jm.apply(p, jnp.asarray(x), jnp.asarray(mask))[0]
                * jnp.asarray(g)).sum()

    want = jax.jit(jax.grad(loss))(params["params"]["attn"]["rel_pe"])
    got, = torch.autograd.grad((to * torch.from_numpy(g)).sum(),
                               [tm.attn.rel_pe])
    close(got, want)


def test_decoder_layer_with_rel_pe():
    """``use_rel_pe`` threads through a local decoder layer's self and
    cross attention."""
    rng = np.random.default_rng(7)
    c, h = 16, 4
    tgt, tgt_mask = seq(rng, 2, 12, c, [12, 7])
    mem, mem_mask = seq(rng, 2, 12, c, [12, 7])
    kw = dict(n_qx_stride=1, n_kv_stride=1, with_ffn=False, use_local=True,
              win_size=7, use_rel_pe=True)
    jm = jl.DecoderLayer(c, h, **kw)
    tm = tl.DecoderLayer(c, h, **kw, device=CPU)
    inputs_ = (tgt, mem, tgt_mask, mem_mask)
    params = jax_and_torch(jm, tm, *inputs_, seed=2)
    assert {"self_attn", "multihead_attn"} <= {
        k for k, v in params["params"].items() if "rel_pe" in v}
    jo, _ = jax.jit(jm.apply)(params, *(jnp.asarray(a) for a in inputs_))
    to, _ = tm(*(torch.from_numpy(a) for a in inputs_))
    close(to, jo)


# ---------------------------------------------------------------------------
# the model, the converter, the decay mask, training
# ---------------------------------------------------------------------------

def rel_pe_cfg():
    return small_cfg(use_local=True, use_rel_pe=True)


def test_forward_with_rel_pe_matches_jax():
    cfg = rel_pe_cfg()
    jm, params = jax_model_and_params(cfg)
    flat = flatten_params(params)
    # stem and branch blocks carry the bias; the S/O mutual layers do not
    pe_keys = sorted(k for k in flat if k.endswith("/rel_pe"))
    assert pe_keys == sorted(
        [f"backbone/stem_{i}/attn/rel_pe" for i in range(2)]
        + [f"backbone/branch_{i}/attn/rel_pe" for i in range(3)])
    tm = MaskVRD(port_config(cfg), device=CPU)
    load_params(tm, flat)
    x, mask = inputs(cfg)
    pj = jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                           jnp.asarray(mask))
    with torch.no_grad():
        pt = tm(torch.from_numpy(x), torch.from_numpy(mask))
    for key in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(pt[key].numpy(), np.asarray(pj[key]),
                                   atol=5e-4, rtol=5e-4)


def test_converter_round_trips_rel_pe_and_does_not_decay_it():
    """``rel_pe`` leaves cross unchanged both ways, load strictly, are no
    flax kernel, and the port's decay mask equals the JAX package's."""
    cfg = rel_pe_cfg()
    _, params = jax_model_and_params(cfg, seed=3)
    flat = flatten_params(params)
    back = params_to_jax(params_from_jax(flat))
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    tm = MaskVRD(port_config(cfg), device=CPU)
    load_params(tm, flat)
    sd = tm.state_dict()
    key = "backbone/stem_0/attn/rel_pe"
    np.testing.assert_array_equal(
        sd["backbone.stem_0.attn.rel_pe"].numpy(), flat[key])
    assert not is_flax_kernel("backbone.stem_0.attn.rel_pe",
                              sd["backbone.stem_0.attn.rel_pe"])
    ours = topt.decay_mask(tm.named_parameters())
    theirs = flatten_params(jopt.decay_mask(params))
    names = dict(zip(params_to_jax(dict(tm.named_parameters())),
                     ours.values()))
    assert names == {k: bool(v) for k, v in theirs.items()}
    assert names[key] is False
    with pytest.raises(RuntimeError, match="Missing key"):
        load_params(tm, {k: v for k, v in flat.items() if k != key})


def test_random_init_draws_rel_pe():
    """The seeded init fills rel_pe from a truncated normal at +-2 std,
    std sqrt(2 / n_embd), as the JAX package initialises it."""
    m = tl.LocalConvMHA(64, 8, window_size=9, use_rel_pe=True, device=CPU)
    tl.init_weights(m, torch.Generator().manual_seed(0))
    std = (2.0 / 64) ** 0.5
    assert m.rel_pe.shape == (8, 9)
    assert m.rel_pe.abs().max() <= 2 * std
    assert 0.5 * std < m.rel_pe.std() < 1.2 * std


def test_train_steps_move_rel_pe():
    """Two port train steps with ``use_rel_pe`` (the first at lr 0): the
    bias gets a gradient and moves, and the losses stay finite."""
    cfg = dataclasses.replace(_deterministic_cfg(), use_local=True,
                              use_rel_pe=True)
    _, params = jax_model_and_params(cfg, seed=1)
    _, jbatch = _make_batch(cfg, seed=1)
    tc = {"type": "AdamW", "training_lr": 1e-3, "weight_decay": 0.05,
          "clip_grad_l2norm": 1.0, "warmup": True, "warmup_epochs": 1,
          "total_epoch": 2, "schedule_type": "cosine"}
    state, _ = create_train_state(port_config(cfg), tc, 5, device=CPU,
                                  flax_params=flatten_params(params))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    names = [n for n, _ in state.model.named_parameters()]
    pe = [i for i, n in enumerate(names) if n.endswith("rel_pe")]
    assert len(pe) == 5
    before = [state.params()[i].detach().clone() for i in pe]
    for step in range(2):
        state, losses = train_step(state, batch, None)
        assert all(torch.isfinite(v) for v in losses.values())
        if step == 0:
            assert all(state.optimizer.moments["mu"][i].abs().max() > 0
                       for i in pe)
    assert all((state.params()[i] - b).abs().max() > 0
               for i, b in zip(pe, before))
