"""VrdONE-X, the CLIP-fused backbone (``configs/vidor_x.yaml``), in the
port against the JAX package on the CPU, at a tiny width with 12 CLIP
channels a stream, the entity embeddings with and without LayerNorm.

Tolerances, as for the model without CLIP:
- the fp32 eval forward 5e-4 (``tests/test_torch_model.py``);
- the bf16 forward 5e-2 of max |ref| (``tests/test_torch_bf16.py``'s
  ``MODEL_TOL``);
- a deterministic train step 2e-4 on every loss term and 2e-3 relative
  drift of the parameters and EMA (``tests/test_torch_train.py``).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_model_parity import packed_channels, small_cfg
from tests.test_torch_bf16 import MODEL_TOL as BF16_MODEL_TOL
from tests.test_torch_bf16 import rel_err
from tests.test_torch_model import (TOL, inputs, jax_model_and_params,
                                    port_config)
from tests.test_torch_train import TC
from tests.test_train_trajectory import _make_batch
from tools.export_params_npz import flatten_params
from vrdone_tpu.train import optim as jopt
from vrdone_tpu.train.loop import TrainState as JTrainState
from vrdone_tpu.train.loop import train_step as jtrain_step
from vrdone_tpu.utils.precision import cast_floating as jax_cast_floating
from vrdone_tpu_torch.convert import (load_params, params_from_jax,
                                      params_to_jax)
from vrdone_tpu_torch.models.backbone import SOSBackbone
from vrdone_tpu_torch.models.maskvrd import MaskVRD
from vrdone_tpu_torch.train.loop import create_train_state, train_step
from vrdone_tpu_torch.utils.precision import cast_floating

torch.set_num_threads(1)

CPU = torch.device("cpu")
CLIP_DIM = 12
CLIP_LEAVES = ("clip_embd_", "visual_clip_fuse")


def clip_cfg(with_ln: bool, **over):
    return small_cfg(with_clip_feature=True, clip_dim=CLIP_DIM,
                     embd_with_ln=with_ln, **over)


def converted(cfg, seed=0):
    """The JAX model and its drawn params, and the port's model loaded
    from them."""
    jm, params = jax_model_and_params(cfg, seed=seed)
    tm = MaskVRD(port_config(cfg), device=CPU)
    load_params(tm, flatten_params(params))
    return jm, params, tm


@pytest.mark.parametrize("with_ln,fuse_ks", [(True, 1), (False, 1),
                                             (True, 3)])
def test_clip_forward_matches_jax(with_ln, fuse_ks):
    """The eval forward, heads and every deep-supervision level; with
    ``fuse_ks`` 3 the ConvMLPs (``visual_clip_fuse`` among them) hold conv
    kernels (``layers_<i>_kernel``) in place of Dense layers."""
    cfg = clip_cfg(with_ln, fuse_ks=fuse_ks)
    assert packed_channels(cfg) == 2 * 24 + 2 * CLIP_DIM + 5 + 2 * 8
    jm, params, tm = converted(cfg)
    flat = flatten_params(params)
    assert {k.split("/")[1].rstrip("0123456789") for k in flat
            if "clip" in k} == {"clip_embd_", "visual_clip_fuse"} | (
        {"clip_embd_norm_"} if with_ln else set())
    assert any(k.startswith("backbone/visual_clip_fuse/layers_1")
               for k in flat)
    x, mask = inputs(cfg)
    pj = jax.jit(jm.apply)({"params": params}, jnp.asarray(x),
                           jnp.asarray(mask))
    with torch.no_grad():
        pt = tm(torch.from_numpy(x), torch.from_numpy(mask))
    for got, want in zip([pt, *pt["aux_outputs"]],
                         [pj, *pj["aux_outputs"]]):
        for key in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]), atol=TOL,
                                       rtol=TOL)
    np.testing.assert_array_equal(pt["output_mask"].numpy(),
                                  np.asarray(pj["output_mask"]))
    # the CLIP channels move the heads: the same input with them zeroed
    # gives other logits
    x0 = x.copy()
    x0[..., 2 * 24:2 * 24 + 2 * CLIP_DIM] = 0
    with torch.no_grad():
        p0 = tm(torch.from_numpy(x0), torch.from_numpy(mask))
    assert (p0["pred_logits"] - pt["pred_logits"]).abs().max() > 1e-3


@pytest.mark.parametrize("with_ln", [True, False])
def test_clip_bf16_forward_matches_jax(with_ln):
    """``cast_floating`` parameters and bf16 features through both
    packages: fp32 heads within 5e-2 of max |ref|, and every pyramid level
    in bf16, as JAX gives them."""
    cfg = clip_cfg(with_ln)
    jm, params, tm = converted(cfg)
    tm = cast_floating(tm)
    assert all(p.dtype == torch.bfloat16 for n, p in tm.named_parameters()
               if any(s in n for s in CLIP_LEAVES))
    x, mask = inputs(cfg)
    run = jax.jit(lambda p, x, m: jm.apply(
        {"params": p}, x, m,
        method=lambda mod, x, m: (mod.backbone(x, m)[0], mod(x, m))))
    jpyr, jout = run(jax_cast_floating(params), jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(mask))
    tx, tmask = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask)
    with torch.no_grad():
        tpyr, _ = tm.backbone(tx, tmask)
        tout = tm(tx, tmask)
    assert [str(a.dtype) for a in jpyr] == ["bfloat16"] * len(jpyr)
    assert [a.dtype for a in tpyr] == [torch.bfloat16] * len(jpyr)
    for got, want in zip([tout, *tout["aux_outputs"]],
                         [jout, *jout["aux_outputs"]]):
        for key in ("pred_logits", "pred_masks"):
            assert got[key].dtype == torch.float32
            assert rel_err(got[key], want[key]) < BF16_MODEL_TOL, key


STEPS = 2


@pytest.mark.parametrize("with_ln", [True, False])
def test_clip_train_step_matches_jax(with_ln):
    """The JAX ``train_step`` under ``jax.jit`` against the port's, from
    the same converted weights on the same batch, drop path off: every
    loss term at each step (the first at warm-up's learning rate 0), then
    the parameters and EMA, the CLIP leaves among them, after the second
    (leaves with a gradient at float-noise level skipped, as in
    ``tests/test_torch_train.py``)."""
    cfg = clip_cfg(with_ln, droppath=0.0, fuse_path_drop=0.0,
                   with_fuzzy=True, scale_range=0.85)
    cfg = dataclasses.replace(cfg, predictor=dataclasses.replace(
        cfg.predictor, path_pdrop=0.0))
    tc = {**TC, "ema_decay": 0.9}
    _, params = jax_model_and_params(cfg, seed=1)
    _, jbatch = _make_batch(cfg, seed=1)
    assert jbatch["feats"].shape[-1] == packed_channels(cfg)
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
            grads = params_to_jax(dict(zip(
                names, tstate.optimizer.moments["mu"])))
    clip_moved = False
    for got_list, want_tree in ((tstate.params(), jstate.params),
                                (tstate.ema_params, jstate.ema_params)):
        got = params_to_jax(dict(zip(names, got_list)))
        want = flatten_params(want_tree)
        assert got.keys() == want.keys()
        worst = 0.0
        for k, w in want.items():
            if np.abs(grads[k]).max() < 1e-9:
                continue
            rel = np.abs(got[k] - w).max() / (np.abs(w).max() + 1e-6)
            worst = max(worst, rel)
            if any(s in k for s in CLIP_LEAVES):
                clip_moved |= not np.array_equal(
                    w, flatten_params(params)[k])
        assert worst < 2e-3, worst
    assert clip_moved


@pytest.mark.parametrize("fuse_ks", [1, 3])
def test_clip_params_round_trip(fuse_ks):
    """The flax tree with the CLIP leaves crosses to the port's state dict
    and back unchanged, the conv ConvMLP's ``layers_<i>_kernel`` leaves
    included, and holds exactly the port's parameter names."""
    cfg = clip_cfg(True, fuse_ks=fuse_ks)
    _, params = jax_model_and_params(cfg, seed=2)
    flat = flatten_params(params)
    kernels = [k for k in flat if k.startswith("backbone/visual_clip_fuse/")
               and k.endswith("kernel")]
    assert len(kernels) == 2
    if fuse_ks == 3:
        assert all(k.rsplit("/", 1)[-1] in ("layers_0_kernel",
                                            "layers_1_kernel")
                   for k in kernels)
        assert flat[kernels[0]].shape == (3, 64, 32)
    back = params_to_jax(params_from_jax(flat))
    assert list(back) == list(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    tm = MaskVRD(port_config(cfg), device=CPU)
    assert sorted(params_to_jax(tm.state_dict())) == sorted(flat)


def test_split_channels_refuses_a_width_without_clip():
    """A packed input without the CLIP channels, or with the wrong number,
    is refused by both packages' channel split."""
    cfg = port_config(clip_cfg(True))
    bb = SOSBackbone(
        n_visual=cfg.visual_dim, n_bbox_entity=cfg.bbox_entity_dim,
        n_bbox_so=cfg.bbox_so_dim, n_embd=cfg.embd_dim, n_head=cfg.n_head,
        n_embd_ks=cfg.embd_kernel_size, fuse_ks=cfg.fuse_ks,
        n_fuse_head=cfg.fuse_head, fuse_path_drop=0.0, fuse_qx_stride=1,
        fuse_kv_stride=1, max_len=cfg.max_seq_len, arch=cfg.backbone_arch,
        mha_win_size=cfg.mha_win_size, with_ln=True, use_local=False,
        n_clip=CLIP_DIM, device=CPU)
    full = 2 * 24 + 2 * CLIP_DIM + 5 + 16
    streams = bb._split_channels(torch.zeros(2, 8, full))
    assert [s.shape[-1] for s in streams] == [24, 24, CLIP_DIM, CLIP_DIM, 5,
                                              8, 8]
    for width in (full - 2 * CLIP_DIM, full - 1):
        with pytest.raises(ValueError, match=f"expected {full}"):
            bb._split_channels(torch.zeros(2, 8, width))
    jm, params = jax_model_and_params(clip_cfg(True))
    x, mask = inputs(clip_cfg(True))
    with pytest.raises(AssertionError):
        jm.apply({"params": params}, jnp.asarray(x[..., 2 * CLIP_DIM:]),
                 jnp.asarray(mask))
