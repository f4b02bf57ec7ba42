"""The port's copies of the reference checkpoint converters
(``vrdone_tpu_torch/convert_reference.py`` and ``convert_mega.py``) and
their CLIs, on the CPU.

No released checkpoint is at hand, so the reference state dicts are made
from drawn flax parameters by inverting the converters' layout rules
(``tests/reference_state_dicts.py``): relation models with and without
CLIP and with ``use_rel_pe``, and a tiny MEGA detector with and without the
reference's fc0 over flattened RoI crops. On each, the JAX tool's function
and the port's copy give the same tree, which loads strictly into the port,
and the port's forward on it matches the JAX package's on the same tree
(5e-4, as ``tests/test_torch_model.py`` and ``tests/test_torch_detector.py``
hold the two forwards).
"""

import importlib.util
import inspect
import os
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.reference_state_dicts import mega_state_dict, relation_state_dict
from tests.test_model_parity import small_cfg
from tests.test_torch_detector import KW, T as FRAMES, close, init_run
from tests.test_torch_detector import randomize as randomize_detector
from tests.test_torch_model import (REPO, TOL, inputs, jax_model_and_params,
                                    port_config)
from vrdone_tpu.models import detector as jd
from vrdone_tpu_torch import convert_mega, convert_reference
from vrdone_tpu_torch.convert import load_params, params_to_jax
from vrdone_tpu_torch.models import detector as td
from vrdone_tpu_torch.models.maskvrd import MaskVRD

torch.set_num_threads(1)

CPU = torch.device("cpu")


def tool(name: str):
    """A module of ``tools/`` (not a package), loaded by its file path."""
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF_TOOL = tool("convert_reference_checkpoint")
MEGA_TOOL = tool("convert_mega_checkpoint")
NPZ_TOOL = tool("export_params_npz")

COPIES = (
    [(convert_reference, REF_TOOL, n) for n in (
        "_conv_kernel", "_dense_kernel", "_set", "_convmlp_path",
        "_attn_entries", "_block_entries", "convert_state_dict")]
    + [(convert_reference, NPZ_TOOL, "flatten_params")]
    + [(convert_mega, MEGA_TOOL, n) for n in (
        "_np", "conv_kernel", "dense", "conv_as_dense", "grouped_linear",
        "frozen_bn", "res_stage", "_stage_blocks", "_list_len", "fold_fc0",
        "convert", "convert_mega_head", "load_state_dict", "_flatten")])


@pytest.mark.parametrize("ours,theirs,name", COPIES,
                         ids=[f"{t.__name__[6:]}.{n}" for _, t, n in COPIES])
def test_copy_is_the_original(ours, theirs, name):
    assert (inspect.getsource(getattr(ours, name))
            == inspect.getsource(getattr(theirs, name)))


def test_copies_share_the_tools_constants():
    assert convert_mega.FX == MEGA_TOOL.FX


def leaf_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


RELATION_CASES = {
    "vrdone": {},
    "vrdone_x": dict(with_clip_feature=True, clip_dim=12),
    "vrdone_x_no_ln": dict(with_clip_feature=True, clip_dim=12,
                           embd_with_ln=False),
    "rel_pe": dict(use_rel_pe=True, use_local=True),
}


@pytest.mark.parametrize("case", list(RELATION_CASES))
def test_relation_round_trip(case):
    """Drawn params -> a reference state dict (``module.`` prefixes and the
    loss buffer included) -> the JAX tool's ``convert_state_dict`` and the
    port's copy: the same tree, the drawn params leaf for leaf, strictly
    loaded into the port, whose forward matches JAX's on it."""
    cfg = small_cfg(**RELATION_CASES[case])
    jm, params = jax_model_and_params(cfg, seed=3)
    flat = convert_reference.flatten_params(params)
    sd = relation_state_dict(flat, prefix="module.")
    if case == "rel_pe":
        assert any(k.endswith(".rel_pe") for k in sd)
    if cfg.with_clip_feature:
        assert {"module.backbone.clip_embd.0.conv.weight",
                "module.backbone.visual_clip_fuse.layers.1.weight"} <= set(sd)
    want = NPZ_TOOL.flatten_params(REF_TOOL.convert_state_dict(sd))
    got = convert_reference.flatten_params(
        convert_reference.convert_state_dict(sd))
    leaf_equal(got, want)
    leaf_equal(got, flat)
    tm = MaskVRD(port_config(cfg), device=CPU)
    load_params(tm, got)
    x, mask = inputs(cfg, seed=1)
    tree = REF_TOOL.convert_state_dict(sd)
    pj = jax.jit(jm.apply)({"params": tree}, jnp.asarray(x),
                           jnp.asarray(mask))
    with torch.no_grad():
        pt = tm(torch.from_numpy(x), torch.from_numpy(mask))
    for key in ("pred_logits", "pred_masks"):
        np.testing.assert_allclose(pt[key].numpy(), np.asarray(pj[key]),
                                   atol=TOL, rtol=TOL)


def test_unmapped_or_missing_keys_raise():
    """A reference key no rule maps raises ``KeyError`` in the relation
    converter, in the tool and in the port alike; a MEGA checkpoint that
    lacks a key the tree needs raises ``KeyError`` in both."""
    _, params = jax_model_and_params(small_cfg(), seed=0)
    sd = relation_state_dict(convert_reference.flatten_params(params))
    sd["backbone.unknown_embd.conv.weight"] = np.zeros((2, 2, 1), np.float32)
    for fn in (REF_TOOL.convert_state_dict,
               convert_reference.convert_state_dict):
        with pytest.raises(KeyError, match="unknown_embd"):
            fn(sd)
    det = td.MegaDetector(**KW, device=CPU,
                          generator=torch.Generator().manual_seed(0))
    msd = mega_state_dict(params_to_jax(det.state_dict()), groups=4)
    del msd["rpn.head.conv.bias"]
    for fn in (MEGA_TOOL.convert, convert_mega.convert):
        with pytest.raises(KeyError, match="rpn.head.conv.bias"):
            fn(msd, groups=4)


@pytest.fixture(scope="module")
def jax_detector():
    """The tiny JAX detector of ``tests/test_torch_detector.py`` with drawn
    parameters, flattened."""
    det = jd.MegaDetector(**KW)
    run = init_run(det, 8)
    canvas = jnp.zeros((96, 128, 3), jnp.float32)
    hw = jnp.asarray([96, 128], jnp.float32)
    shapes = jax.eval_shape(
        lambda r: det.init(r, canvas, hw, method=run), jax.random.key(0))
    params = randomize_detector(shapes["params"], 1)
    return det, convert_reference.flatten_params(params)


@pytest.mark.parametrize("fc0_taps", [1, 4], ids=["pooled_fc0",
                                                  "flattened_crop_fc0"])
def test_mega_round_trip(jax_detector, capsys, fc0_taps):
    """Drawn detector params -> a mega_core state dict (``module.``
    prefixes; with 4 taps the reference's flattened-crop fc0) -> the JAX
    tool's ``convert`` and the port's copy: the same tree (only a folded
    fc0 differs from the drawn params, by float rounding, with the
    tool's warning on stderr), strictly loaded into the port, whose
    ``detect_video`` matches JAX's on it."""
    det, flat = jax_detector
    sd = mega_state_dict(flat, groups=4, fc0_taps=fc0_taps, prefix="module.")
    want = NPZ_TOOL.flatten_params(MEGA_TOOL.convert(sd, groups=4))
    tool_err = capsys.readouterr().err
    got = convert_reference.flatten_params(convert_mega.convert(sd, groups=4))
    port_err = capsys.readouterr().err
    assert sorted(got) == sorted(want) == sorted(flat)
    leaf_equal(got, {k: want[k] for k in got})
    folded = "mega/l_fc0/kernel"
    for k in flat:
        if k == folded and fc0_taps > 1:
            assert not np.array_equal(got[k], flat[k])
            np.testing.assert_allclose(got[k], flat[k], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], flat[k], err_msg=k)
    for err in (tool_err, port_err):
        assert ("WARNING: fc0 kernel" in err) == (fc0_taps > 1), err
        if fc0_taps > 1:
            assert f"folded over {fc0_taps} spatial taps" in err
    ours = td.MegaDetector(**KW, device=CPU)
    load_params(ours, got)
    images = np.random.default_rng(6).integers(0, 256, (FRAMES, 96, 128, 3),
                                               dtype=np.uint8)
    hw = np.asarray([96, 128], np.float32)
    tree = {"params": MEGA_TOOL.convert(sd, groups=4)}
    ref = jd.detect_video(det, tree, images, hw, key_post_nms=8)
    out = td.detect_video(ours, images, hw, key_post_nms=8)
    np.testing.assert_array_equal(out["valid"], ref["valid"])
    for k in ("visual", "cls_logits", "bbox_deltas"):
        close(out[k], ref[k], 5e-4)


def run_cli(script, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, os.path.join(REPO, script), *args],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r


def import_cli(name: str):
    sys.path.insert(0, REPO)
    try:
        return __import__(name)
    finally:
        sys.path.remove(REPO)


def test_reference_cli_writes_what_eval_torch_loads(tmp_path):
    """``convert_reference_checkpoint_torch.py`` on a saved VrdONE-X
    checkpoint holding both state dicts, beside plain Python objects:
    its ``.npz`` holds the EMA weights, which ``eval_torch.load_weights``
    loads strictly; the function behind it takes ``model_state_dict``
    with ``use_ema=False``."""
    cfg = small_cfg(with_clip_feature=True, clip_dim=12)
    _, params = jax_model_and_params(cfg, seed=4)
    flat = convert_reference.flatten_params(params)
    ema = {k: v + np.float32(1) for k, v in flat.items()}
    pth = tmp_path / "model_epoch_15_vidor.pth"
    torch.save({"epoch": 15, "config": {"model": "vrdone_x"},
                "model_state_dict": tensors(relation_state_dict(flat)),
                "model_state_dict_ema": tensors(relation_state_dict(ema))},
               pth)
    npz = tmp_path / "params.npz"
    r = run_cli("convert_reference_checkpoint_torch.py", "--torch_ckpt",
                str(pth), "--out", str(npz))
    assert f"wrote {len(flat)} arrays to {npz}" in r.stdout
    tm = MaskVRD(port_config(cfg), device=CPU)
    import_cli("eval_torch").load_weights(tm, str(npz))
    leaf_equal(params_to_jax(tm.state_dict()),
               {k: ema[k] for k in params_to_jax(tm.state_dict())})
    leaf_equal(convert_reference.load_reference_params(str(pth),
                                                       use_ema=False), flat)


def test_mega_cli_writes_what_detect_torch_loads(tmp_path):
    """``convert_mega_checkpoint_torch.py`` on a saved ``{"model": sd}``
    checkpoint of the detector ``detect_torch.py`` builds with these flags,
    fc0 over flattened crops: the fold's warning, and an ``.npz`` that
    ``detect_torch.build_detector`` loads strictly, equal to the source
    but for the folded fc0's rounding."""
    detect_torch = import_cli("detect_torch")
    args = Namespace(resnet_layers="1,1,1", num_classes=5, base_num=4,
                     window=3, global_size=2, seed=0, ckpt_path=None,
                     device="cpu")
    flat = params_to_jax(detect_torch.build_detector(args).state_dict())
    pth = tmp_path / "mega.pth"
    torch.save({"model": tensors(mega_state_dict(flat, groups=16,
                                                 fc0_taps=2)),
                "iteration": 120000}, pth)
    npz = tmp_path / "mega.npz"
    r = run_cli("convert_mega_checkpoint_torch.py", "--mega_ckpt", str(pth),
                "--out", str(npz))
    assert "folded over 2 spatial taps" in r.stderr
    assert f"wrote {len(flat)} arrays to {npz}" in r.stdout
    det = detect_torch.build_detector(Namespace(**{
        **vars(args), "seed": 1, "ckpt_path": str(npz)}))
    got = params_to_jax(det.state_dict())
    assert sorted(got) == sorted(flat)
    for k in flat:
        np.testing.assert_allclose(got[k], flat[k], rtol=0,
                                   atol=1e-6 if k == "mega/l_fc0/kernel"
                                   else 0, err_msg=k)
