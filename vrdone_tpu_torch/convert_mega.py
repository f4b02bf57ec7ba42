"""Reference MEGA detector checkpoints (mega_core, maskrcnn-benchmark
layout) -> the port's flattened flax-keyed ``MegaDetector`` parameters.

The port's copy of ``tools/convert_mega_checkpoint.py``'s conversion
(``convert``, ``convert_mega_head``, ``load_state_dict`` and their helpers,
word for word), so that a released MEGA checkpoint reaches the port
without JAX or orbax. Key families, the stripped ``module.`` prefixes, the
frozen batch norm's epsilon and the fc0 fold are as that tool's docstring
sets them out: where the checkpoint's fc0 reads flattened RoI crops, its
kernel is folded over the spatial taps (exact only for spatially constant
crops) and a warning goes to stderr. Reference MEGA checkpoints place the
ResNet stride in the 1x1 convolution (``stride_in_1x1``), which neither
detector CLI exposes. ``convert_mega_checkpoint_torch.py`` writes the
result as an ``.npz`` that ``detect_torch.py --ckpt_path`` reads.
"""

from __future__ import annotations

import re
import sys as _sys

import numpy as np

from .convert_reference import flatten_params

FX = "roi_heads.box.feature_extractor"


def _np(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def conv_kernel(w) -> np.ndarray:
    """torch conv weight (out, in, kh, kw) -> flax (kh, kw, in, out)."""
    return _np(w).transpose(2, 3, 1, 0)


def dense(sd, prefix) -> dict:
    """torch nn.Linear -> flax nn.Dense."""
    return {"kernel": _np(sd[prefix + ".weight"]).T,
            "bias": _np(sd[prefix + ".bias"])}


def conv_as_dense(sd, prefix) -> dict:
    """torch 1x1 Conv2d -> flax nn.Dense (the MEGA head's Wg lives as a
    1x1 conv in the reference; ours is a Dense over the embed dim)."""
    w = _np(sd[prefix + ".weight"])[:, :, 0, 0]        # (out, in)
    return {"kernel": w.T, "bias": _np(sd[prefix + ".bias"])}


def grouped_linear(sd, prefix, groups: int) -> dict:
    """torch grouped 1x1 Conv2d(fd*g -> fd, groups=g) -> our GroupedLinear
    kernel (g, d_in, d_out) (models/mega.py GroupedLinear; same math as
    tests/oracle.py mega_head_params.grouped)."""
    w = _np(sd[prefix + ".weight"])[:, :, 0, 0]        # (fd, fd)
    fd = w.shape[0]
    dg = fd // groups
    kern = np.stack([w[i * dg:(i + 1) * dg, :].T for i in range(groups)])
    return {"kernel": kern, "bias": _np(sd[prefix + ".bias"])}


def frozen_bn(sd, prefix) -> dict:
    """The reference FrozenBatchNorm2d applies NO epsilon
    (mega_core/layers/batch_norm.py:27); ours adds 1e-5, so subtract it
    here for an exact-match transplant (same trick as tests/oracle.py
    _frozen_bn_params)."""
    return {"weight": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"]),
            "running_mean": _np(sd[f"{prefix}.running_mean"]),
            "running_var": _np(sd[f"{prefix}.running_var"]) - 1e-5}


def res_stage(sd, prefix: str, blocks: int) -> dict:
    """mega_core ResNet stage -> our ResStage block{i} tree."""
    out = {}
    for i in range(blocks):
        b = f"{prefix}.{i}"
        p = {}
        for j in (1, 2, 3):
            p[f"conv{j}"] = {"conv": {
                "kernel": conv_kernel(sd[f"{b}.conv{j}.weight"])}}
            p[f"bn{j}"] = frozen_bn(sd, f"{b}.bn{j}")
        if f"{b}.downsample.0.weight" in sd:
            p["downsample_conv"] = {"conv": {
                "kernel": conv_kernel(sd[f"{b}.downsample.0.weight"])}}
            p["downsample_bn"] = frozen_bn(sd, f"{b}.downsample.1")
        out[f"block{i}"] = p
    return out


def _stage_blocks(sd, prefix: str) -> int:
    idx = set()
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.")
    for k in sd:
        m = pat.match(k)
        if m:
            idx.add(int(m.group(1)))
    return max(idx) + 1 if idx else 0


def _list_len(sd, prefix: str) -> int:
    idx = set()
    pat = re.compile(re.escape(prefix) + r"\.(\d+)(\.|$)")
    for k in sd:
        m = pat.match(k)
        if m:
            idx.add(int(m.group(1)))
    return max(idx) + 1 if idx else 0


def fold_fc0(weight: np.ndarray, in_dim: int) -> np.ndarray:
    """Reference fc0 kernel (out, C*R*R) -> (out, C) by summing the
    spatial taps: exact iff the 14x14 crop is spatially constant (then
    sum_ij W[o,c,i,j] * xbar[c] == sum W*x); a finetune seed otherwise."""
    out_dim, flat = weight.shape
    assert flat % in_dim == 0, (flat, in_dim)
    spatial = flat // in_dim
    # maskrcnn flatten order is (C, H, W) -> C-major
    return weight.reshape(out_dim, in_dim, spatial).sum(axis=2)


def convert(sd: dict, *, groups: int = 16) -> dict:
    """mega_core state dict -> our MegaDetector "params" tree."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}

    backbone = {
        "stem": {"conv": {
            "kernel": conv_kernel(sd["backbone.body.stem.conv1.weight"])}},
        "stem_bn": frozen_bn(sd, "backbone.body.stem.bn1"),
    }
    for n in (1, 2, 3):
        pref = f"backbone.body.layer{n}"
        backbone[f"layer{n}"] = res_stage(sd, pref, _stage_blocks(sd, pref))

    rpn = {
        "conv": {"kernel": conv_kernel(sd["rpn.head.conv.weight"]),
                 "bias": _np(sd["rpn.head.conv.bias"])},
        "cls_logits": {
            "kernel": conv_kernel(sd["rpn.head.cls_logits.weight"]),
            "bias": _np(sd["rpn.head.cls_logits.bias"])},
        "bbox_pred": {
            "kernel": conv_kernel(sd["rpn.head.bbox_pred.weight"]),
            "bias": _np(sd["rpn.head.bbox_pred.bias"])},
    }

    c5_pref = f"{FX}.head.layer4"
    box_head = {
        "c5": {"layer4": res_stage(sd, c5_pref, _stage_blocks(sd, c5_pref))},
        "cls_score": dense(sd, "roi_heads.box.predictor.cls_score"),
        "bbox_pred": dense(sd, "roi_heads.box.predictor.bbox_pred"),
    }

    return {"backbone": backbone, "rpn": rpn, "box_head": box_head,
            "mega": convert_mega_head(sd, groups=groups)}


def convert_mega_head(sd: dict, *, groups: int = 16,
                      ours_in: int = 2048) -> dict:
    """The MEGA attention-stack subtree (l_*/g_* families) alone —
    prefix-keyed on FX; same math as tests/oracle.py mega_head_params
    but sourced from a state dict instead of a live module."""
    mega = {}
    for i in range(_list_len(sd, f"{FX}.l_fcs")):
        fc = dense(sd, f"{FX}.l_fcs.{i}")
        if i == 0:
            w = _np(sd[f"{FX}.l_fcs.0.weight"])        # (1024, in_size)
            if w.shape[1] != ours_in and w.shape[1] % ours_in == 0:
                print(f"WARNING: fc0 kernel {w.shape} folded over "
                      f"{w.shape[1] // ours_in} spatial taps (flattened-"
                      f"crop fc0 -> pooled-vector fc0; finetune-grade "
                      f"seed, see module docstring)", file=_sys.stderr)
                fc = {"kernel": fold_fc0(w, ours_in).T, "bias": fc["bias"]}
        mega[f"l_fc{i}"] = fc
        mega[f"l_Wg{i}"] = conv_as_dense(sd, f"{FX}.l_Wgs.{i}")
        mega[f"l_Wq{i}"] = dense(sd, f"{FX}.l_Wqs.{i}")
        mega[f"l_Wk{i}"] = dense(sd, f"{FX}.l_Wks.{i}")
        mega[f"l_Wv{i}"] = grouped_linear(sd, f"{FX}.l_Wvs.{i}", groups)
        mega[f"l_u{i}"] = _np(sd[f"{FX}.l_us.{i}"])[:, 0, :]
    for i in range(_list_len(sd, f"{FX}.g_Wqs")):
        mega[f"g_Wq{i}"] = dense(sd, f"{FX}.g_Wqs.{i}")
        mega[f"g_Wk{i}"] = dense(sd, f"{FX}.g_Wks.{i}")
        mega[f"g_Wv{i}"] = grouped_linear(sd, f"{FX}.g_Wvs.{i}", groups)
        mega[f"g_u{i}"] = _np(sd[f"{FX}.g_us.{i}"])[:, 0, :]
    return mega


def load_state_dict(path: str) -> dict:
    """torch.save'd {"model": sd} / raw state dict / legacy pickle."""
    import pickle
    try:
        import torch
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:
        with open(path, "rb") as f:
            obj = pickle.load(f)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return obj


def _flatten(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flatten(v)
    else:
        yield tree


def load_mega_params(path: str, groups: int = 16) -> dict[str, np.ndarray]:
    """A reference MEGA checkpoint file -> flattened flax-keyed
    ``MegaDetector`` parameters (``load_state_dict``, then ``convert``)."""
    return flatten_params(convert(load_state_dict(path), groups=groups))
