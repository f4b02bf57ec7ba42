"""Reference VrdONE / VrdONE-X checkpoints (``.pth``) -> the port's
flattened flax-keyed parameters.

The port's copy of the relation-model conversion of
``tools/convert_reference_checkpoint.py`` (``convert_state_dict`` and its
helpers, word for word) and of ``tools/export_params_npz.py``'s
``flatten_params``, so that a checkpoint of the torch reference reaches the
port without JAX or orbax: the reference's ``model_state_dict_ema`` (else
``model_state_dict``) is mapped key by key onto the flax parameter tree
(torch ``(C_out, C_in, K)`` convs to ``(K, C_in, C_out)`` kernels, 1x1
convs to Dense kernels, ``(1, C, 1)`` norm affines to ``(C,)``), then
flattened to ``/``-joined keys, which ``vrdone_tpu_torch.convert.load_params``
loads. ``convert_reference_checkpoint_torch.py`` writes them as an ``.npz``
that ``eval_torch.py --ckpt_path`` reads.
"""

from __future__ import annotations

import re

import numpy as np


def _conv_kernel(w):
    return np.ascontiguousarray(np.asarray(w).transpose(2, 1, 0))


def _dense_kernel(w):
    w = np.asarray(w)
    if w.ndim == 3:
        w = w[:, :, 0]
    return np.ascontiguousarray(w.T)


def _set(tree: dict, path: list[str], value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _convmlp_path(rest: str):
    """'layers.0.weight' -> dense layers_0 kernel (k=1) or conv kernel."""
    m = re.fullmatch(r"layers\.(\d+)\.(weight|bias)", rest)
    i, kind = m.group(1), m.group(2)
    return f"layers_{i}", kind


def _attn_entries(rest: str, value):
    """Map one attention-submodule state entry to (path, converted)."""
    conv_m = re.fullmatch(r"(query|key|value)_conv\.conv\.(weight|bias)",
                          rest)
    if conv_m:
        name, kind = conv_m.groups()
        out = (_conv_kernel(value) if kind == "weight"
               else np.asarray(value))
        return (["preproc", f"{name}_conv",
                 "kernel" if kind == "weight" else "bias"], out)
    norm_m = re.fullmatch(r"(query|key|value)_norm\.(weight|bias)", rest)
    if norm_m:
        name, kind = norm_m.groups()
        return (["preproc", f"{name}_norm", kind],
                np.asarray(value).reshape(-1))
    proj_m = re.fullmatch(r"(query|key|value|proj)\.(weight|bias)", rest)
    if proj_m:
        name, kind = proj_m.groups()
        out = (_dense_kernel(value) if kind == "weight"
               else np.asarray(value))
        return ([name, "kernel" if kind == "weight" else "bias"], out)
    if rest == "rel_pe":
        return (["rel_pe"], np.asarray(value)[0, 0])
    raise KeyError(rest)


def _block_entries(rest: str, value):
    """TransformerBlock / DecoderLayer internals shared mapping."""
    ln_m = re.fullmatch(r"(ln\d)\.(weight|bias)", rest)
    if ln_m:
        return ([ln_m.group(1), ln_m.group(2)],
                np.asarray(value).reshape(-1))
    mlp_m = re.fullmatch(r"mlp\.([03])\.(weight|bias)", rest)
    if mlp_m:
        idx = "mlp_0" if mlp_m.group(1) == "0" else "mlp_1"
        kind = mlp_m.group(2)
        out = (_dense_kernel(value) if kind == "weight"
               else np.asarray(value))
        return ([idx, "kernel" if kind == "weight" else "bias"], out)
    dp_m = re.fullmatch(r"(drop_path_\w+)\.scale", rest)
    if dp_m:
        return ([dp_m.group(1), "AffineDropPath_0", "scale"],
                np.asarray(value).reshape(-1))
    attn_m = re.fullmatch(r"(attn|self_attn|multihead_attn)\.(.+)", rest)
    if attn_m:
        sub, tail = attn_m.groups()
        path, out = _attn_entries(tail, value)
        return ([sub] + path, out)
    raise KeyError(rest)


def convert_state_dict(sd: dict) -> dict:
    """torch MaskVRD state dict -> our flax params tree."""
    params: dict = {}
    fpn_counts = {}
    for key, val in sd.items():
        if key.startswith("module."):
            key = key[7:]
        if key == "empty_weight":  # loss buffer, not a parameter
            continue

        # ---------------- backbone ----------------
        m = re.fullmatch(
            r"backbone\.(visual_embd|clip_embd)\.(\d+)\.conv\.(weight|bias)",
            key)
        if m:
            base, i, kind = m.groups()
            out = _conv_kernel(val) if kind == "weight" else np.asarray(val)
            _set(params, ["backbone", f"{base}_{i}",
                          "kernel" if kind == "weight" else "bias"], out)
            continue
        m = re.fullmatch(
            r"backbone\.(visual_embd_norm|clip_embd_norm)\.(\d+)\."
            r"(weight|bias)", key)
        if m:
            base, i, kind = m.groups()
            _set(params, ["backbone", f"{base}_{i}", kind],
                 np.asarray(val).reshape(-1))
            continue
        m = re.fullmatch(
            r"backbone\.(bbox_entity_embd|bbox_so_embd)\.conv\."
            r"(weight|bias)", key)
        if m:
            base, kind = m.groups()
            out = _conv_kernel(val) if kind == "weight" else np.asarray(val)
            _set(params, ["backbone", base,
                          "kernel" if kind == "weight" else "bias"], out)
            continue
        m = re.fullmatch(
            r"backbone\.(bbox_entity_norm|s_fuse_norm|o_fuse_norm)\."
            r"(weight|bias)", key)
        if m:
            base, kind = m.groups()
            _set(params, ["backbone", base, kind],
                 np.asarray(val).reshape(-1))
            continue
        m = re.fullmatch(
            r"backbone\.(visual_bbox_fuse|visual_clip_fuse|so_fuse|"
            r"so_visual_bbox_fuse)\.(layers\.\d+\.(?:weight|bias))", key)
        if m:
            base, rest = m.groups()
            layer, kind = _convmlp_path(rest)
            out = _dense_kernel(val) if kind == "weight" else np.asarray(val)
            _set(params, ["backbone", base, layer,
                          "kernel" if kind == "weight" else "bias"], out)
            continue
        m = re.fullmatch(
            r"backbone\.(stem|branch|s_attn|o_attn)\.(\d+)\.(.+)", key)
        if m:
            base, i, rest = m.groups()
            path, out = _block_entries(rest, val)
            _set(params, ["backbone", f"{base}_{i}"] + path, out)
            continue

        # ---------------- neck ----------------
        m = re.fullmatch(
            r"neck\.(input_norms|lateral_norms|fpn_norms)\.(\d+)\."
            r"(weight|bias)", key)
        if m:
            base, i, kind = m.groups()
            name = {"input_norms": "input_norm", "lateral_norms":
                    "lateral_norm", "fpn_norms": "fpn_norm"}[base]
            _set(params, ["neck", f"{name}_{i}", kind],
                 np.asarray(val).reshape(-1))
            continue
        m = re.fullmatch(
            r"neck\.(lateral_convs|fpn_convs)\.(\d+)\.conv\.(weight|bias)",
            key)
        if m:
            base, i, kind = m.groups()
            name = {"lateral_convs": "lateral_conv",
                    "fpn_convs": "fpn_conv"}[base]
            out = _conv_kernel(val) if kind == "weight" else np.asarray(val)
            _set(params, ["neck", f"{name}_{i}",
                          "kernel" if kind == "weight" else "bias"], out)
            continue
        m = re.fullmatch(r"neck\.mask_features\.conv\.(weight|bias)", key)
        if m:
            kind = m.group(1)
            out = _conv_kernel(val) if kind == "weight" else np.asarray(val)
            _set(params, ["neck", "mask_features",
                          "kernel" if kind == "weight" else "bias"], out)
            continue

        # ---------------- predictor ----------------
        if key == "predictor.query_embed.weight":
            _set(params, ["predictor", "query_embed"], np.asarray(val))
            continue
        m = re.fullmatch(r"predictor\.input_norm\.(weight|bias)", key)
        if m:
            _set(params, ["predictor", "input_norm", m.group(1)],
                 np.asarray(val).reshape(-1))
            continue
        m = re.fullmatch(
            r"predictor\.(input_proj|class_embed)\.(weight|bias)", key)
        if m:
            base, kind = m.groups()
            out = _dense_kernel(val) if kind == "weight" else np.asarray(val)
            _set(params, ["predictor", base,
                          "kernel" if kind == "weight" else "bias"], out)
            continue
        m = re.fullmatch(
            r"predictor\.mask_embed\.(layers\.\d+\.(?:weight|bias))", key)
        if m:
            layer, kind = _convmlp_path(m.group(1))
            out = _dense_kernel(val) if kind == "weight" else np.asarray(val)
            _set(params, ["predictor", "mask_embed", layer,
                          "kernel" if kind == "weight" else "bias"], out)
            continue
        m = re.fullmatch(
            r"predictor\.transformer\.decoder\.(layers\.(\d+)\.(.+)|"
            r"norm\.(weight|bias))", key)
        if m:
            if m.group(1).startswith("norm."):
                _set(params, ["predictor", "transformer", "decoder", "norm",
                              m.group(4)], np.asarray(val).reshape(-1))
            else:
                i, rest = m.group(2), m.group(3)
                path, out = _block_entries(rest, val)
                _set(params, ["predictor", "transformer", "decoder",
                              f"layers_{i}"] + path, out)
            continue

        raise KeyError(f"unmapped reference parameter: {key}")
    return params


def flatten_params(tree) -> dict[str, np.ndarray]:
    """Nested param dict -> {"a/b/kernel": array}."""
    out = {}

    def walk(prefix, node):
        if hasattr(node, "items"):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            out[prefix] = np.asarray(node)

    walk("", tree)
    return out


def load_reference_params(path: str, use_ema: bool = True
                          ) -> dict[str, np.ndarray]:
    """A reference checkpoint file -> flattened flax-keyed parameters, read
    as ``tools/convert_reference_checkpoint.py::main`` reads it: the
    ``model_state_dict_ema`` entry when ``use_ema`` and the file has one,
    else ``model_state_dict``; ``convert_state_dict`` strips any
    ``module.`` prefix. Raises ``KeyError`` on a parameter it cannot map."""
    import torch

    # weights_only=False: the JAX tool calls torch.load with torch's
    # default, which was a full unpickle until torch 2.6 and is
    # weights_only=True since; a training checkpoint may hold plain Python
    # objects beside its state dicts (``tools/convert_mega_checkpoint.py``
    # passes False for the same reason). Load only files you trust.
    blob = torch.load(path, map_location="cpu", weights_only=False)
    key = ("model_state_dict_ema"
           if use_ema and "model_state_dict_ema" in blob
           else "model_state_dict")
    sd = {k: v.numpy() for k, v in blob[key].items()}
    return flatten_params(convert_state_dict(sd))
