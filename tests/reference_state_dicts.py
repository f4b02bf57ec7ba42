"""Synthetic checkpoints in the torch reference's layouts, made from
flattened flax-keyed parameters (``a/b/kernel`` keys, as
``vrdone_tpu_torch.convert.params_to_jax`` gives them) by inverting the
layout rules of the reference checkpoint converters:

* ``relation_state_dict``: a VrdONE / VrdONE-X ``MaskVRD`` state dict, the
  keys ``tools/convert_reference_checkpoint.py::convert_state_dict`` reads
  (conv weights ``(C_out, C_in, K)``, 1x1 convs and Linear layers
  ``(out, in, 1)`` / ``(out, in)``, norm affines ``(1, C, 1)``, ``rel_pe``
  under two leading unit axes);
* ``mega_state_dict``: a mega_core (maskrcnn-benchmark) MEGA detector state
  dict, the keys ``tools/convert_mega_checkpoint.py::convert`` reads
  (frozen batch norms without the epsilon, grouped 1x1 convs, ``u`` under a
  unit axis), optionally with the reference's fc0 over flattened RoI crops.

No released checkpoint is at hand, so the converters are tested on these.
Numpy only: ``chip_smoke.py`` imports this module on the card machine.
"""

from __future__ import annotations

import re

import numpy as np

FX = "roi_heads.box.feature_extractor"


def _conv(k: np.ndarray) -> np.ndarray:
    """flax 1-D conv kernel (K, C_in, C_out) -> torch (C_out, C_in, K)."""
    return np.ascontiguousarray(k.transpose(2, 1, 0))


def _pointwise(k: np.ndarray) -> np.ndarray:
    """flax Dense kernel (in, out) -> torch 1x1 Conv1d weight (out, in, 1)."""
    return np.ascontiguousarray(k.T[:, :, None])


def _norm(v: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(v.reshape(1, -1, 1))


def _attn(rest: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    if m := re.fullmatch(r"preproc/(query|key|value)_conv/(kernel|bias)",
                         rest):
        name, kind = m.groups()
        return (f"{name}_conv.conv.{'weight' if kind == 'kernel' else 'bias'}",
                _conv(v) if kind == "kernel" else v)
    if m := re.fullmatch(r"preproc/(query|key|value)_norm/(weight|bias)",
                         rest):
        return f"{m[1]}_norm.{m[2]}", _norm(v)
    if m := re.fullmatch(r"(query|key|value|proj)/(kernel|bias)", rest):
        return ((f"{m[1]}.weight", _pointwise(v)) if m[2] == "kernel"
                else (f"{m[1]}.bias", v))
    if rest == "rel_pe":
        return "rel_pe", v[None, None]
    raise KeyError(rest)


def _block(rest: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    """A TransformerBlock's or DecoderLayer's leaf."""
    if m := re.fullmatch(r"(ln\d)/(weight|bias)", rest):
        return f"{m[1]}.{m[2]}", _norm(v)
    if m := re.fullmatch(r"mlp_([01])/(kernel|bias)", rest):
        idx = "0" if m[1] == "0" else "3"
        return ((f"mlp.{idx}.weight", _pointwise(v)) if m[2] == "kernel"
                else (f"mlp.{idx}.bias", v))
    if m := re.fullmatch(r"(drop_path_\w+)/AffineDropPath_0/scale", rest):
        return f"{m[1]}.scale", _norm(v)
    if m := re.fullmatch(r"(attn|self_attn|multihead_attn)/(.+)", rest):
        key, out = _attn(m[2], v)
        return f"{m[1]}.{key}", out
    raise KeyError(rest)


def _relation_entry(key: str, v: np.ndarray) -> tuple[str, np.ndarray]:
    kind = {"kernel": "weight", "bias": "bias"}.get(key.rsplit("/", 1)[-1])
    if m := re.fullmatch(r"backbone/(visual_embd|clip_embd)_(\d+)/"
                         r"(kernel|bias)", key):
        return (f"backbone.{m[1]}.{m[2]}.conv.{kind}",
                _conv(v) if kind == "weight" else v)
    if m := re.fullmatch(r"backbone/(visual_embd_norm|clip_embd_norm)_(\d+)/"
                         r"(weight|bias)", key):
        return f"backbone.{m[1]}.{m[2]}.{m[3]}", _norm(v)
    if m := re.fullmatch(r"backbone/(bbox_entity_embd|bbox_so_embd)/"
                         r"(kernel|bias)", key):
        return (f"backbone.{m[1]}.conv.{kind}",
                _conv(v) if kind == "weight" else v)
    if m := re.fullmatch(r"backbone/(bbox_entity_norm|s_fuse_norm|"
                         r"o_fuse_norm)/(weight|bias)", key):
        return f"backbone.{m[1]}.{m[2]}", _norm(v)
    if m := re.fullmatch(r"(backbone/(?:visual_bbox_fuse|visual_clip_fuse|"
                         r"so_fuse|so_visual_bbox_fuse)|predictor/mask_embed)"
                         r"/layers_(\d+)/(kernel|bias)", key):
        base = m[1].replace("/", ".")
        return (f"{base}.layers.{m[2]}.{kind}",
                _pointwise(v) if kind == "weight" else v)
    if m := re.fullmatch(r"backbone/(stem|branch|s_attn|o_attn)_(\d+)/(.+)",
                         key):
        rest, out = _block(m[3], v)
        return f"backbone.{m[1]}.{m[2]}.{rest}", out
    if m := re.fullmatch(r"neck/(input_norm|lateral_norm|fpn_norm)_(\d+)/"
                         r"(weight|bias)", key):
        return f"neck.{m[1]}s.{m[2]}.{m[3]}", _norm(v)
    if m := re.fullmatch(r"neck/(lateral_conv|fpn_conv)_(\d+)/(kernel|bias)",
                         key):
        return (f"neck.{m[1]}s.{m[2]}.conv.{kind}",
                _conv(v) if kind == "weight" else v)
    if m := re.fullmatch(r"neck/mask_features/(kernel|bias)", key):
        return (f"neck.mask_features.conv.{kind}",
                _conv(v) if kind == "weight" else v)
    if key == "predictor/query_embed":
        return "predictor.query_embed.weight", v
    if m := re.fullmatch(r"predictor/input_norm/(weight|bias)", key):
        return f"predictor.input_norm.{m[1]}", _norm(v)
    if m := re.fullmatch(r"predictor/(input_proj|class_embed)/(kernel|bias)",
                         key):
        return (f"predictor.{m[1]}.{kind}",
                np.ascontiguousarray(v.T) if kind == "weight" else v)
    if m := re.fullmatch(r"predictor/transformer/decoder/norm/(weight|bias)",
                         key):
        return f"predictor.transformer.decoder.norm.{m[1]}", _norm(v)
    if m := re.fullmatch(r"predictor/transformer/decoder/layers_(\d+)/(.+)",
                         key):
        rest, out = _block(m[2], v)
        return f"predictor.transformer.decoder.layers.{m[1]}.{rest}", out
    raise KeyError(f"no reference layout for {key}")


def relation_state_dict(flat: dict[str, np.ndarray], prefix: str = ""
                        ) -> dict[str, np.ndarray]:
    """A reference ``MaskVRD`` state dict holding ``flat``'s values, each key
    under ``prefix`` (``"module."`` as DDP saves it), with the loss buffer
    ``empty_weight`` the reference keeps beside the parameters. Raises
    ``KeyError`` on a leaf no reference key maps to."""
    sd = {}
    for key, v in flat.items():
        name, out = _relation_entry(key, np.asarray(v))
        sd[prefix + name] = out
    sd[prefix + "empty_weight"] = np.ones(3, np.float32)
    return sd


def _conv2d(k: np.ndarray) -> np.ndarray:
    """flax 2-D conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


def _mega_entry(key: str, v: np.ndarray, groups: int
                ) -> tuple[str, np.ndarray]:
    leaf = key.rsplit("/", 1)[-1]
    if m := re.fullmatch(r"(backbone|box_head/c5)/(.+)/(\w+)", key):
        path = m[2].replace("/", ".")
        path = {"stem/conv": "stem.conv1", "stem_bn": "stem.bn1"}.get(
            m[2], path)
        path = re.sub(r"block(\d+)", r"\1", path)
        path = re.sub(r"\.conv(\d)\.conv$", r".conv\1", path)
        path = path.replace("downsample_conv.conv", "downsample.0")
        path = path.replace("downsample_bn", "downsample.1")
        base = "backbone.body" if m[1] == "backbone" else f"{FX}.head"
        if leaf == "kernel":
            return f"{base}.{path}.weight", _conv2d(v)
        if leaf == "running_var":
            v = v + np.float32(1e-5)   # the reference's batch norm adds none
        return f"{base}.{path}.{leaf}", v
    if m := re.fullmatch(r"rpn/(conv|cls_logits|bbox_pred)/(kernel|bias)",
                         key):
        return ((f"rpn.head.{m[1]}.weight", _conv2d(v)) if leaf == "kernel"
                else (f"rpn.head.{m[1]}.bias", v))
    if m := re.fullmatch(r"box_head/(cls_score|bbox_pred)/(kernel|bias)",
                         key):
        return ((f"roi_heads.box.predictor.{m[1]}.weight",
                 np.ascontiguousarray(v.T)) if leaf == "kernel"
                else (f"roi_heads.box.predictor.{m[1]}.bias", v))
    if m := re.fullmatch(r"mega/([lg])_u(\d+)", key):
        return f"{FX}.{m[1]}_us.{m[2]}", np.ascontiguousarray(v[:, None])
    if m := re.fullmatch(r"mega/([lg])_(fc|Wq|Wk|Wg|Wv)(\d+)/(kernel|bias)",
                         key):
        name = f"{FX}.{m[1]}_{m[2]}s.{m[3]}"
        if leaf == "bias":
            return f"{name}.bias", v
        if m[2] == "Wg":                    # a 1x1 Conv2d
            return f"{name}.weight", np.ascontiguousarray(v.T[..., None,
                                                              None])
        if m[2] == "Wv":                    # grouped 1x1 Conv2d
            g, d_in, dg = v.shape
            assert g == groups, (key, v.shape, groups)
            w = v.transpose(0, 2, 1).reshape(g * dg, d_in)
            return f"{name}.weight", np.ascontiguousarray(w[..., None, None])
        return f"{name}.weight", np.ascontiguousarray(v.T)
    raise KeyError(f"no reference layout for {key}")


def mega_state_dict(flat: dict[str, np.ndarray], *, groups: int,
                    fc0_taps: int = 1, seed: int = 0, prefix: str = ""
                    ) -> dict[str, np.ndarray]:
    """A mega_core MEGA detector state dict holding ``flat``'s values, each
    key under ``prefix``. With ``fc0_taps`` > 1 the first local fc reads
    flattened crops of that many spatial taps, as the reference's does: its
    weight ``(out, C * taps)``, C-major, is drawn from ``seed`` so that the
    taps sum to the pooled-vector kernel in ``flat`` (up to float
    rounding), which ``fold_fc0`` recovers."""
    sd = {}
    for key, v in flat.items():
        name, out = _mega_entry(key, np.asarray(v), groups)
        if key == "mega/l_fc0/kernel" and fc0_taps > 1:
            rng = np.random.default_rng(seed)
            w = out[:, :, None] / fc0_taps + rng.uniform(
                -0.01, 0.01, out.shape + (fc0_taps,)).astype(np.float32)
            w[..., -1] = out - w[..., :-1].sum(axis=-1)
            out = np.ascontiguousarray(w.reshape(out.shape[0], -1))
        sd[prefix + name] = out
    return sd
