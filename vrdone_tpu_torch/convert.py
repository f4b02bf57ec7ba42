"""JAX parameters <-> the port's ``state_dict``.

The inverse of the transplant helpers in ``tests/oracle.py``. Input is the
flax parameter tree flattened to ``/``-joined keys (what
``tools/export_params_npz.py`` writes). The port's modules carry the flax
names, so a key maps by joining with ``.``; only layouts change:

  * Dense ``kernel`` (in, out)            -> ``weight`` (out, in)
  * conv ``kernel`` (K, C_in/g, C_out)    -> ``weight`` (C_out, C_in/g, K)
  * 2-D conv ``kernel`` (kh, kw, C_in, C_out) -> ``weight`` (C_out, C_in, kh, kw)
  * ConvMLP ``layers_<i>_kernel`` (K, C_in, C_out) -> same name, (C_out, C_in, K)
  * ``GroupedLinear`` ``kernel`` (groups, D, dg) under MEGA's ``l_Wv<i>`` or
    ``g_Wv<i>``, or RDN's ``Wv<i>``, crosses as it is, name and layout
  * a ``ConvTranspose(transpose_kernel=True)`` ``kernel`` (kh, kw, out, in)
    takes the 2-D conv rule to ``ConvTranspose2d``'s (in, out, kh, kw): the
    flax kernel is that of the forward convolution whose gradient both
    layers compute, so no spatial flip
  * a ``Deconv`` ``kernel`` (kh, kw, in, out) of ``models/mask_keypoint.py``,
    which JAX stores spatially flipped (the kernel of its convolution over
    the zero-inserted input), takes the 2-D conv rule too and crosses
    flipped: the port's ``Deconv`` flips it back and swaps in and out for
    ``conv_transpose2d``, unlike the ``ConvTranspose`` rule above
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

# the GroupedLinear modules of models/mega.py and models/rdn.py: their rank-3
# kernel is no conv
_GROUPED = re.compile(r"(?:[lg]_)?Wv\d+")


def _grouped(parts: list[str]) -> bool:
    return (len(parts) >= 2 and parts[-1] == "kernel"
            and _GROUPED.fullmatch(parts[-2]) is not None)


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flattened flax params (``a/b/kernel`` keys) -> state_dict tensors."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        value = np.asarray(value)
        if _grouped(parts):
            pass
        elif parts[-1] == "kernel" or parts[-1].endswith("_kernel"):
            if value.ndim == 2:
                value = value.T
            elif value.ndim == 3:
                value = value.transpose(2, 1, 0)
            elif value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{key}: kernel of rank {value.ndim}")
            if parts[-1] == "kernel":
                parts[-1] = "weight"
        out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def flax_key(name: str, value: torch.Tensor) -> str:
    """The flattened flax key (``a/b/kernel``) of a ``state_dict`` entry.
    Only flax ``kernel`` leaves become ``weight``, and only they have two or
    more axes under that name (LayerNorm's and frozen batch norm's
    ``weight`` are 1-D), so the inverse of ``params_from_jax`` needs no
    module types."""
    parts = name.split(".")
    if parts[-1] == "weight" and value.ndim >= 2:
        parts[-1] = "kernel"
    return "/".join(parts)


def is_flax_kernel(name: str, value: torch.Tensor) -> bool:
    """Whether the parameter is a flax ``kernel`` or ``*_kernel`` leaf: the
    parameters that the JAX package's ``train/optim.py::decay_mask``
    decays (all but the grouped ones are the ones ``params_from_jax``
    transposes)."""
    leaf = flax_key(name, value).rsplit("/", 1)[-1]
    return leaf == "kernel" or leaf.endswith("_kernel")


def params_to_jax(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """``state_dict`` tensors -> flattened flax params: the inverse of
    ``params_from_jax``."""
    out = {}
    for name, value in state.items():
        a = value.detach().cpu().numpy()
        key = flax_key(name, value)
        if is_flax_kernel(name, value) and not _grouped(key.split("/")):
            a = a.transpose({2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}[a.ndim])
        out[key] = np.ascontiguousarray(a)
    return out


def load_npz(path: str) -> dict[str, np.ndarray]:
    """Read a flattened parameter file written by tools/export_params_npz.py."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_params(model: nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Convert ``flat`` and copy it into ``model``. Strict: raises
    ``RuntimeError`` if a key is missing or extra, or a shape differs."""
    model.load_state_dict(params_from_jax(flat), strict=True)


# the parts of a MegaDetector that feature extraction does not run: an
# extractor checkpoint (tools/extract_gt_features.py::init_extractor_params
# draws backbone, box_head/c5 and mega only) lacks them, a converted MEGA
# checkpoint carries them
_DETECTION_ONLY = ("rpn.", "box_head.cls_score.", "box_head.bbox_pred.")


def load_extractor_params(model: nn.Module, flat: dict[str, np.ndarray]
                          ) -> None:
    """Convert ``flat`` and copy it into a ``MegaDetector`` that extracts
    features. Every key of the extraction path (``backbone``,
    ``box_head/c5``, ``mega``) must be present with its shape; the RPN and
    the box predictor are all present (shapes checked) or all absent, and
    keep their values when absent. Raises ``RuntimeError`` if any other key
    is missing or extra, or a shape differs, as ``load_params`` does."""
    state = params_from_jax(flat)
    own = model.state_dict()
    optional = {k for k in own if k.startswith(_DETECTION_ONLY)}
    errors = []
    missing = sorted(set(own) - optional - set(state))
    if missing:
        errors.append(f"missing key(s) {missing}")
    extra = sorted(set(state) - set(own))
    if extra:
        errors.append(f"unexpected key(s) {extra}")
    given = optional & set(state)
    if given and given != optional:
        errors.append(f"the RPN and box predictor come all or none: "
                      f"missing {sorted(optional - given)}")
    shapes = sorted(f"{k}: {tuple(state[k].shape)} for {tuple(own[k].shape)}"
                    for k in set(state) & set(own)
                    if state[k].shape != own[k].shape)
    if shapes:
        errors.append(f"shape mismatch {shapes}")
    if errors:
        raise RuntimeError(f"Error(s) in loading extractor params into "
                           f"{type(model).__name__}: " + "; ".join(errors))
    model.load_state_dict(state, strict=False)
