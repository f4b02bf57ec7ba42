"""JAX parameters -> the port's ``state_dict``.

The inverse of the transplant helpers in ``tests/oracle.py``. Input is the
flax parameter tree flattened to ``/``-joined keys (what
``tools/export_params_npz.py`` writes). The port's modules carry the flax
names, so a key maps by joining with ``.``; only layouts change:

  * Dense ``kernel`` (in, out)            -> ``weight`` (out, in)
  * conv ``kernel`` (K, C_in/g, C_out)    -> ``weight`` (C_out, C_in/g, K)
  * ConvMLP ``layers_<i>_kernel`` (K, C_in, C_out) -> same name, (C_out, C_in, K)
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def params_from_jax(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flattened flax params (``a/b/kernel`` keys) -> state_dict tensors."""
    out = {}
    for key, value in flat.items():
        parts = key.split("/")
        value = np.asarray(value)
        if parts[-1] == "kernel" or parts[-1].endswith("_kernel"):
            if value.ndim == 2:
                value = value.T
            elif value.ndim == 3:
                value = value.transpose(2, 1, 0)
            else:
                raise ValueError(f"{key}: kernel of rank {value.ndim}")
            if parts[-1] == "kernel":
                parts[-1] = "weight"
        out[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def load_npz(path: str) -> dict[str, np.ndarray]:
    """Read a flattened parameter file written by tools/export_params_npz.py."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_params(model: nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Convert ``flat`` and copy it into ``model``. Strict: raises
    ``RuntimeError`` if a key is missing or extra, or a shape differs."""
    model.load_state_dict(params_from_jax(flat), strict=True)
