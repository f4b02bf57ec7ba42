"""Mixed-precision helpers (counterpart of ``vrdone_tpu/utils/precision.py``).

bf16 serving runs the network body in bfloat16: take a ``cast_floating``
copy of the model and hand it bf16 features (the relation model, and the
detector's ``detect_video(compute_dtype="bfloat16")``). bf16 training keeps
the fp32 masters and runs the forward on ``cast_tensors`` of them inside
autograd (``train/loop.py``), as the JAX train step casts its parameters
inside ``jax.grad``. Either way LayerNorm statistics, the attention scores and
softmax, and the heads stay fp32 inside the model (``MaskVRD.forward``).
"""

from __future__ import annotations

import copy

import torch
from torch import nn


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """The dtype of a ``compute_dtype`` name; ``ValueError`` for any name
    but ``float32`` and ``bfloat16``."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {name!r}, not one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def cast_floating(module: nn.Module,
                  dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """A copy of ``module`` with every floating parameter and buffer cast to
    ``dtype``; integer and bool buffers keep theirs, and ``module`` is left
    as it was (as JAX's ``cast_floating`` returns a new tree)."""
    return copy.deepcopy(module).to(dtype)


def cast_tensors(module: nn.Module, dtype: torch.dtype = torch.bfloat16
                 ) -> dict[str, torch.Tensor]:
    """``module``'s parameters and buffers by ``state_dict`` name, the
    floating ones cast to ``dtype`` (integer and bool buffers as they are,
    as ``cast_floating`` leaves them), for ``torch.func.functional_call``.
    The cast is differentiable: gradients reach the parameters in their own
    dtype (fp32 masters get fp32 gradients, each the cast of the ``dtype``
    gradient, as JAX's cast inside ``jax.grad`` gives them)."""
    tensors = dict(module.named_parameters())
    tensors.update(module.named_buffers())
    return {k: t.to(dtype) if t.is_floating_point() else t
            for k, t in tensors.items()}
