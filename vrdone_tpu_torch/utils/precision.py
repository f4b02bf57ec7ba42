"""Mixed-precision helpers (counterpart of ``vrdone_tpu/utils/precision.py``).

bf16 serving runs the network body in bfloat16: take a ``cast_floating``
copy of the model and hand it bf16 features. LayerNorm statistics, the
attention scores and softmax, and the heads stay fp32 inside the model
(``MaskVRD.forward``).
"""

from __future__ import annotations

import copy

import torch
from torch import nn


def cast_floating(module: nn.Module,
                  dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """A copy of ``module`` with every floating parameter and buffer cast to
    ``dtype``; integer and bool buffers keep theirs, and ``module`` is left
    as it was (as JAX's ``cast_floating`` returns a new tree)."""
    return copy.deepcopy(module).to(dtype)
