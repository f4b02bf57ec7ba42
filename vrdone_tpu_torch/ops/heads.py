"""Head split and merge of time-major (B, T, C) streams.

The split is head-major along the channels, as the reference reshapes
(B, nh*hs, T) with view(B, nh, hs, T): channels [h*hs, (h+1)*hs) belong to
head h (``vrdone_tpu/ops/masked.py:122-133``).
"""

from __future__ import annotations

import torch


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, C) -> (B, H, T, C/H)."""
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D)."""
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)
