"""Masked 1-D sequence ops (counterpart of ``vrdone_tpu/ops/masked.py``).

Activations are time-major ``(B, T, C)`` with boolean ``(B, T)`` validity
masks, as in the JAX package; convolutions transpose to PyTorch's
``(B, C, T)`` inside. Weights are in PyTorch's layouts: a convolution
kernel is ``(C_out, C_in // groups, K)``.

Semantics kept identical to the reference (``vrdone_tpu/ops/masked.py:12-20``):
  * convolutions do NOT pre-mask their input; they convolve the padded
    input and mask the *output*;
  * mask downsampling is "nearest": ``mask[:, ::stride]``;
  * channel LayerNorm uses a biased variance with eps *inside* the sqrt.

``band_attention`` and ``full_attention`` dispatch on the tensor's device:
a CPU tensor takes the plain PyTorch version, any other tensor the
hand-written CUDA kernel, which raises on what it does not take.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .band_attention import band_attention_cuda, band_attention_plain
from .full_attention import full_attention_cuda, full_attention_plain
from .heads import merge_heads, split_heads

__all__ = [
    "conv1d", "downsample_mask", "masked_conv1d", "max_pool1d",
    "channel_layernorm", "split_heads", "merge_heads", "full_attention",
    "band_attention", "sinusoid_encoding", "resize_pe_linear",
]


# ---------------------------------------------------------------------------
# convolution
# ---------------------------------------------------------------------------

def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, *, stride: int = 1,
           groups: int = 1) -> torch.Tensor:
    """1-D convolution over (B, T, C) with K // 2 padding on each side.

    weight: (C_out, C_in // groups, K); bias: (C_out,) or None.
    """
    k = weight.shape[-1]
    out = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride,
                   padding=k // 2, groups=groups)
    return out.transpose(1, 2)


def downsample_mask(mask: torch.Tensor, stride: int,
                    out_len: int) -> torch.Tensor:
    """Nearest-neighbour mask downsample: out[i] = mask[i * stride].
    Contiguous, as the attention kernels take it."""
    return mask[:, ::stride][:, :out_len].contiguous()


def masked_conv1d(x: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None, *, stride: int = 1,
                  groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Mask-preserving conv1d: the output is zeroed at invalid positions and
    the mask nearest-downsampled when stride > 1. Returns (out, out_mask)."""
    out = conv1d(x, weight, bias, stride=stride, groups=groups)
    out_mask = downsample_mask(mask, stride, out.shape[1])
    return out * out_mask[..., None].to(out.dtype), out_mask


def max_pool1d(x: torch.Tensor, *, kernel: int, stride: int,
               padding: int) -> torch.Tensor:
    """Max pool over the time axis of (B, T, C), padding with -inf."""
    return F.max_pool1d(x.transpose(1, 2), kernel, stride,
                        padding).transpose(1, 2)


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

def channel_layernorm(x: torch.Tensor, weight: torch.Tensor | None,
                      bias: torch.Tensor | None,
                      eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channels of (B, T, C): biased variance, eps inside
    the sqrt, statistics in fp32."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    res = x32 - mu
    sigma = (res * res).mean(dim=-1, keepdim=True)
    out = res * torch.rsqrt(sigma + eps)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention dispatch
# ---------------------------------------------------------------------------

def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor, *, n_head: int) -> torch.Tensor:
    """Key-masked attention over (B, T, C) streams; kv_mask (B, Tk) bool.
    The output is not masked by the query mask."""
    if q.device.type == "cpu":
        return full_attention_plain(q, k, v, kv_mask, n_head=n_head)
    return full_attention_cuda(q, k, v, kv_mask, n_head=n_head)


def band_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor, *, n_head: int,
                   window_size: int) -> torch.Tensor:
    """Sliding-window attention over (B, T, C) streams, |i - j| <= w with
    w = window_size // 2; kv_mask (B, T) bool."""
    if q.device.type == "cpu":
        return band_attention_plain(q, k, v, kv_mask, n_head=n_head,
                                    window_size=window_size)
    return band_attention_cuda(q, k, v, kv_mask, n_head=n_head,
                               window_size=window_size)


# ---------------------------------------------------------------------------
# position encodings
# ---------------------------------------------------------------------------

def sinusoid_encoding(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoid PE table, (n_position, d_hid) float32: interleaved sin/cos at
    10000^(2*(j//2)/d) frequencies (reference models/blocks.py:162-173)."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    j = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def resize_pe_linear(pe: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear re-interpolation of a (T, C) PE table to (new_len, C), as
    F.interpolate(mode='linear', align_corners=False):
    src = (dst + 0.5) * T / new_len - 0.5, clamped, linear blend."""
    t = pe.shape[0]
    dst = torch.arange(new_len, dtype=torch.float32, device=pe.device)
    src = ((dst + 0.5) * (t / new_len) - 0.5).clamp(0.0, t - 1)
    lo = src.floor().long()
    hi = (lo + 1).clamp(max=t - 1)
    frac = (src - lo.float())[:, None]
    return pe[lo] * (1.0 - frac) + pe[hi] * frac
