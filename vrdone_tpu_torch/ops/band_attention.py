"""Banded (sliding-window) attention: the CUDA kernel and its plain version.

Counterpart of the TPU kernel ``vrdone_tpu/ops/pallas/band_attention.py``
(forward, no relative-position bias) and of its dense oracle
``vrdone_tpu/ops/masked.py::band_attention``. Query i attends keys j with
|i - j| <= w = window_size // 2; an in-band invalid key gets an additive
-1e4 (not -inf); out-of-band keys are excluded; a row whose query is
invalid is zeroed. The kernel source is ``csrc/band_attention.cu``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .heads import merge_heads, split_heads

NEG_BIG = -1e4        # additive mask of an invalid in-band key
MAX_HALF_WINDOW = 15  # the kernel gives one lane to each of 2w + 1 keys
MAX_HEAD_DIM = 256

# launches of the CUDA kernel since the count was last set to 0
launches = 0


def band_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_mask: torch.Tensor, *, n_head: int,
                         window_size: int) -> torch.Tensor:
    """Dense band-masked attention over (B, T, C) streams (the reference
    the kernel is held to). kv_mask: (B, T) bool. q is unscaled."""
    t = q.shape[1]
    w = window_size // 2
    d = q.shape[-1] // n_head
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh = (split_heads(x, n_head) for x in (q, k, v))
    att = torch.einsum("bhqd,bhkd->bhqk", qh * scale, kh)
    idx = torch.arange(t, device=q.device)
    in_band = (idx[None, :] - idx[:, None]).abs() <= w
    att = att + NEG_BIG * (~kv_mask)[:, None, None, :].to(att.dtype)
    att = att.masked_fill(~in_band, float("-inf"))
    att = torch.softmax(att, dim=-1)
    att = att * kv_mask[:, None, :, None].to(att.dtype)
    return merge_heads(torch.einsum("bhqk,bhkd->bhqd", att, vh))


@functools.cache
def _kernel() -> ctypes.CDLL:
    lib = _build.load_library("band_attention")
    fn = lib.band_attention_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    lib.band_attention_error_string.restype = ctypes.c_char_p
    lib.band_attention_error_string.argtypes = [ctypes.c_int]
    return lib


def band_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: torch.Tensor, *, n_head: int,
                        window_size: int) -> torch.Tensor:
    """The hand-written kernel: same contract as ``band_attention_plain``,
    for fp32 CUDA tensors. Raises on anything the kernel does not take."""
    global launches
    _build.check_attention_inputs(q, k, v, kv_mask)
    b, t, c = q.shape
    if k.shape[1] != t:
        raise ValueError(f"band attention needs Tq == Tk, got {t} and "
                         f"{k.shape[1]}")
    if c % n_head:
        raise ValueError(f"{c} channels do not split into {n_head} heads")
    d = c // n_head
    w = window_size // 2
    if d > MAX_HEAD_DIM or w > MAX_HALF_WINDOW:
        raise ValueError(f"head dim {d} (max {MAX_HEAD_DIM}) or half "
                         f"window {w} (max {MAX_HALF_WINDOW}) too large")
    lib = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.band_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), b, t, n_head, d, w,
            1.0 / math.sqrt(d), stream)
    _build.check_launch(lib, "band_attention", code)
    launches += 1
    return out
