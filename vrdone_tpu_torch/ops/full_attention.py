"""Key-masked full attention: the CUDA kernel and its plain version.

Counterpart of ``vrdone_tpu/ops/masked.py::full_attention`` (the dense
oracle) and of the Pallas library flash kernel that
``masked._full_attention_flash`` called on the TPU. An invalid key gets zero
probability and its value never enters the sum; every query row is computed
(callers multiply by the query mask afterwards). A row with no valid key
gives 0 in both versions here, where the JAX dense form gives NaN; the eval
path never makes such a row. The kernel source is ``csrc/masked_attention.cu``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .heads import merge_heads, split_heads

MAX_HEAD_DIM = 256

# launches of the CUDA kernel since the count was last set to 0
launches = 0


def full_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_mask: torch.Tensor, *, n_head: int
                         ) -> torch.Tensor:
    """Dense masked attention: q (B, Tq, C), k/v (B, Tk, C), kv_mask
    (B, Tk) bool (the reference the kernel is held to)."""
    d = q.shape[-1] // n_head
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh = (split_heads(x, n_head) for x in (q, k, v))
    att = torch.einsum("bhqd,bhkd->bhqk", qh * scale, kh)
    att = att.masked_fill(~kv_mask[:, None, None, :], float("-inf"))
    att = torch.softmax(att, dim=-1)
    att = torch.where(kv_mask.any(dim=-1)[:, None, None, None], att, 0.0)
    vh = vh * kv_mask[:, None, :, None].to(vh.dtype)
    return merge_heads(torch.einsum("bhqk,bhkd->bhqd", att, vh))


@functools.cache
def _kernel() -> ctypes.CDLL:
    lib = _build.load_library("masked_attention")
    fn = lib.masked_attention_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    lib.masked_attention_error_string.restype = ctypes.c_char_p
    lib.masked_attention_error_string.argtypes = [ctypes.c_int]
    return lib


def full_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: torch.Tensor, *, n_head: int
                        ) -> torch.Tensor:
    """The hand-written kernel: same contract as ``full_attention_plain``,
    for fp32 CUDA tensors. Raises on anything the kernel does not take."""
    global launches
    _build.check_attention_inputs(q, k, v, kv_mask)
    b, tq, c = q.shape
    tk = k.shape[1]
    if c % n_head:
        raise ValueError(f"{c} channels do not split into {n_head} heads")
    d = c // n_head
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds {MAX_HEAD_DIM}")
    lib = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.masked_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), b, tq, tk, n_head, d, 1.0 / math.sqrt(d),
            stream)
    _build.check_launch(lib, "masked_attention", code)
    launches += 1
    return out
