"""Key-masked full attention: the CUDA kernel and its plain version.

Counterpart of ``vrdone_tpu/ops/masked.py::full_attention`` (the dense
oracle) and of the Pallas library flash kernel that
``masked._full_attention_flash`` called on the TPU. An invalid key gets zero
probability and its value never enters the sum; every query row is computed
(callers multiply by the query mask afterwards). A row with no valid key
gives 0 in both versions here, where the JAX dense form gives NaN; the eval
path never makes such a row. The kernel source is ``csrc/masked_attention.cu``.

Both versions take fp32 or bf16 streams (bf16 serving; the kernel's bf16
instances run their products on the tensor cores). In bf16 they
follow the JAX dense form's promotions: the scores in fp32 from the
widened operands, q scaled in fp32 (the scale is a numpy float, which JAX
does not treat as weak, so ``qh * scale`` is fp32), softmax in fp32, P
rounded to bf16 before P.V, and a bf16 output. The plain version rounds the
normalised P as the dense form does; the kernel rounds the unnormalised one,
as the Pallas flash kernels do.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .heads import merge_heads, split_heads

# head dims of the kernel's instances: d takes the smallest that holds it
HEAD_DIM_BUCKETS = (32, 64, 128, 256)
MAX_HEAD_DIM = HEAD_DIM_BUCKETS[-1]

# launches of the CUDA kernel since the count was last set to 0, of either
# dtype, and of its bf16 instances alone
launches = 0
bf16_launches = 0
# calls of the dense form on a CUDA tensor (``ops.masked.full_attention``
# with allow_kernel=False, as in training) since the count was last set to 0
dense_calls = 0


def full_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_mask: torch.Tensor, *, n_head: int
                         ) -> torch.Tensor:
    """Dense masked attention: q (B, Tq, C), k/v (B, Tk, C), kv_mask
    (B, Tk) bool (the reference the kernel is held to). fp32 or bf16
    streams; every product is taken in fp32 and the output has q's dtype."""
    d = q.shape[-1] // n_head
    scale = 1.0 / math.sqrt(d)
    qh, kh, vh = (split_heads(x, n_head).float() for x in (q, k, v))
    att = torch.einsum("bhqd,bhkd->bhqk", qh * scale, kh)
    att = att.masked_fill(~kv_mask[:, None, None, :], float("-inf"))
    att = torch.softmax(att, dim=-1)
    att = torch.where(kv_mask.any(dim=-1)[:, None, None, None], att, 0.0)
    att = att.to(q.dtype).float()      # P in the streams' precision
    vh = vh * kv_mask[:, None, :, None].to(vh.dtype)
    return merge_heads(torch.einsum("bhqk,bhkd->bhqd", att, vh)).to(q.dtype)


def _variant(tq: int, d: int, dtype: torch.dtype = torch.float32
             ) -> tuple[int, int]:
    """(query rows a block, head-dim bucket) of the kernel instance that
    takes ``tq`` queries of head dim ``d`` in ``dtype`` streams: 16 rows for
    the predictor's few queries, else 48 where that pads fewer rows than 64
    (Tq = 96), else 64; in bf16 above Tq = 64 (but at the 256 bucket) 96 or
    128 rows, two 16-row tiles a warp, whichever pads fewer (128 on a tie);
    the smallest bucket that holds d. The rule of
    ``csrc/masked_attention.cu::pick_instance`` (a ``cuda`` test holds the
    two together); the choice of vector or scalar copies is made at the
    launch. Raises for a head dim the kernel does not take."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside 1..{MAX_HEAD_DIM}")
    bucket = next(b for b in HEAD_DIM_BUCKETS if d <= b)
    if dtype == torch.bfloat16 and tq > 64 and bucket <= 128:
        return 96 if -tq % 96 < -tq % 128 else 128, bucket
    rows = 16 if tq <= 16 else 48 if -tq % 48 < -tq % 64 else 64
    return rows, bucket


@functools.cache
def _kernel() -> ctypes.CDLL:
    lib = _build.load_library("masked_attention")
    for fn in (lib.masked_attention_forward,
               lib.masked_attention_forward_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
    lib.masked_attention_error_string.restype = ctypes.c_char_p
    lib.masked_attention_error_string.argtypes = [ctypes.c_int]
    lib.masked_attention_instance.restype = ctypes.c_int
    lib.masked_attention_instance.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2)
    return lib


def full_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: torch.Tensor, *, n_head: int
                        ) -> torch.Tensor:
    """The hand-written kernel: same contract as ``full_attention_plain``,
    for fp32 or bf16 CUDA tensors (one dtype; bf16 streams take the
    tensor-core instances). Raises on anything the kernel does not take,
    and when an input needs a gradient (the kernel has no backward)."""
    global launches, bf16_launches
    _build.refuse_grad("full_attention_cuda", q, k, v)
    _build.check_attention_inputs(q, k, v, kv_mask)
    b, tq, c = q.shape
    tk = k.shape[1]
    if c % n_head:
        raise ValueError(f"{c} channels do not split into {n_head} heads")
    d = c // n_head
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds {MAX_HEAD_DIM}")
    lib = _kernel()
    bf16 = q.dtype == torch.bfloat16
    fn = (lib.masked_attention_forward_bf16 if bf16
          else lib.masked_attention_forward)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), b, tq, tk, n_head, d, 1.0 / math.sqrt(d),
            stream)
    _build.check_launch(lib, "masked_attention", code)
    launches += 1
    bf16_launches += bf16
    return out
