"""Key-masked full attention: the CUDA kernels and their plain versions.

Counterpart of ``vrdone_tpu/ops/masked.py::full_attention`` (the dense
oracle) and of the Pallas library flash kernel that
``masked._full_attention_flash`` called on the TPU, forward (K7) and, for
training with ``VRDONE_FLASH_TRAIN=1``, backward (K8: dQ, K9: dK and dV). An
invalid key gets zero probability and its value never enters the sum; every
query row is computed (callers multiply by the query mask afterwards). A row
with no valid key gives 0 in both versions here, where the JAX dense form
gives NaN; the eval path never makes such a row. Its lse is +inf, so P =
exp(s - lse) is 0 at every key and its gradients are 0. The kernel sources
are ``csrc/masked_attention.cu`` (K7, with the lse on request) and
``csrc/masked_attention_bwd.cu`` (K8, K9).

``FullAttention`` is the differentiable form: K7 with its lse forward, Dr =
rowsum(dO * O), K8 and K9 backward on a card; the plain versions of the same
(``full_attention_lse_plain``, ``full_attention_backward_plain``) on the
CPU. ``full_attention_cuda`` alone has no backward and refuses inputs that
need one.

Both versions take fp32 or bf16 streams (bf16 serving and training; the
kernels' bf16 instances, forward and backward, run their products on the
tensor cores, the fp32 ones on the FMA pipes). In bf16 they
follow the JAX dense form's promotions: the scores in fp32 from the
widened operands, q scaled in fp32 (the scale is a numpy float, which JAX
does not treat as weak, so ``qh * scale`` is fp32), softmax in fp32, P
rounded to bf16 before P.V, and a bf16 output. The plain version rounds the
normalised P as the dense form does; the kernel rounds the unnormalised one,
as the Pallas flash kernels do. The backward follows the library backward's
rounding points (``_flash_attention_dq_kernel``,
``_flash_attention_dkv_kernel``): the scores and dP = dO.V^T in fp32 from
the widened operands, P = exp(s - lse) and dS = P * (dP - Dr) * scale in
fp32, then P rounded to bf16 before P^T.dO and dS rounded to bf16 before
dS.K and dS^T.Q, every sum in fp32, each gradient rounded to bf16 once; lse
and Dr stay fp32. In fp32 nothing is rounded.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .band_attention import band_rowsum
from .heads import merge_heads, split_heads

# head dims of the kernel's instances: d takes the smallest that holds it
HEAD_DIM_BUCKETS = (32, 64, 128, 256)
MAX_HEAD_DIM = HEAD_DIM_BUCKETS[-1]

# launches of the CUDA kernels since the counts were last set to 0
launches = 0           # forward (K7), either dtype
bf16_launches = 0      # forward, its bf16 instances alone
lse_launches = 0       # forward launches that also wrote the lse
dq_launches = 0        # backward, dQ (K8), either dtype
dkv_launches = 0       # backward, dK and dV (K9), either dtype
bf16_dq_launches = 0   # backward, dQ, its bf16 instances alone
bf16_dkv_launches = 0  # backward, dK and dV, its bf16 instances alone
# calls of the dense form on a CUDA tensor (``ops.masked.full_attention``
# with allow_kernel=False, as in training) since the count was last set to 0
dense_calls = 0


def _scores(q: torch.Tensor, k: torch.Tensor, kv_mask: torch.Tensor,
            n_head: int) -> torch.Tensor:
    """(B, H, Tq, Tk) fp32 scaled scores of the plain versions, -inf at an
    invalid key."""
    scale = 1.0 / math.sqrt(q.shape[-1] // n_head)
    qh, kh = (split_heads(x, n_head).float() for x in (q, k))
    att = torch.einsum("bhqd,bhkd->bhqk", qh * scale, kh)
    return att.masked_fill(~kv_mask[:, None, None, :], float("-inf"))


def full_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_mask: torch.Tensor, *, n_head: int
                         ) -> torch.Tensor:
    """Dense masked attention: q (B, Tq, C), k/v (B, Tk, C), kv_mask
    (B, Tk) bool (the reference the kernel is held to). fp32 or bf16
    streams; every product is taken in fp32 and the output has q's dtype."""
    vh = split_heads(v, n_head).float()
    att = torch.softmax(_scores(q, k, kv_mask, n_head), dim=-1)
    att = torch.where(kv_mask.any(dim=-1)[:, None, None, None], att, 0.0)
    att = att.to(q.dtype).float()      # P in the streams' precision
    vh = vh * kv_mask[:, None, :, None].to(vh.dtype)
    return merge_heads(torch.einsum("bhqk,bhkd->bhqd", att, vh)).to(q.dtype)


def full_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                             kv_mask: torch.Tensor, *, n_head: int
                             ) -> torch.Tensor:
    """(B, H, Tq) fp32 log-sum-exp of each row's scaled scores over its
    valid keys, +inf for a row with none: the plain version of K7's lse
    output."""
    lse = torch.logsumexp(_scores(q, k, kv_mask, n_head), dim=-1)
    return lse.masked_fill(~kv_mask.any(-1)[:, None, None], float("inf"))


def full_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, kv_mask: torch.Tensor,
                                  lse: torch.Tensor, dr: torch.Tensor,
                                  dout: torch.Tensor, *, n_head: int
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """(dQ, dK, dV) of the full attention for the upstream gradient
    ``dout``, from the forward's (B, H, Tq) fp32 ``lse`` and ``dr =
    band_rowsum(dout, out, n_head)``: the plain version of K8 and K9, with
    the library backward's rounding points (the module docstring). An
    invalid key gets zero dK and dV, and its k and v enter no sum (as the
    kernels zero-fill them); a row with no valid key (lse +inf) has P = 0,
    so zero dQ, and adds nothing to dK or dV."""
    scale = 1.0 / math.sqrt(q.shape[-1] // n_head)
    p = torch.exp(_scores(q, k, kv_mask, n_head) - lse[..., None])
    qh, kh, vh, doh = (split_heads(x, n_head).float()
                       for x in (q, k, v, dout))
    kh, vh = (torch.where(kv_mask[:, None, :, None], x, 0.0)
              for x in (kh, vh))
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", doh, vh)
              - dr[..., None]) * scale
    p, ds = (x.to(q.dtype).float() for x in (p, ds))   # the streams' precision
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, doh)
    return tuple(merge_heads(g).to(x.dtype)
                 for g, x in ((dq, q), (dk, k), (dv, v)))


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
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
    lib.masked_attention_error_string.restype = ctypes.c_char_p
    lib.masked_attention_error_string.argtypes = [ctypes.c_int]
    lib.masked_attention_instance.restype = ctypes.c_int
    lib.masked_attention_instance.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2)
    return lib


@functools.cache
def _bwd_kernel() -> ctypes.CDLL:
    lib = _build.load_library("masked_attention_bwd")
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    for fn, n_ptr in ((lib.masked_attention_backward_dq, 8),
                      (lib.masked_attention_backward_dq_bf16, 8),
                      (lib.masked_attention_backward_dkv, 9),
                      (lib.masked_attention_backward_dkv_bf16, 9)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + tail
    lib.masked_attention_backward_instance.restype = ctypes.c_int
    lib.masked_attention_backward_instance.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3)
    lib.masked_attention_bwd_error_string.restype = ctypes.c_char_p
    lib.masked_attention_bwd_error_string.argtypes = [ctypes.c_int]
    return lib


def _shape(q, k, v, kv_mask, n_head) -> tuple[int, int, int, int]:
    """Check what the kernels take; returns (B, Tq, Tk, d)."""
    _build.check_attention_inputs(q, k, v, kv_mask)
    b, tq, c = q.shape
    if c % n_head:
        raise ValueError(f"{c} channels do not split into {n_head} heads")
    d = c // n_head
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds {MAX_HEAD_DIM}")
    return b, tq, k.shape[1], d


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def full_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: torch.Tensor, *, n_head: int,
                        with_lse: bool = False):
    """The forward kernel (K7): same contract as ``full_attention_plain``,
    for fp32 or bf16 CUDA tensors (one dtype; bf16 streams take the
    tensor-core instances). With ``with_lse`` it returns ``(out, lse)``, lse
    (B, H, Tq) fp32 as ``full_attention_lse_plain`` gives it. Raises on
    anything the kernel does not take, and when an input needs a gradient
    (use ``FullAttention`` for that)."""
    global launches, bf16_launches, lse_launches
    _build.refuse_grad("full_attention_cuda", q, k, v)
    b, tq, tk, d = _shape(q, k, v, kv_mask, n_head)
    lib = _kernel()
    bf16 = q.dtype == torch.bfloat16
    fn = (lib.masked_attention_forward_bf16 if bf16
          else lib.masked_attention_forward)
    out = torch.empty_like(q)
    lse = (torch.empty((b, n_head, tq), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, tq,
            tk, n_head, d, 1.0 / math.sqrt(d), _stream(q))
    _build.check_launch(lib, "masked_attention", code)
    launches += 1
    bf16_launches += bf16
    lse_launches += with_lse
    return (out, lse) if with_lse else out


def _backward_args(q, k, v, kv_mask, lse, dr, dout, n_head):
    b, tq, tk, d = _shape(q, k, v, kv_mask, n_head)
    if dout.dtype != q.dtype:
        raise TypeError(f"dout must have q's dtype {q.dtype}, got "
                        f"{dout.dtype}: q, k, v and dout share one dtype")
    if (dout.shape != q.shape or dout.device != q.device
            or not dout.is_contiguous()):
        raise ValueError("dout must be a contiguous tensor like q")
    for name, x in (("lse", lse), ("dr", dr)):
        if (x.shape != (b, n_head, tq) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 "
                             f"{(b, n_head, tq)} on q's device")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            lse.data_ptr(), dr.data_ptr(), dout.data_ptr())
    return ptrs, (b, tq, tk, n_head, d, 1.0 / math.sqrt(d))


def full_attention_dq_cuda(q, k, v, kv_mask, lse, dr, dout, *, n_head: int
                           ) -> torch.Tensor:
    """dQ of the full attention for the upstream gradient ``dout``, from
    K7's lse and ``dr = band_rowsum(dout, out, n_head)``: one launch of K8,
    for fp32 or bf16 streams (q, k, v and dout in one dtype) with fp32 lse
    and dr. Same contract as ``full_attention_backward_plain``'s dQ."""
    global dq_launches, bf16_dq_launches
    ptrs, dims = _backward_args(q, k, v, kv_mask, lse, dr, dout, n_head)
    lib = _bwd_kernel()
    bf16 = q.dtype == torch.bfloat16
    fn = (lib.masked_attention_backward_dq_bf16 if bf16
          else lib.masked_attention_backward_dq)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = fn(*ptrs, dq.data_ptr(), *dims, _stream(q))
    _build.check_launch(lib, "masked_attention_bwd", code)
    dq_launches += 1
    bf16_dq_launches += bf16
    return dq


def full_attention_dkv_cuda(q, k, v, kv_mask, lse, dr, dout, *, n_head: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), from the same inputs as ``full_attention_dq_cuda``: one
    launch of K9."""
    global dkv_launches, bf16_dkv_launches
    ptrs, dims = _backward_args(q, k, v, kv_mask, lse, dr, dout, n_head)
    lib = _bwd_kernel()
    bf16 = q.dtype == torch.bfloat16
    fn = (lib.masked_attention_backward_dkv_bf16 if bf16
          else lib.masked_attention_backward_dkv)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, _stream(q))
    _build.check_launch(lib, "masked_attention_bwd", code)
    dkv_launches += 1
    bf16_dkv_launches += bf16
    return dk, dv


def backward_instance(device: int, n_own: int, d: int,
                      dtype: torch.dtype = torch.float32) -> dict:
    """The instance K8 (``n_own`` = Tq) or K9 (``n_own`` = Tk) takes on
    ``device`` for head dim ``d`` in ``dtype`` streams, as the C side picks
    it (``csrc/masked_attention_bwd.cu::pick_backward``): ``rows`` owner
    rows a block, the head-dim ``bucket`` and ``tile`` partner rows a tile.
    fp32 runs the FMA body ``masked_attention_bwd_kernel<bucket, rows / 16,
    K9>`` (128 threads), bf16 the tensor-core kernel
    ``masked_attention_bwd_mma_kernel<bucket, rows / 16, tile, K9>`` (a warp
    for each 16 rows)."""
    rows, bucket, tile = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib = _bwd_kernel()
    with torch.cuda.device(device):
        code = lib.masked_attention_backward_instance(
            n_own, d, dtype.itemsize,
            ctypes.byref(rows), ctypes.byref(bucket), ctypes.byref(tile))
    _build.check_launch(lib, "masked_attention_bwd", code)
    return {"rows": rows.value, "bucket": bucket.value, "tile": tile.value}


class FullAttention(torch.autograd.Function):
    """Differentiable full attention, the flash-training form (the port of
    the library flash kernel's custom VJP that ``masked.
    _full_attention_flash`` trains through): K7 with its lse forward, Dr =
    rowsum(dO * O), K8 and K9 backward on a card; on the CPU the plain
    versions of the same. fp32 or bf16 streams, lse and Dr fp32 either
    way. On a card it never falls back to a plain version: a build or
    launch failure raises."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, n_head):
        if q.device.type == "cpu":
            out = full_attention_plain(q, k, v, kv_mask, n_head=n_head)
            lse = full_attention_lse_plain(q, k, kv_mask, n_head=n_head)
        else:
            out, lse = full_attention_cuda(q, k, v, kv_mask, n_head=n_head,
                                           with_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.n_head = n_head
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        args = (q, k, v, kv_mask, lse, band_rowsum(dout, out, ctx.n_head),
                dout)
        if q.device.type == "cpu":
            dq, dk, dv = full_attention_backward_plain(*args,
                                                       n_head=ctx.n_head)
        else:
            dq = full_attention_dq_cuda(*args, n_head=ctx.n_head)
            dk, dv = full_attention_dkv_cuda(*args, n_head=ctx.n_head)
        return dq, dk, dv, None, None
