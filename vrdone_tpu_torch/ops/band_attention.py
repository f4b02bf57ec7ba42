"""Banded (sliding-window) attention: the CUDA kernels and their plain
version.

Counterpart of the TPU kernels ``vrdone_tpu/ops/pallas/band_attention.py``
(the forward with its log-sum-exp, the forward with a relative-position
bias, and the dQ and dK/dV backward kernels of its custom VJP) and of the
dense oracle ``vrdone_tpu/ops/masked.py::band_attention``. Query i attends
keys j with |i - j| <= w = window_size // 2; with a bias, rel_pe[h,
clip(j - i + w, 0, window_size - 1)] is added to the scaled score; an
in-band invalid key gets an additive -1e4 (not -inf); out-of-band keys are
excluded; a row whose query is invalid is zeroed. The kernel source is
``csrc/band_attention.cu``.

``BandAttention`` is the differentiable CUDA form without a bias: its
forward launches the forward kernel with the lse output and its backward
the dQ and dK/dV kernels. ``BandAttentionPE`` is the one with a bias (the
port of ``masked._band_pallas_pe``): the bias kernel forward and the dense
form's autograd as the backward, as the JAX package pairs them.
``band_attention_cuda`` and ``band_attention_pe_cuda`` alone have no
backward and refuse inputs that need one. The C side picks each kernel's
instance (rows a tile, tiles a block walks, head-dim bucket, vector or
scalar copies; for the backward also owner rows a warp) from the shape and
the card; ``forward_instance`` and ``backward_instance`` report it.

The forward, with or without a bias (K4, K1), also takes bf16 streams
(bf16 serving and training), through its own kernel on the tensor cores
(``mma.sync``: the scores and P.V of each 16-row tile over its band). Its
plain version then follows the JAX dense form's promotions: the scores in
fp32 from the widened operands (q scaled in fp32, as the dense form's numpy
scale makes it; the kernel, as Pallas does, scales the fp32 dot instead),
a bf16 bias table widened to fp32 before it is added, softmax in fp32, P
rounded to bf16 before P.V, a bf16 output and an fp32 lse. The backward
(K2/K3) takes bf16 streams too (bf16 training), through a kernel of its own
on the tensor cores (``mma.sync`` over each 16-row owner tile's band: S
and dP, then dQ, or dV and dK, with P and dS kept in fp32 by a bf16 hi/lo
split), with the Pallas backward's promotions: ``band_backward_plain`` is
its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .heads import merge_heads, split_heads

NEG_BIG = -1e4        # additive mask of an invalid in-band key
MAX_HALF_WINDOW = 15  # the 2w + 1 keys of a row fit one warp's lanes
MAX_HEAD_DIM = 256

# launches of each CUDA kernel since the counts were last set to 0
launches = 0           # forward, either dtype
bf16_launches = 0      # forward, its bf16 instances alone
pe_launches = 0        # forward with the relative-position bias, either dtype
pe_bf16_launches = 0   # forward with the bias, its bf16 instances alone
dq_launches = 0        # backward, dQ, either dtype
dkv_launches = 0       # backward, dK and dV, either dtype
bf16_dq_launches = 0   # backward, dQ, its bf16 instances alone
bf16_dkv_launches = 0  # backward, dK and dV, its bf16 instances alone


def _band_scores(q, k, kv_mask, n_head, window_size, rel_pe=None):
    """(B, H, T, T) masked, scaled scores of the plain version, the bias
    added before the key mask as in the JAX package."""
    t = q.shape[1]
    w = window_size // 2
    d = q.shape[-1] // n_head
    scale = 1.0 / math.sqrt(d)
    qh, kh = split_heads(q, n_head).float(), split_heads(k, n_head).float()
    att = torch.einsum("bhqd,bhkd->bhqk", qh * scale, kh)
    idx = torch.arange(t, device=q.device)
    relpos = idx[None, :] - idx[:, None]               # j - i
    if rel_pe is not None:
        att = att + rel_pe[:, (relpos + w).clamp(0, window_size - 1)][None]
    att = att + NEG_BIG * (~kv_mask)[:, None, None, :].to(att.dtype)
    return att.masked_fill(~(relpos.abs() <= w), float("-inf"))


def _band_plain(q, k, v, kv_mask, n_head, window_size, rel_pe=None):
    att = torch.softmax(_band_scores(q, k, kv_mask, n_head, window_size,
                                     rel_pe), dim=-1)
    att = att * kv_mask[:, None, :, None].to(att.dtype)
    att = att.to(v.dtype).float()      # P in the streams' precision
    return merge_heads(torch.einsum("bhqk,bhkd->bhqd", att,
                                    split_heads(v, n_head).float())
                       ).to(v.dtype)


def band_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_mask: torch.Tensor, *, n_head: int,
                         window_size: int) -> torch.Tensor:
    """Dense band-masked attention over (B, T, C) streams (the reference
    the kernels are held to; its autograd backward is what the backward
    kernels are held to). kv_mask: (B, T) bool. q is unscaled. fp32 or bf16
    streams; every product is taken in fp32 and the output has their
    dtype."""
    return _band_plain(q, k, v, kv_mask, n_head, window_size)


def band_attention_pe_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, kv_mask: torch.Tensor,
                            rel_pe: torch.Tensor, *, n_head: int,
                            window_size: int) -> torch.Tensor:
    """``band_attention_plain`` with the relative-position bias rel_pe
    (n_head, window_size): the reference the bias kernel is held to, and
    through its autograd the backward of ``BandAttentionPE``."""
    return _band_plain(q, k, v, kv_mask, n_head, window_size, rel_pe)


def band_lse_plain(q: torch.Tensor, k: torch.Tensor, kv_mask: torch.Tensor,
                   *, n_head: int, window_size: int) -> torch.Tensor:
    """(B, H, T) fp32 log-sum-exp of each row's band scores: the plain
    version of the forward kernel's ``lse`` output."""
    return torch.logsumexp(_band_scores(q, k, kv_mask, n_head, window_size),
                           dim=-1)


def band_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: torch.Tensor, lse: torch.Tensor,
                        dr: torch.Tensor, dout: torch.Tensor, *, n_head: int,
                        window_size: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dQ, dK, dV) of the band attention for the upstream gradient
    ``dout``, from the forward's (B, H, T) fp32 ``lse`` and
    ``dr = band_rowsum(dout, out)``: the plain version of the dQ (K2) and
    dK/dV (K3) kernels. The Pallas backward's promotions
    (``_dq_kernel``, ``_dkv_kernel``): the streams widened to fp32, the
    scores rebuilt as the forward builds them, P = exp(s - lse) and dS =
    P * (dO . V - Dr) in fp32 (P is not rounded, where the forward rounded
    it before P.V), and each gradient rounded to the streams' dtype once.
    An invalid query row has P = 0: dQ = 0 there, and it gives nothing to
    dK or dV."""
    d = q.shape[-1] // n_head
    scale = 1.0 / math.sqrt(d)
    s = _band_scores(q, k, kv_mask, n_head, window_size)
    p = torch.exp(s - lse[..., None]) * kv_mask[:, None, :, None]
    qh, kh, vh, doh = (split_heads(x, n_head).float()
                       for x in (q, k, v, dout))
    dp = torch.einsum("bhqd,bhkd->bhqk", doh, vh)
    ds = p * (dp - dr[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kh) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qh) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, doh)
    return tuple(merge_heads(g).to(x.dtype)
                 for g, x in ((dq, q), (dk, k), (dv, v)))


@functools.cache
def _kernel() -> ctypes.CDLL:
    lib = _build.load_library("band_attention")
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    for fn, n_ptr in ((lib.band_attention_forward, 6),
                      (lib.band_attention_forward_bf16, 6),
                      (lib.band_attention_backward_dq, 8),
                      (lib.band_attention_backward_dq_bf16, 8),
                      (lib.band_attention_backward_dkv, 9),
                      (lib.band_attention_backward_dkv_bf16, 9)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + tail
    lib.band_attention_pe_forward.restype = ctypes.c_int
    lib.band_attention_pe_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    lib.band_attention_pe_forward_bf16.restype = ctypes.c_int
    lib.band_attention_pe_forward_bf16.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    lib.band_attention_instance.restype = ctypes.c_int
    lib.band_attention_instance.argtypes = (
        [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)] * 7)
    lib.band_attention_backward_instance.restype = ctypes.c_int
    lib.band_attention_backward_instance.argtypes = (
        [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)] * 8)
    lib.band_attention_error_string.restype = ctypes.c_char_p
    lib.band_attention_error_string.argtypes = [ctypes.c_int]
    return lib


def _read_instance(device: int, fn, args: tuple, keys: tuple) -> dict:
    """Call the C instance report ``fn`` on ``device`` with ``args`` and
    one int out-parameter for each of ``keys``."""
    vals = [ctypes.c_int() for _ in keys]
    with torch.cuda.device(device):
        code = fn(*args, *(ctypes.byref(x) for x in vals))
    _build.check_launch(_kernel(), "band_attention", code)
    inst = {k: x.value for k, x in zip(keys, vals)}
    inst["vec"] = bool(inst["vec"])
    return inst


def forward_instance(device: int, b: int, t: int, n_head: int, d: int,
                     window_size: int, pe: bool = False,
                     dtype: torch.dtype = torch.float32) -> dict:
    """The instance the forward kernel (K1, or K4 with ``pe``) takes on
    ``device`` for 16-byte-aligned (B, T, n_head * d) streams of ``dtype``
    (fp32 or bf16): ``rows`` query rows a tile, ``tiles`` row tiles
    a (batch, head), ``per_block`` tiles a block walks (double-buffered when
    more than 1), the head-dim ``bucket``, ``vec`` (16-byte copies; False
    for the scalar instance) and ``warps`` a block. fp32 runs
    ``band_forward_kernel<bucket, vec, pe, float>`` (8 * rows threads, 4
    rows a warp); bf16 the tensor-core kernel
    ``band_forward_mma_kernel<bucket, vec, pe, key_tiles>`` (one tile of
    16, 32 or 64 rows a block of 4 warps, rows / 16 of them a 16-row
    query tile each; ``key_tiles`` n8 tiles of keys a warp: 3 up to w = 4,
    else 6; 0 for fp32)."""
    return _read_instance(
        device, _kernel().band_attention_instance,
        (b, t, n_head, d, window_size // 2, int(pe), dtype.itemsize),
        ("rows", "tiles", "per_block", "bucket", "vec", "warps",
         "key_tiles"))


def backward_instance(device: int, b: int, t: int, n_head: int, d: int,
                      window_size: int, dkv: bool = False,
                      dtype: torch.dtype = torch.float32) -> dict:
    """The instance the dQ kernel (K2), or with ``dkv`` the dK/dV kernel
    (K3), takes on ``device`` for 16-byte-aligned (B, T, n_head * d)
    streams of ``dtype`` (fp32 or bf16): ``rows_warp`` owner rows a warp,
    and ``rows``, ``tiles``, ``per_block``, ``bucket``, ``vec``, ``warps``
    and ``key_tiles`` as ``forward_instance`` has them. fp32 runs
    ``band_backward_kernel<bucket, vec, dkv, rows_warp, float>`` (2 or 4
    owner rows a warp, 32 * rows / rows_warp threads, walking up to 2 tiles
    a block); bf16 the tensor-core kernel
    ``band_backward_mma_kernel<bucket, vec, dkv, key_tiles>`` (one tile of
    16, 32 or 64 owner rows a block of 4 warps, rows / 16 of them a 16-row
    tile each, so ``rows_warp`` is 16; ``key_tiles`` n8 tiles of partners
    a warp: 3 up to w = 4, else 6; 0 for fp32)."""
    return _read_instance(
        device, _kernel().band_attention_backward_instance,
        (b, t, n_head, d, window_size // 2, int(dkv), dtype.itemsize),
        ("rows_warp", "rows", "tiles", "per_block", "bucket", "vec",
         "warps", "key_tiles"))


def _shape(q, k, v, kv_mask, n_head, window_size):
    """Check what the kernels take; returns (B, T, d, w, scale)."""
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
    return b, t, d, w, 1.0 / math.sqrt(d)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def band_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_mask: torch.Tensor, *, n_head: int,
                        window_size: int, with_lse: bool = False):
    """The forward kernel: same contract as ``band_attention_plain``, for
    fp32 or bf16 CUDA tensors (one dtype; the bf16 instances with bf16
    streams). With ``with_lse`` it returns ``(out, lse)``, lse (B, H, T)
    fp32. Raises on anything the kernel does not take, and when an input
    needs a gradient (use ``BandAttention`` for that)."""
    global launches, bf16_launches
    _build.refuse_grad("band_attention_cuda", q, k, v)
    b, t, d, w, scale = _shape(q, k, v, kv_mask, n_head, window_size)
    lib = _kernel()
    bf16 = q.dtype == torch.bfloat16
    fn = (lib.band_attention_forward_bf16 if bf16
          else lib.band_attention_forward)
    out = torch.empty_like(q)
    lse = (torch.empty((b, n_head, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, t, n_head, d, w, scale, _stream(q))
    _build.check_launch(lib, "band_attention", code)
    launches += 1
    bf16_launches += bf16
    return (out, lse) if with_lse else out


def band_attention_pe_cuda(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_mask: torch.Tensor,
                           rel_pe: torch.Tensor, *, n_head: int,
                           window_size: int) -> torch.Tensor:
    """The bias forward kernel (one launch): same contract as
    ``band_attention_pe_plain``, for fp32 or bf16 CUDA tensors (one dtype;
    the bf16 instance with bf16 streams), rel_pe a contiguous (n_head,
    window_size) table on q's device in q's dtype or fp32. The bf16
    instance reads a bf16 table as it is, widening each entry in the
    kernel, so no cast runs before the launch. Raises on anything the
    kernel does not take, and when an input needs a gradient (use
    ``BandAttentionPE`` for that)."""
    global pe_launches, pe_bf16_launches
    _build.refuse_grad("band_attention_pe_cuda", q, k, v, rel_pe)
    b, t, d, w, scale = _shape(q, k, v, kv_mask, n_head, window_size)
    if (rel_pe.shape != (n_head, window_size)
            or rel_pe.dtype not in (q.dtype, torch.float32)
            or rel_pe.device != q.device or not rel_pe.is_contiguous()):
        raise ValueError(f"rel_pe must be a contiguous "
                         f"{(n_head, window_size)} table on q's device in "
                         f"q's dtype or fp32, got {tuple(rel_pe.shape)} "
                         f"{rel_pe.dtype} on {rel_pe.device}")
    lib = _kernel()
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr())
    dims = (b, t, n_head, d, w, window_size, scale, _stream(q))
    with torch.cuda.device(q.device):
        if bf16:
            code = lib.band_attention_pe_forward_bf16(
                *ptrs, rel_pe.data_ptr(), rel_pe.dtype.itemsize,
                out.data_ptr(), *dims)
        else:
            code = lib.band_attention_pe_forward(
                *ptrs, rel_pe.data_ptr(), out.data_ptr(), *dims)
    _build.check_launch(lib, "band_attention", code)
    pe_launches += 1
    pe_bf16_launches += bf16
    return out


def band_rowsum(dout: torch.Tensor, out: torch.Tensor, n_head: int
                ) -> torch.Tensor:
    """Dr = rowsum(dO * O): (B, H, T) fp32, a plain op on the streams
    widened to fp32 (as in JAX, ``band_attention.py:251-252``)."""
    b, t, c = out.shape
    return ((dout.float() * out.float()).view(b, t, n_head, c // n_head)
            .sum(-1).transpose(1, 2).contiguous())


def _backward_args(q, k, v, kv_mask, lse, dr, dout, n_head, window_size):
    b, t, d, w, scale = _shape(q, k, v, kv_mask, n_head, window_size)
    if dout.dtype != q.dtype:
        raise TypeError(f"dout must have q's dtype {q.dtype}, got "
                        f"{dout.dtype}: q, k, v and dout share one dtype")
    if (dout.shape != q.shape or dout.device != q.device
            or not dout.is_contiguous()):
        raise ValueError("dout must be a contiguous tensor like q")
    for name, x in (("lse", lse), ("dr", dr)):
        if (x.shape != (b, n_head, t) or x.dtype != torch.float32
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 "
                             f"{(b, n_head, t)} on q's device")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
            lse.data_ptr(), dr.data_ptr(), dout.data_ptr())
    return ptrs, (b, t, n_head, d, w, scale)


def band_attention_dq_cuda(q, k, v, kv_mask, lse, dr, dout, *, n_head: int,
                           window_size: int) -> torch.Tensor:
    """dQ of the band attention for the upstream gradient ``dout``, from
    the forward's lse and ``band_rowsum(dout, out)``: one launch of the dQ
    kernel, for fp32 or bf16 streams (q, k, v and dout in one dtype; the
    bf16 instance with bf16 streams) with fp32 lse and dr. Same contract as
    ``band_backward_plain``'s dQ."""
    global dq_launches, bf16_dq_launches
    ptrs, dims = _backward_args(q, k, v, kv_mask, lse, dr, dout, n_head,
                                window_size)
    lib = _kernel()
    bf16 = q.dtype == torch.bfloat16
    fn = (lib.band_attention_backward_dq_bf16 if bf16
          else lib.band_attention_backward_dq)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = fn(*ptrs, dq.data_ptr(), *dims, _stream(q))
    _build.check_launch(lib, "band_attention", code)
    dq_launches += 1
    bf16_dq_launches += bf16
    return dq


def band_attention_dkv_cuda(q, k, v, kv_mask, lse, dr, dout, *, n_head: int,
                            window_size: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), from the same inputs as ``band_attention_dq_cuda``: one
    launch of the dK/dV kernel (its bf16 instance with bf16 streams)."""
    global dkv_launches, bf16_dkv_launches
    ptrs, dims = _backward_args(q, k, v, kv_mask, lse, dr, dout, n_head,
                                window_size)
    lib = _kernel()
    bf16 = q.dtype == torch.bfloat16
    fn = (lib.band_attention_backward_dkv_bf16 if bf16
          else lib.band_attention_backward_dkv)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        code = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, _stream(q))
    _build.check_launch(lib, "band_attention", code)
    dkv_launches += 1
    bf16_dkv_launches += bf16
    return dk, dv


class BandAttention(torch.autograd.Function):
    """Differentiable band attention on the card: the forward kernel with
    its lse, and the dQ and dK/dV kernels as the backward (the port of the
    JAX package's ``_band_core`` custom VJP); fp32 or bf16 streams, the
    lse and Dr fp32 either way."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, n_head, window_size):
        out, lse = band_attention_cuda(q, k, v, kv_mask, n_head=n_head,
                                       window_size=window_size,
                                       with_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.n_head, ctx.window_size = n_head, window_size
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        args = (q, k, v, kv_mask, lse, band_rowsum(dout, out, ctx.n_head),
                dout)
        kw = dict(n_head=ctx.n_head, window_size=ctx.window_size)
        dq = band_attention_dq_cuda(*args, **kw)
        dk, dv = band_attention_dkv_cuda(*args, **kw)
        return dq, dk, dv, None, None, None


class BandAttentionPE(torch.autograd.Function):
    """Differentiable band attention with the relative-position bias on the
    card (the port of the JAX package's ``masked._band_pallas_pe`` custom
    VJP): the bias kernel as the forward, and as the backward autograd of
    the dense form, recomputed, for dq, dk, dv and d rel_pe, each in its
    leaf's dtype (fp32, or bf16 in the bf16 train step). The JAX package
    has no backward kernel for the bias, so neither has the port."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, rel_pe, n_head, window_size):
        ctx.save_for_backward(q, k, v, kv_mask, rel_pe)
        ctx.n_head, ctx.window_size = n_head, window_size
        return band_attention_pe_cuda(q, k, v, kv_mask, rel_pe,
                                      n_head=n_head, window_size=window_size)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, rel_pe = ctx.saved_tensors
        leaves = [x.detach().requires_grad_() for x in (q, k, v, rel_pe)]
        with torch.enable_grad():
            out = _band_plain(*leaves[:3], kv_mask, ctx.n_head,
                              ctx.window_size, leaves[3])
        dq, dk, dv, dpe = torch.autograd.grad(out, leaves, dout)
        return dq, dk, dv, None, dpe, None, None
