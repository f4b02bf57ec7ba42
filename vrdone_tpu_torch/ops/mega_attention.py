"""MEGA's fused grouped set-attention: the CUDA kernel and its plain version.

Counterpart of the TPU kernel ``vrdone_tpu/ops/pallas/mega_attention.py``
(``fused_mega_attention``). Per group g, with dg the group width,

    s   = (q_g . k_g^T) / sqrt(dg) + ub_g           ub = (u . k^T) / sqrt(dg)
    s  += log(relu(Wg(PE(q_rois, k_rois))) + 1e-6)  local flavour only
    out = softmax over the valid keys of s, times vproj_g = V @ Wv_g

and a query row with no valid key gives 0. The output is (N, g * dgo) in
``GroupedLinear``'s concatenation order; Wv's output bias is added by the
caller. The value projection and ub stay outside the kernel, one matrix
product each, as in the JAX package. The kernel source is
``csrc/mega_attention.cu`` (with the bias device code shared with the
position-bias kernel through ``csrc/mega_bias.cuh``); with the bias, one
launch of the ``bias_factors`` kernel (``ops/position_bias.py::
bias_operands``) builds its per-box factors first. The kernel cuts the
keys into splits that fill the card; with more than one, the wrapper
allocates S * g * N * (dgo + 2) floats of scratch for their partial softmax
states, which a second kernel merges.

Both versions take q, k and vproj in fp32 or in bf16 (the bf16 detector),
as the Pallas kernel does; ub, the rois and Wg stay fp32 (JAX computes ub
and the bias in fp32 under bf16 too). In bf16 every sum is fp32, P is
rounded to bf16 before P.V and the output is bf16. The fp32 streams take
the kernel on the FMA pipes, the bf16 streams a kernel whose products run
on the tensor cores (``mma.sync``), each with its own rows a block and
key splits (``launch_plan``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .position_bias import (EMBED_DIM, bias_operands, check_bias_inputs,
                            position_bias_plain)

Tensor = torch.Tensor

NEG_INF = -1e9          # the dense form's additive mask, as models/mega.py
MAX_GROUPS = 16         # the kernel gives each group one warp of a block
MAX_GROUP_DIM = 256     # dg and dgo: the largest channel bucket

# calls that launched the CUDA kernel (and, with more than one key split,
# its merge) since the count was last set to 0, of either dtype, and of its
# bf16 instances alone
launches = 0
bf16_launches = 0


def mega_attention_plain(q: Tensor, k: Tensor, vproj: Tensor, ub: Tensor,
                         valid: Tensor, q_rois: Tensor | None = None,
                         k_rois: Tensor | None = None,
                         wg_kernel: Tensor | None = None,
                         wg_bias: Tensor | None = None, *,
                         embed_dim: int = EMBED_DIM,
                         wave_length: float = 1000.0) -> Tensor:
    """The dense composition in the kernel's operand space: q (g, N, dg),
    k (g, M, dg), vproj (g, M, dgo), ub (g, M), valid (M,) bool; the rois
    and Wg's kernel (64, g) and bias (g,) add the geometric bias.

    On bf16 q, k and vproj it computes what the bf16 kernels do: the fp32
    score of the widened operands times 1/sqrt(dg), plus the fp32 ub and
    bias, an fp32 softmax whose P = exp(s - max) is rounded to bf16 and
    summed against vproj in fp32, divided by the fp32 sum of the unrounded
    P, and the output rounded to bf16. That is the Pallas kernel's
    arithmetic when the keys fit its one 128-key tile, up to the order of
    fp32 sums; over more tiles (or the bf16 CUDA kernel's 16-key tiles and
    splits) each P is rounded relative to a running max and rescaled later,
    so the two agree within bf16's rounding, not bit for bit."""
    g, n, dg = q.shape
    if q.dtype == torch.bfloat16:
        return _plain_bf16(q, k, vproj, ub, valid, q_rois, k_rois,
                           wg_kernel, wg_bias, embed_dim, wave_length)
    aff = torch.einsum("gnd,gmd->gnm", q, k) / math.sqrt(dg) + ub[:, None, :]
    if q_rois is not None:
        aff = aff + position_bias_plain(q_rois, k_rois, wg_kernel, wg_bias,
                                        embed_dim=embed_dim,
                                        wave_length=wave_length)
    aff = torch.where(valid[None, None, :], aff, NEG_INF)
    att = torch.softmax(aff, dim=-1) * valid[None, None, :].to(aff.dtype)
    out = torch.einsum("gnm,gmo->gno", att, vproj)
    return out.transpose(0, 1).reshape(n, -1)


def _plain_bf16(q, k, vproj, ub, valid, q_rois, k_rois, wg_kernel, wg_bias,
                embed_dim, wave_length) -> Tensor:
    g, n, dg = q.shape
    s = torch.einsum("gnd,gmd->gnm", q.float(), k.float()) * (
        1.0 / math.sqrt(dg)) + ub.float()[:, None, :]
    if q_rois is not None:
        s = s + position_bias_plain(q_rois, k_rois, wg_kernel, wg_bias,
                                    embed_dim=embed_dim,
                                    wave_length=wave_length)
    s = torch.where(valid[None, None, :], s, NEG_INF)
    p = (s - s.amax(-1, keepdim=True)).exp() * valid[None, None, :]
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("gnm,gmo->gno", p.to(torch.bfloat16).float(),
                       vproj.float())
    out = torch.where(l > 0, out / l.clamp_min(1e-30), 0.0)
    return out.transpose(0, 1).reshape(n, -1).to(torch.bfloat16)


@functools.cache
def _kernel() -> ctypes.CDLL:
    lib = _build.load_library("mega_attention")
    for fn in (lib.mega_attention_forward, lib.mega_attention_forward_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.POINTER(ctypes.c_float),
                          ctypes.c_void_p])
    lib.mega_attention_splits.restype = ctypes.c_int
    lib.mega_attention_splits.argtypes = ([ctypes.c_int] * 6
                                          + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.mega_attention_mma_instance.restype = ctypes.c_int
    lib.mega_attention_mma_instance.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.mega_attention_error_string.restype = ctypes.c_char_p
    lib.mega_attention_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=256)
def launch_plan(device: int, n: int, m: int, g: int, dg: int, dgo: int,
                bf16: bool = False) -> tuple[int, int]:
    """(query rows a block, key splits) of the instance the kernel takes for
    this problem on ``device``, fp32 or bf16 (the C side's rule: the fp32
    instance by dgo, the bf16 one 16 rows by the bucket of max(dg, dgo);
    then as many splits as fill the card's block slots once, from that
    instance's occupancy)."""
    lib = _kernel()
    splits, rows = ctypes.c_int(1), ctypes.c_int(0)
    with torch.cuda.device(device):
        code = lib.mega_attention_splits(n, m, g, dg, dgo, int(bf16),
                                         ctypes.byref(splits),
                                         ctypes.byref(rows))
    _build.check_launch(lib, "mega_attention", code)
    return rows.value, splits.value


def mma_instance(g: int, dg: int, dgo: int) -> tuple[int, int]:
    """(channel bucket, groups a block) of the bf16 kernel,
    ``mega_attention_mma_kernel<bucket, groups>``, for g groups of widths dg
    and dgo: a launch takes ceil(g / groups) blocks of min(g, groups) warps
    along grid.z (the C side's rule)."""
    lib = _kernel()
    bucket, groups = ctypes.c_int(0), ctypes.c_int(0)
    code = lib.mega_attention_mma_instance(g, dg, dgo, ctypes.byref(bucket),
                                           ctypes.byref(groups))
    _build.check_launch(lib, "mega_attention", code)
    return bucket.value, groups.value


def mega_attention_cuda(q: Tensor, k: Tensor, vproj: Tensor, ub: Tensor,
                        valid: Tensor, q_rois: Tensor | None = None,
                        k_rois: Tensor | None = None,
                        wg_kernel: Tensor | None = None,
                        wg_bias: Tensor | None = None, *,
                        embed_dim: int = EMBED_DIM,
                        wave_length: float = 1000.0) -> Tensor:
    """The hand-written kernel: same contract as ``mega_attention_plain``
    for CUDA tensors, q, k and vproj all fp32 (the fp32 instance) or all
    bf16 (the bf16 instance), ub fp32. Raises on what the kernel does not
    take, and when an input needs a gradient (the kernel has no
    backward)."""
    global launches, bf16_launches
    with_bias = q_rois is not None
    extra = (q_rois, k_rois, wg_kernel, wg_bias) if with_bias else ()
    _build.refuse_grad("mega_attention_cuda", q, k, vproj, ub, *extra)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q has dtype {q.dtype}: float32 or bfloat16")
    for name, t in (("q", q), ("k", k), ("vproj", vproj), ("ub", ub),
                    ("valid", valid)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device, got "
                             f"{t.device}")
        want = {"valid": torch.bool, "ub": torch.float32}.get(name, q.dtype)
        if t.dtype != want:
            raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes "
                            f"{want} (q, k and vproj share one dtype)")
    g, n, dg = q.shape
    m, dgo = k.shape[1], vproj.shape[2]
    if (k.shape != (g, m, dg) or vproj.shape[:2] != (g, m)
            or ub.shape != (g, m) or valid.shape != (m,)
            or not 1 <= g <= MAX_GROUPS or not 1 <= dg <= MAX_GROUP_DIM
            or not 1 <= dgo <= MAX_GROUP_DIM):
        raise ValueError(
            f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, vproj "
            f"{tuple(vproj.shape)}, ub {tuple(ub.shape)}, valid "
            f"{tuple(valid.shape)} (groups at most {MAX_GROUPS}, group "
            f"widths at most {MAX_GROUP_DIM})")
    if with_bias:
        check_bias_inputs(q_rois, k_rois, wg_kernel, wg_bias, embed_dim)
        if q_rois.shape[0] != n or k_rois.shape[0] != m \
                or wg_bias.shape[0] != g:
            raise ValueError("rois or Wg disagree with q and k")
    out = torch.empty((n, g * dgo), device=q.device, dtype=q.dtype)
    if n == 0:
        return out
    q, k, vproj, ub, valid = (t.contiguous() for t in (q, k, vproj, ub,
                                                       valid))
    if with_bias:
        qr, kr, a, b_t, wt, b, freqs = bias_operands(
            q_rois, k_rois, wg_kernel, wg_bias, embed_dim, wave_length)
        ptrs = [t.data_ptr() for t in (qr, kr, a, b_t, wt, b)]
    else:
        ptrs, freqs = [None] * 6, None
    lib = _kernel()
    bf16 = q.dtype == torch.bfloat16
    _, splits = launch_plan(q.device.index, n, m, g, dg, dgo, bf16)
    # the splits' partial (acc, m, l) of each (row, group), fp32 in either
    # dtype, merged into out
    part = (torch.empty(splits * g * n * (dgo + 2), device=q.device)
            if splits > 1 else None)
    fn = lib.mega_attention_forward_bf16 if bf16 else \
        lib.mega_attention_forward
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(
            q.data_ptr(), k.data_ptr(), vproj.data_ptr(), ub.data_ptr(),
            valid.data_ptr(), *ptrs, out.data_ptr(),
            None if part is None else part.data_ptr(), n, m, g, dg, dgo,
            splits, 1.0 / math.sqrt(dg), freqs, stream)
    _build.check_launch(lib, "mega_attention", code)
    launches += 1
    bf16_launches += bf16
    return out


def fused_mega_attention(q: Tensor, k: Tensor, vproj: Tensor, ub: Tensor,
                         valid: Tensor, q_rois: Tensor | None = None,
                         k_rois: Tensor | None = None,
                         wg_kernel: Tensor | None = None,
                         wg_bias: Tensor | None = None, *,
                         embed_dim: int = EMBED_DIM,
                         wave_length: float = 1000.0) -> Tensor:
    """The grouped set-attention: the kernel on CUDA tensors, the plain
    version on CPU tensors. With the rois and Wg given it adds the
    geometric bias (local flavour); without, it is the global flavour."""
    args = (q, k, vproj, ub, valid, q_rois, k_rois, wg_kernel, wg_bias)
    kw = dict(embed_dim=embed_dim, wave_length=wave_length)
    if q.device.type == "cuda":
        return mega_attention_cuda(*args, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"no kernel for device {q.device}")
    return mega_attention_plain(*args, **kw)
