"""MEGA's geometric position bias: the CUDA kernel and its plain version.

Counterpart of the TPU kernel ``vrdone_tpu/ops/pallas/position_bias.py``
(``fused_position_bias``, ``pe_setup``). The bias of query box n and key box
m in group g is

    log(relu(PE(q_rois[n], k_rois[m]) @ Wg[:, g] + b[g]) + 1e-6)

with PE the 64-dim sinusoid embedding of the pair's log-space geometry
(``models/mega.py::cal_position_embedding``). Of its four features, dw and
dh are a query term minus a key term, so their 32 sin/cos features fold
through the angle-addition identities into per-box factors:
``Wg[32:64] . pe_dwdh == A[g, n] . B[:, m]`` with A (g, N, 32) and B (32, M),
built in O(N + M) by ``pe_setup`` (the plain version) or, on the card, by
one launch of the ``bias_factors`` kernel. Only dx and dy need per-pair
sines and cosines, which the kernel (``csrc/position_bias.cu``) computes once
per pair for all groups. ``fused_position_bias`` launches the two kernels on
CUDA tensors and takes the plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

Tensor = torch.Tensor

EMBED_DIM = 64   # pe_setup's slice bounds and the kernels are for 64 only
MAX_GROUPS = 32

# launches of the CUDA kernels since the counts were last set to 0: the
# position bias, and the factors before each biased K5 or K6 launch
launches = 0
factor_launches = 0


def _log_wh(rois: Tensor) -> tuple[Tensor, Tensor]:
    w = rois[:, 2] - rois[:, 0] + 1.0
    h = rois[:, 3] - rois[:, 1] + 1.0
    return torch.log(w), torch.log(h)


def frequencies(embed_dim: int = EMBED_DIM,
                wave_length: float = 1000.0) -> np.ndarray:
    """The sinusoid's angular rates 100 / wave_length^(8k / embed_dim), as
    the fp32 values the kernels multiply by."""
    dim_mat = wave_length ** (8.0 / embed_dim * np.arange(embed_dim // 8))
    return (100.0 / dim_mat).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_frequencies(device: torch.device, embed_dim: int,
                        wave_length: float) -> Tensor:
    # kept per device: a copy from pageable host memory would synchronise
    # the stream at every call
    return torch.from_numpy(frequencies(embed_dim, wave_length)).to(device)


def pe_setup(q: Tensor, k: Tensor, wg_kernel: Tensor,
             embed_dim: int = EMBED_DIM, wave_length: float = 1000.0
             ) -> tuple[tuple[float, ...], Tensor, Tensor, Tensor]:
    """fp32 rois q (N, 4), k (M, 4) and the Wg kernel (64, g) -> the
    operands that do not depend on the pair: (freqs, A (g, N, 32),
    B_t (32, M), wt (g, 32)).

    PE feature layout: [dx 0:16 | dy 16:32 | dw 32:48 | dh 48:64], sines
    then cosines inside each 16. For frequency j, with dw = lqw - lkw,
      sum_j ws_j sin(c_j dw) + wc_j cos(c_j dw)
        = sum_j [ws_j sq_j + wc_j cq_j] ck_j + [wc_j sq_j - ws_j cq_j] sk_j.
    The slice bounds W[32:40] .. W[56:64] are those of a 64-dim embedding
    whatever ``embed_dim`` is, as in the JAX package.
    """
    freqs_np = frequencies(embed_dim, wave_length)
    fr = _device_frequencies(q.device, embed_dim, wave_length)
    w = wg_kernel.float()
    lqw, lqh = _log_wh(q)
    lkw, lkh = _log_wh(k)

    def tables(lv):
        ang = lv[:, None] * fr[None, :]
        return torch.sin(ang), torch.cos(ang)

    sqw, cqw = tables(lqw)
    sqh, cqh = tables(lqh)
    skw, ckw = tables(lkw)
    skh, ckh = tables(lkh)

    def fold(ws, wc, s, c):
        a1 = s[None] * ws.T[:, None, :] + c[None] * wc.T[:, None, :]
        a2 = s[None] * wc.T[:, None, :] - c[None] * ws.T[:, None, :]
        return a1, a2

    a1w, a2w = fold(w[32:40], w[40:48], sqw, cqw)
    a1h, a2h = fold(w[48:56], w[56:64], sqh, cqh)
    a = torch.cat([a1w, a2w, a1h, a2h], dim=-1)
    b_t = torch.cat([ckw, skw, ckh, skh], dim=-1).T
    return tuple(freqs_np.tolist()), a, b_t, w[:32].T


def position_bias_plain(q_rois: Tensor, k_rois: Tensor, wg_kernel: Tensor,
                        wg_bias: Tensor, *, embed_dim: int = EMBED_DIM,
                        wave_length: float = 1000.0) -> Tensor:
    """The dense composition: (N, 4) x (M, 4) rois, Wg kernel (64, g) and
    bias (g,) -> (g, N, M) = log(relu(PE @ Wg + b) + 1e-6), transposed."""
    from ..models.mega import position_embedding, position_matrix
    pe = position_embedding(position_matrix(q_rois.float(), k_rois.float()),
                            embed_dim, wave_length)
    wg = torch.relu(pe @ wg_kernel.float() + wg_bias.float())
    return torch.log(wg + 1e-6).permute(2, 0, 1)


@functools.lru_cache(maxsize=None)
def _c_frequencies(embed_dim: int, wave_length: float) -> ctypes.Array:
    freqs = frequencies(embed_dim, wave_length)
    return (ctypes.c_float * len(freqs))(*freqs)


@functools.cache
def _kernel() -> ctypes.CDLL:
    lib = _build.load_library("position_bias")
    fn = lib.position_bias_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p])
    fn = lib.bias_factors_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p])
    lib.position_bias_error_string.restype = ctypes.c_char_p
    lib.position_bias_error_string.argtypes = [ctypes.c_int]
    return lib


def check_bias_inputs(q_rois, k_rois, wg_kernel, wg_bias,
                      embed_dim: int) -> None:
    """What the bias, alone or inside the fused attention, needs: fp32 rois
    (N, 4) and (M, 4), Wg (64, g) and b (g,), g <= 32, on one CUDA device."""
    for n, t in (("q_rois", q_rois), ("k_rois", k_rois),
                 ("wg_kernel", wg_kernel), ("wg_bias", wg_bias)):
        if t.device.type != "cuda" or t.device != q_rois.device:
            raise ValueError(f"{n} must lie on q_rois' CUDA device, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{n} must be float32, got {t.dtype}")
    if embed_dim != EMBED_DIM:
        raise ValueError(f"the kernels take embed_dim {EMBED_DIM} only, got "
                         f"{embed_dim}")
    g = wg_bias.shape[0] if wg_bias.dim() == 1 else -1
    if (q_rois.dim() != 2 or q_rois.shape[1] != 4 or k_rois.dim() != 2
            or k_rois.shape[1] != 4 or wg_kernel.shape != (EMBED_DIM, g)
            or not 1 <= g <= MAX_GROUPS):
        raise ValueError(
            f"shapes: q_rois {tuple(q_rois.shape)}, k_rois "
            f"{tuple(k_rois.shape)}, wg_kernel {tuple(wg_kernel.shape)}, "
            f"wg_bias {tuple(wg_bias.shape)} (groups at most {MAX_GROUPS})")


def bias_operands(q_rois, k_rois, wg_kernel, wg_bias,
                  embed_dim: int = EMBED_DIM, wave_length: float = 1000.0):
    """The bias kernels' operands, contiguous: (q, k, A (g, N, 32), B_t
    (32, M), wt (g, 32), b, the fp32 frequencies as a C array). On CUDA
    tensors (checked by ``check_bias_inputs``) one launch of the
    ``bias_factors`` kernel builds A, B_t and wt; on CPU tensors
    ``pe_setup``, its plain version."""
    global factor_launches
    q, k = q_rois.contiguous(), k_rois.contiguous()
    freqs = _c_frequencies(embed_dim, wave_length)
    if q.device.type == "cpu":
        _, a, b_t, wt = pe_setup(q, k, wg_kernel, embed_dim, wave_length)
        return (q, k, a.contiguous(), b_t.contiguous(), wt.contiguous(),
                wg_bias.contiguous(), freqs)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    n, m, g = q.shape[0], k.shape[0], wg_bias.shape[0]
    a = torch.empty((g, n, 32), device=q.device)
    b_t = torch.empty((32, m), device=q.device)
    wt = torch.empty((g, 32), device=q.device)
    lib = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.bias_factors_forward(
            q.data_ptr(), k.data_ptr(), wg_kernel.data_ptr(),
            wg_kernel.stride(0), wg_kernel.stride(1), a.data_ptr(),
            b_t.data_ptr(), wt.data_ptr(), n, m, g, freqs, stream)
    _build.check_launch(lib, "position_bias", code)
    factor_launches += 1
    return q, k, a, b_t, wt, wg_bias.contiguous(), freqs


def position_bias_cuda(q_rois: Tensor, k_rois: Tensor, wg_kernel: Tensor,
                       wg_bias: Tensor, *, embed_dim: int = EMBED_DIM,
                       wave_length: float = 1000.0) -> Tensor:
    """The hand-written kernels, ``bias_factors`` then the bias: same
    contract as ``position_bias_plain`` for fp32 CUDA tensors. Raises on
    what the kernels do not take, and when an input needs a gradient (they
    have no backward)."""
    global launches
    _build.refuse_grad("position_bias_cuda", q_rois, k_rois, wg_kernel,
                       wg_bias)
    check_bias_inputs(q_rois, k_rois, wg_kernel, wg_bias, embed_dim)
    n, m, g = q_rois.shape[0], k_rois.shape[0], wg_bias.shape[0]
    out = torch.empty((g, n, m), device=q_rois.device)
    if n == 0 or m == 0:
        return out
    q, k, a, b_t, wt, b, freqs = bias_operands(
        q_rois, k_rois, wg_kernel, wg_bias, embed_dim, wave_length)
    lib = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.position_bias_forward(
            q.data_ptr(), k.data_ptr(), a.data_ptr(), b_t.data_ptr(),
            wt.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, g, freqs,
            stream)
    _build.check_launch(lib, "position_bias", code)
    launches += 1
    return out


def fused_position_bias(q_rois: Tensor, k_rois: Tensor, wg_kernel: Tensor,
                        wg_bias: Tensor, *, embed_dim: int = EMBED_DIM,
                        wave_length: float = 1000.0) -> Tensor:
    """(N, 4) x (M, 4) rois + the Wg Dense's kernel (64, g) and bias (g,) ->
    the (g, N, M) bias: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    kw = dict(embed_dim=embed_dim, wave_length=wave_length)
    if q_rois.device.type == "cuda":
        return position_bias_cuda(q_rois, k_rois, wg_kernel, wg_bias, **kw)
    if q_rois.device.type != "cpu":
        raise ValueError(f"no kernel for device {q_rois.device}")
    return position_bias_plain(q_rois, k_rois, wg_kernel, wg_bias, **kw)
