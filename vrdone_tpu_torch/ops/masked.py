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
hand-written CUDA kernels, which raise on what they do not take. Where a
gradient is needed, band attention takes its differentiable kernel form
(``BandAttention``, or ``BandAttentionPE`` with a relative-position bias);
full attention takes the dense form by argument (``allow_kernel=False``),
as the JAX package trains through it.

Under sequence parallelism (inside ``parallel.collectives.time_sharded``)
each (B, T, C) stream is this rank's contiguous columns of the global one,
each shard starting on a multiple of the stride of the level it is at.
The ops then compute exactly the rank's columns of the global op:
convolutions and max-pools read halos sized from their kernel, stride and
padding (the zero or -inf padding only at the global edges), band
attention runs its unchanged kernels over the neighbours' w = window // 2
key rows on each side and keeps the central queries, and full attention
gathers its keys, values and key mask along T (the queries stay local).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel import collectives
from . import full_attention as _fa
from .band_attention import (BandAttention, BandAttentionPE,
                             band_attention_cuda, band_attention_pe_cuda,
                             band_attention_pe_plain, band_attention_plain)
from .full_attention import full_attention_cuda, full_attention_plain
from .heads import merge_heads, split_heads

__all__ = [
    "conv1d", "downsample_mask", "masked_conv1d", "max_pool1d",
    "channel_layernorm", "split_heads", "merge_heads", "full_attention",
    "band_attention", "sinusoid_encoding", "resize_pe_linear", "drop_path",
    "dropout", "StepDraws",
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
    layout = collectives.time_layout()
    if layout is None:
        out = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride,
                       padding=k // 2, groups=groups)
        return out.transpose(1, 2)
    x = _halo_window(x, k, stride, k // 2, 0.0, layout)
    out = F.conv1d(x.transpose(1, 2), weight, bias, stride=stride,
                   groups=groups)
    return out.transpose(1, 2)


def _halo_window(x: torch.Tensor, kernel: int, stride: int, padding: int,
                 fill: float, layout) -> torch.Tensor:
    """This rank's columns with the global rows that its outputs of a
    window op (``kernel``, ``stride``, ``padding``) read: ``padding`` rows
    before and kernel - padding - stride after (none when that is
    negative). The op over them, unpadded, gives exactly the rank's
    T_local / stride outputs."""
    return collectives.halo(x, padding, max(0, kernel - padding - stride),
                            fill, layout)


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
    layout = collectives.time_layout()
    if layout is None:
        return F.max_pool1d(x.transpose(1, 2), kernel, stride,
                            padding).transpose(1, 2)
    x = _halo_window(x, kernel, stride, padding, float("-inf"), layout)
    return F.max_pool1d(x.transpose(1, 2), kernel, stride).transpose(1, 2)


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
                   kv_mask: torch.Tensor, *, n_head: int,
                   allow_kernel: bool = True) -> torch.Tensor:
    """Key-masked attention over (B, T, C) streams; kv_mask (B, Tk) bool.
    The output is not masked by the query mask. ``allow_kernel`` mirrors the
    JAX package's ``full_attention_auto(allow_flash=deterministic)``: callers
    pass ``not self.training``, and training runs the dense form, whose
    autograd is the backward (the kernel has none). Time-sharded, the keys,
    values and key mask are gathered along T."""
    layout = collectives.time_layout()
    if layout is not None:
        k, v, kv_mask = _unpack(collectives.gather_time(
            _pack(k, v, kv_mask), layout), k.shape[-1])
    if q.device.type == "cpu":
        return full_attention_plain(q, k, v, kv_mask, n_head=n_head)
    if not allow_kernel:
        _fa.dense_calls += 1
        return full_attention_plain(q, k, v, kv_mask, n_head=n_head)
    return full_attention_cuda(q, k, v, kv_mask, n_head=n_head)


def band_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_mask: torch.Tensor, *, n_head: int, window_size: int,
                   rel_pe: torch.Tensor | None = None) -> torch.Tensor:
    """Sliding-window attention over (B, T, C) streams, |i - j| <= w with
    w = window_size // 2; kv_mask (B, T) bool; rel_pe an optional
    (n_head, window_size) relative-position bias. On a card the JAX
    package's length threshold for its kernel does not apply: every call
    takes a kernel.

    Time-sharded, k, v and the key mask take the neighbours' w rows on
    each side (masked keys past the global edges, which weigh exactly
    nothing, as absent keys), q takes w zero rows on each side (the kernels
    need Tq == Tk), the unchanged op runs over T_local + 2w and the central
    rows are kept. The discarded rows get a zero upstream gradient, so the
    backward adds nothing through them; the halo gradients of k and v go
    back to the neighbours."""
    layout = collectives.time_layout()
    if layout is None:
        return _band_attention(q, k, v, kv_mask, n_head, window_size, rel_pe)
    w, t = window_size // 2, q.shape[1]
    k, v, kv_mask = _unpack(collectives.halo(_pack(k, v, kv_mask), w, w,
                                             0.0, layout), k.shape[-1])
    out = _band_attention(F.pad(q, (0, 0, w, w)), k, v, kv_mask, n_head,
                          window_size, rel_pe)
    return out[:, w:w + t]


def _pack(k: torch.Tensor, v: torch.Tensor,
          kv_mask: torch.Tensor) -> torch.Tensor:
    """k, v and the key mask as one (B, T, 2C + 1) tensor, for one
    collective."""
    return torch.cat([k, v, kv_mask[..., None].to(k.dtype)], -1)


def _unpack(kvm: torch.Tensor, c: int):
    """``_pack``'s inverse: contiguous k and v, the bool key mask."""
    return (kvm[..., :c].contiguous(), kvm[..., c:2 * c].contiguous(),
            kvm[..., 2 * c] > 0.5)


def _band_attention(q, k, v, kv_mask, n_head, window_size, rel_pe):
    """The dispatch of ``band_attention`` on whole streams."""
    if rel_pe is None:
        plain, fn, kernel, pe = (band_attention_plain, BandAttention,
                                 band_attention_cuda, ())
    else:
        plain, fn, kernel, pe = (band_attention_pe_plain, BandAttentionPE,
                                 band_attention_pe_cuda, (rel_pe,))
    kw = dict(n_head=n_head, window_size=window_size)
    if q.device.type == "cpu":
        return plain(q, k, v, kv_mask, *pe, **kw)
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in (q, k, v, *pe)):
        return fn.apply(q, k, v, kv_mask, *pe, n_head, window_size)
    return kernel(q, k, v, kv_mask, *pe, **kw)


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


# ---------------------------------------------------------------------------
# stochastic depth and dropout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepDraws:
    """Where a train step's drop-path and dropout uniforms come from, under
    data and sequence parallelism. Every tensor drawn for has the batch as
    its leading dimension; each draw is taken at the global batch's shape
    (``global_batch`` rows) from ``generator``, the same seed on every rank,
    and this rank keeps its own rows from ``row_offset``. A draw for a
    time-sharded tensor (inside ``collectives.time_sharded``: axis 1 is
    time) is taken at the level's global length, ``time_parts`` times the
    rank's, and the rank keeps its columns, part ``time_index``. So N ranks
    draw what one process draws for the whole batch, as JAX draws once for
    the global batch and shards the draw. One process is ``row_offset`` 0
    with ``global_batch`` its batch and one time part: the draws of
    ``generator`` alone."""
    generator: torch.Generator
    global_batch: int
    row_offset: int = 0
    time_parts: int = 1
    time_index: int = 0

    def draw(self, shape: tuple[int, ...]) -> torch.Tensor:
        """fp32 U[0, 1) of the global ``shape``, on the generator's
        device."""
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device)

    def restarted(self, state: torch.Tensor) -> "StepDraws":
        """These draws from a fresh generator at ``state`` (a recompute
        draws what the forward drew)."""
        gen = torch.Generator(self.generator.device)
        gen.set_state(state)
        return dataclasses.replace(self, generator=gen)

    def local(self, shape: tuple[int, ...]) -> torch.Tensor:
        """This rank's part, of ``shape``, of the global draw."""
        lo, parts = self.row_offset, 1
        if len(shape) >= 2 and collectives.time_layout() is not None:
            parts = self.time_parts
        u = self.draw((self.global_batch, shape[1] * parts, *shape[2:])
                      if len(shape) >= 2 else (self.global_batch,))
        if lo + shape[0] > u.shape[0]:
            raise ValueError(f"rows {lo}..{lo + shape[0]} of a draw for "
                             f"{u.shape[0]}")
        u = u[lo:lo + shape[0]]
        if parts > 1:
            u = u[:, self.time_index * shape[1]:
                  (self.time_index + 1) * shape[1]]
        return u


def _uniform(shape, generator: torch.Generator | StepDraws,
             like: torch.Tensor,
             dtype: torch.dtype | None = None) -> torch.Tensor:
    """U[0, 1) draws of ``dtype`` (``like``'s by default) from
    ``generator`` on its own device, moved to ``like``'s: this rank's part
    of a draw at the global shape when ``generator`` is a ``StepDraws``.
    With a CPU generator a CPU run and a card run from one seed draw the
    same numbers. Below fp32's precision the fp32 draws are cut down to the
    dtype's mantissa, multiples of its eps in [0, 1 - eps], as
    ``jax.random.uniform`` draws them (rounding to nearest would give
    1.0)."""
    dtype = like.dtype if dtype is None else dtype
    if isinstance(generator, StepDraws):
        u = generator.local(tuple(shape))
    else:
        u = torch.rand(shape, generator=generator, device=generator.device)
    eps = torch.finfo(dtype).eps
    if eps > torch.finfo(u.dtype).eps:
        u = torch.floor(u / eps) * eps
    return u.to(device=like.device, dtype=dtype)


def drop_path_with(x: torch.Tensor, u: torch.Tensor,
                   drop_prob: float) -> torch.Tensor:
    """Per-sample stochastic depth for given per-sample uniforms ``u``
    (B,): ``floor(keep + u)`` keeps a sample, the kept ones scale by
    1/keep (vrdone_tpu/ops/masked.py::drop_path)."""
    keep = 1.0 - drop_prob
    mask = torch.floor(keep + u).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return x / keep * mask


def drop_path(x: torch.Tensor, drop_prob: float, training: bool,
              generator: torch.Generator | StepDraws | None) -> torch.Tensor:
    """Per-sample stochastic depth (reference models/blocks.py:1107-1120);
    identity at eval or when drop_prob is 0. The (B,) uniforms come from
    ``generator`` (a ``StepDraws``: this rank's rows of the global
    batch's)."""
    if not training or drop_prob == 0.0:
        return x
    if generator is None:
        raise ValueError("drop_path in training needs a torch.Generator")
    return drop_path_with(x, _uniform((x.shape[0],), generator, x),
                          drop_prob)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | StepDraws | None) -> torch.Tensor:
    """Elementwise dropout as flax ``nn.Dropout``: keep with probability
    1 - p (fp32 uniforms whatever x's dtype, as ``random.bernoulli`` draws
    them), kept values scale by 1/(1 - p); identity at eval or p == 0."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = _uniform(x.shape, generator, x, torch.float32) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
