"""Building blocks of the model stack (counterpart of
``vrdone_tpu/models/layers.py``).

Every module takes time-major ``(B, T, C)`` activations with boolean
``(B, T)`` validity masks. Submodules and parameters carry the flax names
(``query``, ``preproc/key_conv``, ``drop_path_attn/AffineDropPath_0`` ...),
so a flax parameter path maps to a ``state_dict`` key by joining with "."
(see ``vrdone_tpu_torch/convert.py``). Input widths that flax infers on the
first call are constructor arguments here.

``self.training`` stands where the JAX modules take ``deterministic``
(``deterministic = not self.training``). Like the flax modules, whose
``deterministic`` defaults to True, every module here starts in eval mode;
``model.train()`` turns training on. In training, stochastic depth and
dropout draw from the ``torch.Generator`` handed down each ``forward`` as
``generator`` (flax's ``droppath`` and ``dropout`` rngs); at eval they are
identity and ``AffineDropPath`` applies only its per-channel scale.
Parameters are allocated uninitialised on the given ``device``;
``init_weights`` fills them from a ``torch.Generator`` with the reference's
initialisers, or they are loaded from a converted JAX checkpoint.

Tensor parallelism (``parallel/mesh.py::shard_params_``): a module whose
``TP_SHARDABLE`` names a parameter can hold only this rank's shard of it
(recorded in ``tp_dims`` and ``tp_layout``). ``MaskedConv1D``, ``Dense``
and ``ConvMLP`` are then output-sharded: they compute the rank's shard of
their output features and gather the rest from the tp ranks; a sharded
``query_embed`` or ``rel_pe`` is gathered whole where it is read. Time
sharding needs nothing here: ``ops/masked.py`` takes the halos and
gathers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import masked as mops
from ..parallel import collectives

Tensor = torch.Tensor
Generator = Optional[torch.Generator]


class Module(nn.Module):
    """``nn.Module`` that starts in eval mode (flax's deterministic=True
    default)."""

    def __init__(self):
        super().__init__()
        self.training = False


def tp_param(module: nn.Module, name: str) -> Tensor:
    """The whole parameter ``name`` of ``module``: gathered from the tp
    ranks when the module holds a shard of it."""
    p = getattr(module, name)
    dim = getattr(module, "tp_dims", {}).get(name)
    if dim is None:
        return p
    return collectives.gather_features(p, dim, module.tp_layout)


def _tp_output(module: nn.Module, y: Tensor,
               bias: Optional[Tensor]) -> Tensor:
    """An output-sharded layer's whole output: the tp ranks' feature
    shards gathered, then the (replicated) bias added."""
    y = collectives.gather_features(y, y.ndim - 1, module.tp_layout)
    return y if bias is None else y + bias


# ---------------------------------------------------------------------------
# initialisation
# ---------------------------------------------------------------------------

def _fan_in_uniform_(weight: nn.Parameter, fan_in: int,
                     generator: torch.Generator) -> None:
    """Torch Conv1d/Linear default, kaiming_uniform(a=sqrt(5)): U(-b, b)
    with b = 1/sqrt(fan_in)."""
    bound = 1.0 / math.sqrt(fan_in)
    weight.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of ``model`` from ``generator``: each module
    initialises the parameters it owns directly, in ``modules()`` order."""
    for m in model.modules():
        if hasattr(m, "init_params"):
            m.init_params(generator)


def get_activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return F.gelu  # the exact erf form, as torch nn.GELU()
    if name == "glu":
        return F.glu
    raise ValueError(f"unknown activation: {name}")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

class ChannelLayerNorm(Module):
    """LayerNorm over channels of (B, T, C) (reference models/blocks.py:116)."""

    def __init__(self, features: int, eps: float = 1e-5, affine: bool = True,
                 *, device: torch.device):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.empty(features, device=device))
            self.bias = nn.Parameter(torch.empty(features, device=device))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def init_params(self, generator: torch.Generator) -> None:
        if self.weight is not None:
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: Tensor) -> Tensor:
        return mops.channel_layernorm(x, self.weight, self.bias, self.eps)


class MaskedConv1D(Module):
    """Mask-preserving conv1d (reference models/blocks.py:63-113)."""

    TP_SHARDABLE = ("weight",)

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, use_bias: bool = True, *,
                 device: torch.device):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"kernel_size must be odd, got {kernel_size}")
        self.stride = stride
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            features, in_features // groups, kernel_size, device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)

    def init_params(self, generator: torch.Generator) -> None:
        _fan_in_uniform_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            self.bias.zero_()  # reference zero-inits conv bias

    def forward(self, x: Tensor, mask: Tensor) -> tuple[Tensor, Tensor]:
        if not getattr(self, "tp_dims", None):
            return mops.masked_conv1d(x, mask, self.weight, self.bias,
                                      stride=self.stride, groups=self.groups)
        # output-sharded: a grouped conv's shard reads its groups' inputs
        layout, groups = self.tp_layout, self.groups
        if groups > 1:
            if groups % layout.n_tp:
                raise ValueError(f"{groups} groups do not split over "
                                 f"n_tp {layout.n_tp}")
            c = x.shape[-1] // layout.n_tp
            x = x[..., layout.tp * c:(layout.tp + 1) * c]
            groups //= layout.n_tp
        out = _tp_output(self, mops.conv1d(x, self.weight, stride=self.stride,
                                           groups=groups), self.bias)
        out_mask = mops.downsample_mask(mask, self.stride, out.shape[1])
        return out * out_mask[..., None].to(out.dtype), out_mask


class Dense(Module):
    """Linear layer on the last axis, torch-style fan-in init, constant
    bias (zero unless ``bias_value`` is given)."""

    TP_SHARDABLE = ("weight",)

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 bias_value: float = 0.0, *, device: torch.device):
        super().__init__()
        self.bias_value = bias_value
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(features, device=device))
                     if use_bias else None)

    def init_params(self, generator: torch.Generator) -> None:
        _fan_in_uniform_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            self.bias.fill_(self.bias_value)

    def forward(self, x: Tensor) -> Tensor:
        if not getattr(self, "tp_dims", None):
            return F.linear(x, self.weight, self.bias)
        return _tp_output(self, F.linear(x, self.weight), self.bias)


class ConvMLP(Module):
    """Stacked conv1d MLP (reference models/blocks.py:37-61). kernel_size 1
    (every shipped config) is a stack of Dense layers."""

    def __init__(self, in_features: int, hidden_dim: int, output_dim: int,
                 num_layers: int, kernel_size: int = 1, act: str = "gelu",
                 dropout: float = 0.0, *, device: torch.device):
        super().__init__()
        self.num_layers = num_layers
        self.kernel_size = kernel_size
        self.dropout = dropout
        self.act = get_activation(act)
        dims = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.TP_SHARDABLE = tuple(f"layers_{i}_kernel" for i in range(
            num_layers)) if kernel_size > 1 else ()
        c_in = in_features
        for i, d in enumerate(dims):
            if kernel_size == 1:
                self.add_module(f"layers_{i}", Dense(c_in, d, device=device))
            else:
                self.register_parameter(f"layers_{i}_kernel", nn.Parameter(
                    torch.empty(d, c_in, kernel_size, device=device)))
                self.register_parameter(f"layers_{i}_bias", nn.Parameter(
                    torch.empty(d, device=device)))
            c_in = d

    def init_params(self, generator: torch.Generator) -> None:
        if self.kernel_size == 1:
            return  # the Dense children initialise themselves
        for i in range(self.num_layers):
            kernel = getattr(self, f"layers_{i}_kernel")
            _fan_in_uniform_(kernel, kernel[0].numel(), generator)
            getattr(self, f"layers_{i}_bias").zero_()

    def forward(self, x: Tensor, generator: Generator = None) -> Tensor:
        for i in range(self.num_layers):
            if self.kernel_size == 1:
                x = getattr(self, f"layers_{i}")(x)
            elif f"layers_{i}_kernel" in getattr(self, "tp_dims", {}):
                x = _tp_output(self, mops.conv1d(
                    x, getattr(self, f"layers_{i}_kernel")),
                    getattr(self, f"layers_{i}_bias"))
            else:
                x = mops.conv1d(x, getattr(self, f"layers_{i}_kernel"),
                                getattr(self, f"layers_{i}_bias"))
            if i < self.num_layers - 1:
                x = self.act(x)
            x = mops.dropout(x, self.dropout, self.training, generator)
        return x


class AffineDropPath(Module):
    """Per-channel-scaled stochastic depth (reference models/blocks.py:1134);
    at eval only the scale applies."""

    def __init__(self, features: int, drop_prob: float = 0.0,
                 init_scale: float = 1e-4, *, device: torch.device):
        super().__init__()
        self.drop_prob = drop_prob
        self.init_scale = init_scale
        self.scale = nn.Parameter(torch.empty(features, device=device))

    def init_params(self, generator: torch.Generator) -> None:
        self.scale.fill_(self.init_scale)

    def forward(self, x: Tensor, generator: Generator = None) -> Tensor:
        return mops.drop_path(x * self.scale, self.drop_prob, self.training,
                              generator)


class MaybeDropPath(Module):
    """AffineDropPath when drop_prob > 0 else identity, mirroring the
    reference's conditional wiring (models/blocks.py:1063-1068)."""

    def __init__(self, features: int, drop_prob: float = 0.0, *,
                 device: torch.device):
        super().__init__()
        self.AffineDropPath_0 = (AffineDropPath(features, drop_prob,
                                                device=device)
                                 if drop_prob > 0.0 else None)

    def forward(self, x: Tensor, generator: Generator = None) -> Tensor:
        if self.AffineDropPath_0 is None:
            return x
        return self.AffineDropPath_0(x, generator)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class MHA(Module):
    """Dense masked multi-head attention over explicit (q, k, v) streams
    (reference MaskedMHA / MaskedMHA_QKV)."""

    def __init__(self, n_embd: int, n_head: int, proj_pdrop: float = 0.0, *,
                 device: torch.device):
        super().__init__()
        self.n_head = n_head
        self.proj_pdrop = proj_pdrop
        self.query = Dense(n_embd, n_embd, device=device)
        self.key = Dense(n_embd, n_embd, device=device)
        self.value = Dense(n_embd, n_embd, device=device)
        self.proj = Dense(n_embd, n_embd, device=device)

    def forward(self, q: Tensor, k: Tensor, v: Tensor, qx_mask: Tensor,
                kv_mask: Tensor, generator: Generator = None
                ) -> tuple[Tensor, Tensor]:
        out = mops.full_attention(self.query(q), self.key(k), self.value(v),
                                  kv_mask, n_head=self.n_head,
                                  allow_kernel=not self.training)
        out = mops.dropout(self.proj(out), self.proj_pdrop, self.training,
                           generator)
        return out * qx_mask[..., None].to(out.dtype), qx_mask


class _QKVPreproc(Module):
    """Depthwise conv + channel LayerNorm of each of the q/k/v streams (the
    "Conv" of the reference's MHCA variants)."""

    def __init__(self, n_embd: int, qx_kernel: int, qx_stride: int,
                 kv_kernel: int, kv_stride: int, *, device: torch.device):
        super().__init__()

        def conv(kernel, stride):
            return MaskedConv1D(n_embd, n_embd, kernel, stride=stride,
                                groups=n_embd, use_bias=False, device=device)

        self.query_conv = conv(qx_kernel, qx_stride)
        self.query_norm = ChannelLayerNorm(n_embd, device=device)
        self.key_conv = conv(kv_kernel, kv_stride)
        self.key_norm = ChannelLayerNorm(n_embd, device=device)
        self.value_conv = conv(kv_kernel, kv_stride)
        self.value_norm = ChannelLayerNorm(n_embd, device=device)

    def forward(self, q, k, v, qx_mask, kv_mask):
        q, qm = self.query_conv(q, qx_mask)
        q = self.query_norm(q)
        k, km = self.key_conv(k, kv_mask)
        k = self.key_norm(k)
        v, _ = self.value_conv(v, kv_mask)
        v = self.value_norm(v)
        return q, k, v, qm, km


def _mhca_kernels(n_qx_stride: int, n_kv_stride: int, *, qkv_api: bool):
    """Reproduce the reference's kernel/stride quirks.

    Self-attn flavour (models/blocks.py:284-305): the query conv uses kernel
    n_qx_stride+1 (or 3 when stride 1) but its *stride comes from n_kv_stride*.
    QKV flavour (models/local_transformer.py:108-128): n_qx_stride==0 means a
    pointwise (kernel-1) query conv; strides clamp to 1 when 0.
    """
    if qkv_api:
        qx_kernel = n_qx_stride + 1 if (n_qx_stride > 1 or n_qx_stride == 0) else 3
        qx_stride = n_kv_stride if n_kv_stride > 0 else 1
        kv_kernel = n_kv_stride + 1 if (n_kv_stride > 1 or n_kv_stride == 0) else 3
        kv_stride = n_kv_stride if n_kv_stride > 0 else 1
    else:
        qx_kernel = n_qx_stride + 1 if n_qx_stride > 1 else 3
        qx_stride = n_kv_stride
        kv_kernel = n_kv_stride + 1 if n_kv_stride > 1 else 3
        kv_stride = n_kv_stride
    return qx_kernel, qx_stride, kv_kernel, kv_stride


class ConvMHA(Module):
    """Multi-head conv attention (reference MaskedMHCA / MaskedMHCA_QKV)."""

    def __init__(self, n_embd: int, n_head: int, n_qx_stride: int = 1,
                 n_kv_stride: int = 1, qkv_api: bool = False,
                 proj_pdrop: float = 0.0, *, device: torch.device):
        super().__init__()
        self.n_head = n_head
        self.proj_pdrop = proj_pdrop
        self.preproc = _QKVPreproc(
            n_embd, *_mhca_kernels(n_qx_stride, n_kv_stride, qkv_api=qkv_api),
            device=device)
        self.query = Dense(n_embd, n_embd, device=device)
        self.key = Dense(n_embd, n_embd, device=device)
        self.value = Dense(n_embd, n_embd, device=device)
        self.proj = Dense(n_embd, n_embd, device=device)

    def forward(self, q: Tensor, k: Tensor, v: Tensor, qx_mask: Tensor,
                kv_mask: Tensor, generator: Generator = None
                ) -> tuple[Tensor, Tensor]:
        q, k, v, qm, km = self.preproc(q, k, v, qx_mask, kv_mask)
        out = mops.full_attention(self.query(q), self.key(k), self.value(v),
                                  km, n_head=self.n_head,
                                  allow_kernel=not self.training)
        out = mops.dropout(self.proj(out), self.proj_pdrop, self.training,
                           generator)
        return out * qm[..., None].to(out.dtype), qm


class _BandAttnBase(Module):
    """What the two sliding-window flavours share: the optional conv
    preprocessing (``preproc_kernels``, see ``_mhca_kernels``), the
    q/k/v/proj Dense layers and, with ``use_rel_pe``, the (n_head,
    window_size) relative-position bias ``rel_pe``, initialised as the JAX
    package does (truncated normal at +-2 std, std sqrt(2 / n_embd))."""

    TP_SHARDABLE = ("rel_pe",)

    def __init__(self, n_embd: int, n_head: int, window_size: int,
                 use_rel_pe: bool, proj_pdrop: float,
                 preproc_kernels: Optional[tuple[int, int, int, int]] = None,
                 *, device: torch.device):
        super().__init__()
        self.n_embd = n_embd
        self.n_head = n_head
        self.proj_pdrop = proj_pdrop
        self.window_size = window_size
        if preproc_kernels is not None:
            self.preproc = _QKVPreproc(n_embd, *preproc_kernels,
                                       device=device)
        self.query = Dense(n_embd, n_embd, device=device)
        self.key = Dense(n_embd, n_embd, device=device)
        self.value = Dense(n_embd, n_embd, device=device)
        self.proj = Dense(n_embd, n_embd, device=device)
        if use_rel_pe:
            self.rel_pe = nn.Parameter(torch.empty(n_head, window_size,
                                                   device=device))
        else:
            self.register_parameter("rel_pe", None)

    def init_params(self, generator: torch.Generator) -> None:
        if self.rel_pe is not None:
            std = math.sqrt(2.0 / self.n_embd)
            nn.init.trunc_normal_(self.rel_pe, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)

    def _attend(self, q: Tensor, k: Tensor, v: Tensor, kv_mask: Tensor,
                mask: Tensor, generator: Generator) -> Tensor:
        out = mops.band_attention(self.query(q), self.key(k), self.value(v),
                                  kv_mask, n_head=self.n_head,
                                  window_size=self.window_size,
                                  rel_pe=None if self.rel_pe is None
                                  else tp_param(self, "rel_pe"))
        out = mops.dropout(self.proj(out), self.proj_pdrop, self.training,
                           generator)
        return out * mask[..., None].to(out.dtype)


class LocalMHA(_BandAttnBase):
    """Sliding-window attention without conv preprocessing
    (reference LocalMaskedMHA / LocalMaskedMHA_QKV)."""

    def __init__(self, n_embd: int, n_head: int, window_size: int,
                 use_rel_pe: bool = False, proj_pdrop: float = 0.0, *,
                 device: torch.device):
        super().__init__(n_embd, n_head, window_size, use_rel_pe, proj_pdrop,
                         device=device)

    def forward(self, q: Tensor, k: Tensor, v: Tensor, qx_mask: Tensor,
                kv_mask: Tensor, generator: Generator = None
                ) -> tuple[Tensor, Tensor]:
        return self._attend(q, k, v, kv_mask, qx_mask, generator), qx_mask


class LocalConvMHA(_BandAttnBase):
    """Sliding-window conv attention (reference LocalMaskedMHCA family)."""

    def __init__(self, n_embd: int, n_head: int, window_size: int,
                 n_qx_stride: int = 1, n_kv_stride: int = 1,
                 use_rel_pe: bool = False, qkv_api: bool = False,
                 proj_pdrop: float = 0.0, *, device: torch.device):
        super().__init__(n_embd, n_head, window_size, use_rel_pe, proj_pdrop,
                         _mhca_kernels(n_qx_stride, n_kv_stride,
                                       qkv_api=qkv_api), device=device)

    def forward(self, q: Tensor, k: Tensor, v: Tensor, qx_mask: Tensor,
                kv_mask: Tensor, generator: Generator = None
                ) -> tuple[Tensor, Tensor]:
        q, k, v, qm, km = self.preproc(q, k, v, qx_mask, kv_mask)
        return self._attend(q, k, v, km, qm, generator), qm


# ---------------------------------------------------------------------------
# composite blocks
# ---------------------------------------------------------------------------

class TransformerBlock(Module):
    """Pre-LN transformer encoder block with optional temporal downsampling
    (reference models/blocks.py:992-1080)."""

    def __init__(self, n_embd: int, n_head: int,
                 n_ds_strides: tuple[int, int] = (1, 1),
                 n_hidden: Optional[int] = None, path_pdrop: float = 0.0,
                 mha_win_size: int = -1, use_rel_pe: bool = False,
                 proj_pdrop: float = 0.0, *, device: torch.device):
        super().__init__()
        self.n_ds_strides = tuple(n_ds_strides)
        self.proj_pdrop = proj_pdrop
        self.ln1 = ChannelLayerNorm(n_embd, device=device)
        if mha_win_size > 1:
            self.attn = LocalConvMHA(
                n_embd, n_head, window_size=mha_win_size,
                n_qx_stride=n_ds_strides[0], n_kv_stride=n_ds_strides[1],
                use_rel_pe=use_rel_pe, proj_pdrop=proj_pdrop, device=device)
        else:
            self.attn = ConvMHA(
                n_embd, n_head, n_qx_stride=n_ds_strides[0],
                n_kv_stride=n_ds_strides[1], proj_pdrop=proj_pdrop,
                device=device)
        self.drop_path_attn = MaybeDropPath(n_embd, path_pdrop, device=device)
        n_hidden = n_hidden if n_hidden is not None else 4 * n_embd
        self.ln2 = ChannelLayerNorm(n_embd, device=device)
        self.mlp_0 = Dense(n_embd, n_hidden, device=device)
        self.mlp_1 = Dense(n_hidden, n_embd, device=device)
        self.drop_path_mlp = MaybeDropPath(n_embd, path_pdrop, device=device)

    def forward(self, x: Tensor, mask: Tensor,
                pos_embd: Optional[Tensor] = None,
                generator: Generator = None) -> tuple[Tensor, Tensor]:
        def drop(t):
            return mops.dropout(t, self.proj_pdrop, self.training, generator)

        xn = self.ln1(x)
        out, out_mask = self.attn(xn, xn, xn, mask, mask, generator)
        out_mask_f = out_mask[..., None].to(out.dtype)
        if self.n_ds_strides[0] > 1:
            stride = self.n_ds_strides[0]
            skip = mops.max_pool1d(x, kernel=stride + 1, stride=stride,
                                   padding=(stride + 1) // 2)
            skip = skip[:, :out.shape[1]]
        else:
            skip = x
        out = skip * out_mask_f + self.drop_path_attn(out, generator)
        h = drop(F.gelu(self.mlp_0(self.ln2(out))))
        h = drop(self.mlp_1(h))
        out = out + self.drop_path_mlp(h * out_mask_f, generator)
        if pos_embd is not None:
            out = out + pos_embd * out_mask_f
        return out, out_mask


def _make_attn(n_embd, n_head, *, use_local, win_size, n_qx_stride,
               n_kv_stride, use_rel_pe, proj_pdrop, name, device):
    """Attention flavour of a decoder layer
    (reference models/local_transformer.py:653-739)."""
    pointwise = ((name == "self_attn" and n_qx_stride == 0)
                 or (name == "multihead_attn" and n_kv_stride == 0))
    if use_local:
        if pointwise:
            return LocalMHA(n_embd, n_head, window_size=win_size,
                            use_rel_pe=use_rel_pe, proj_pdrop=proj_pdrop,
                            device=device)
        return LocalConvMHA(n_embd, n_head, window_size=win_size,
                            n_qx_stride=n_qx_stride, n_kv_stride=n_kv_stride,
                            use_rel_pe=use_rel_pe, qkv_api=True,
                            proj_pdrop=proj_pdrop, device=device)
    if pointwise:
        return MHA(n_embd, n_head, proj_pdrop=proj_pdrop, device=device)
    if name == "self_attn":
        # reference passes n_kv_stride=n_qx_stride for decoder self-attn
        # (models/local_transformer.py:711-718)
        return ConvMHA(n_embd, n_head, n_qx_stride=n_qx_stride,
                       n_kv_stride=n_qx_stride, qkv_api=True,
                       proj_pdrop=proj_pdrop, device=device)
    return ConvMHA(n_embd, n_head, n_qx_stride=n_qx_stride,
                   n_kv_stride=n_kv_stride, qkv_api=True,
                   proj_pdrop=proj_pdrop, device=device)


class DecoderLayer(Module):
    """Self-attn + cross-attn (+ optional FFN) decoder layer
    (reference MaskedConvTransformerDecoderLayer,
    models/local_transformer.py:625-835)."""

    def __init__(self, n_embd: int, n_head: int,
                 n_hidden: Optional[int] = None, path_pdrop: float = 0.0,
                 n_qx_stride: int = 0, n_kv_stride: int = 1,
                 with_ffn: bool = True, use_local: bool = False,
                 win_size: Optional[int] = None, use_rel_pe: bool = False,
                 proj_pdrop: float = 0.0, *, device: torch.device):
        super().__init__()
        self.proj_pdrop = proj_pdrop
        kw = dict(use_local=use_local, win_size=win_size,
                  n_qx_stride=n_qx_stride, n_kv_stride=n_kv_stride,
                  use_rel_pe=use_rel_pe, proj_pdrop=proj_pdrop,
                  device=device)
        self.self_attn = _make_attn(n_embd, n_head, name="self_attn", **kw)
        self.multihead_attn = _make_attn(n_embd, n_head,
                                         name="multihead_attn", **kw)
        self.ln1 = ChannelLayerNorm(n_embd, device=device)
        self.ln2 = ChannelLayerNorm(n_embd, device=device)
        self.drop_path_attn1 = MaybeDropPath(n_embd, path_pdrop,
                                             device=device)
        self.drop_path_attn2 = MaybeDropPath(n_embd, path_pdrop,
                                             device=device)
        self.with_ffn = with_ffn
        if with_ffn:
            n_hidden = n_hidden if n_hidden is not None else 4 * n_embd
            self.ln3 = ChannelLayerNorm(n_embd, device=device)
            self.mlp_0 = Dense(n_embd, n_hidden, device=device)
            self.mlp_1 = Dense(n_hidden, n_embd, device=device)
            self.drop_path_mlp = MaybeDropPath(n_embd, path_pdrop,
                                               device=device)

    def forward(self, tgt: Tensor, memory: Tensor, tgt_mask: Tensor,
                memory_mask: Tensor, pos: Optional[Tensor] = None,
                query_pos: Optional[Tensor] = None,
                cross_first: bool = False,
                generator: Generator = None) -> tuple[Tensor, Tensor]:
        def wpe(t, p):
            return t if p is None else t + p

        def drop(t):
            return mops.dropout(t, self.proj_pdrop, self.training, generator)

        def do_self(t):
            t2 = self.ln1(t)
            qk = wpe(t2, query_pos)
            t2, m2 = self.self_attn(qk, qk, t, tgt_mask, tgt_mask, generator)
            return (t * m2[..., None].to(t2.dtype)
                    + self.drop_path_attn1(t2, generator)), m2

        def do_cross(t):
            t2 = self.ln2(t)
            t2, m2 = self.multihead_attn(wpe(t2, query_pos), wpe(memory, pos),
                                         memory, tgt_mask, memory_mask,
                                         generator)
            return (t * m2[..., None].to(t2.dtype)
                    + self.drop_path_attn2(t2, generator)), m2

        if cross_first:
            tgt, m = do_cross(tgt)
            tgt, m = do_self(tgt)
        else:
            tgt, m = do_self(tgt)
            tgt, m = do_cross(tgt)

        if self.with_ffn:
            h = drop(F.gelu(self.mlp_0(self.ln3(tgt))))
            h = drop(self.mlp_1(h))
            tgt = tgt + self.drop_path_mlp(h * m[..., None].to(h.dtype),
                                           generator)
        return tgt, m


class Decoder(Module):
    """Stack of decoder layers with optional intermediate outputs
    (reference MaskedConvTransformerDecoder,
    models/local_transformer.py:838-905)."""

    def __init__(self, n_embd: int, n_head: int,
                 n_hidden: Optional[int] = None, path_pdrop: float = 0.1,
                 n_qx_stride: int = 0, n_kv_stride: int = 1,
                 num_layers: int = 4, with_norm: bool = True,
                 return_intermediate: bool = False, use_local: bool = False,
                 win_size: Optional[int] = None, use_rel_pe: bool = False,
                 proj_pdrop: float = 0.0, *, device: torch.device):
        super().__init__()
        self.num_layers = num_layers
        self.return_intermediate = return_intermediate
        self.norm = (ChannelLayerNorm(n_embd, device=device)
                     if with_norm else None)
        for i in range(num_layers):
            self.add_module(f"layers_{i}", DecoderLayer(
                n_embd, n_head, n_hidden, path_pdrop=path_pdrop,
                n_qx_stride=n_qx_stride, n_kv_stride=n_kv_stride,
                use_local=use_local, win_size=win_size,
                use_rel_pe=use_rel_pe, proj_pdrop=proj_pdrop, device=device))

    def forward(self, tgt: Tensor, memory: Tensor, tgt_mask: Tensor,
                memory_mask: Tensor, pos: Optional[Tensor] = None,
                query_pos: Optional[Tensor] = None,
                cross_first: bool = False,
                generator: Generator = None) -> tuple[Tensor, Tensor]:
        out, out_mask = tgt, tgt_mask
        inter = []
        for i in range(self.num_layers):
            out, out_mask = getattr(self, f"layers_{i}")(
                out, memory, out_mask, memory_mask, pos=pos,
                query_pos=query_pos, cross_first=cross_first,
                generator=generator)
            if self.return_intermediate:
                inter.append(self.norm(out) if self.norm is not None else out)
        if self.norm is not None:
            out = self.norm(out)
            if self.return_intermediate:
                inter[-1] = out
        if self.return_intermediate:
            return torch.stack(inter), out_mask
        return out[None], out_mask


class DecoderOnly(Module):
    """Query decoder with zero-init targets and learned query positions
    (reference MaskedConvTransformerDecoderOnly,
    models/local_transformer.py:908-976)."""

    def __init__(self, n_embd: int, n_head: int,
                 n_hidden: Optional[int] = None, path_pdrop: float = 0.1,
                 n_qx_stride: int = 0, n_kv_stride: int = 1,
                 num_layers: int = 4, return_intermediate: bool = False,
                 use_local: bool = False, win_size: Optional[int] = None,
                 use_rel_pe: bool = False, proj_pdrop: float = 0.0, *,
                 device: torch.device):
        super().__init__()
        self.decoder = Decoder(
            n_embd, n_head, n_hidden, path_pdrop=path_pdrop,
            n_qx_stride=n_qx_stride, n_kv_stride=n_kv_stride,
            num_layers=num_layers, return_intermediate=return_intermediate,
            use_local=use_local, win_size=win_size, use_rel_pe=use_rel_pe,
            proj_pdrop=proj_pdrop, device=device)

    def forward(self, src: Tensor, mask: Tensor, query_embed: Tensor,
                pos_embed: Optional[Tensor] = None,
                cross_first: bool = False,
                generator: Generator = None) -> tuple[Tensor, Tensor]:
        """src (B, T, C), mask (B, T), query_embed (Q, C)."""
        bs = src.shape[0]
        q = query_embed[None].expand(bs, *query_embed.shape)
        tgt = torch.zeros_like(q)
        tgt_mask = torch.ones(q.shape[:2], dtype=torch.bool,
                              device=src.device)
        pos = (None if pos_embed is None
               else pos_embed[None].expand(bs, *pos_embed.shape))
        return self.decoder(tgt, src, tgt_mask, mask, pos=pos, query_pos=q,
                            cross_first=cross_first, generator=generator)
