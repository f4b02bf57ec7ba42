"""Subject-Object Synergy (SOS) backbone (counterpart of
``vrdone_tpu/models/backbone.py``, ``SOSBackbone.__call__``).

Embeds the subject/object visual streams and bbox geometry streams of each
SO-pair sequence, runs subject<->object mutual cross-attention in the stem,
fuses, and produces a temporal feature pyramid. The packed input's channels
are ``[s_visual | o_visual | so_bbox | s_bbox | o_bbox]``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import masked as mops
from .layers import (ChannelLayerNorm, ConvMLP, DecoderLayer, MaskedConv1D,
                     TransformerBlock)

Tensor = torch.Tensor


class SOSBackbone(nn.Module):
    """Conv-transformer backbone with subject-object mutual attention."""

    def __init__(self, n_visual: int, n_bbox_entity: int, n_bbox_so: int,
                 n_embd: int, n_head: int, n_embd_ks: int, fuse_ks: int,
                 n_fuse_head: int, fuse_path_drop: float, fuse_qx_stride: int,
                 fuse_kv_stride: int, max_len: int,
                 arch: tuple[int, int, int] = (2, 2, 3),
                 mha_win_size: Sequence[int] = (-1, -1, -1, -1),
                 scale_factor: int = 2, with_ln: bool = False,
                 path_pdrop: float = 0.0, use_abs_pe: bool = False,
                 use_rel_pe: bool = False, use_local: bool = True,
                 n_clip: Optional[int] = None, proj_pdrop: float = 0.0, *,
                 device: torch.device):
        super().__init__()
        if len(arch) != 3 or len(mha_win_size) != 1 + arch[-1]:
            raise ValueError(f"bad arch {arch} / windows {mha_win_size}")
        if n_clip is not None:
            raise NotImplementedError(
                "the CLIP-fused backbone is not ported yet; see ROADMAP.md "
                "queue 1")
        self.n_visual = n_visual
        self.n_bbox_so = n_bbox_so
        self.n_bbox_entity = n_bbox_entity
        self.arch = tuple(arch)
        self.with_ln = with_ln
        self.use_abs_pe = use_abs_pe
        self.max_len = max_len

        for i in range(arch[0]):
            self.add_module(f"visual_embd_{i}", MaskedConv1D(
                n_visual if i == 0 else n_embd, n_embd, n_embd_ks,
                use_bias=not with_ln, device=device))
            if with_ln:
                self.add_module(f"visual_embd_norm_{i}",
                                ChannelLayerNorm(n_embd, device=device))
        self.bbox_entity_embd = MaskedConv1D(n_bbox_entity, n_embd, n_embd_ks,
                                             device=device)
        self.bbox_entity_norm = (ChannelLayerNorm(n_embd, device=device)
                                 if with_ln else None)
        self.visual_bbox_fuse = ConvMLP(2 * n_embd, n_embd, n_embd,
                                        num_layers=2, kernel_size=fuse_ks,
                                        device=device)
        for i in range(arch[1]):
            self.add_module(f"stem_{i}", TransformerBlock(
                n_embd, n_head, n_ds_strides=(1, 1), path_pdrop=path_pdrop,
                mha_win_size=mha_win_size[0], use_rel_pe=use_rel_pe,
                proj_pdrop=proj_pdrop, device=device))
        # the S/O mutual layers take no relative-position bias, as in the
        # JAX package
        for stream in ("s", "o"):
            for i in range(arch[1]):
                self.add_module(f"{stream}_attn_{i}", DecoderLayer(
                    n_embd, n_fuse_head, path_pdrop=fuse_path_drop,
                    n_qx_stride=fuse_qx_stride, n_kv_stride=fuse_kv_stride,
                    with_ffn=False, use_local=use_local,
                    win_size=mha_win_size[0] if use_local else None,
                    device=device))
        self.s_fuse_norm = ChannelLayerNorm(n_embd, device=device)
        self.o_fuse_norm = ChannelLayerNorm(n_embd, device=device)
        self.so_fuse = ConvMLP(2 * n_embd, n_embd, n_embd, num_layers=2,
                               kernel_size=fuse_ks, device=device)
        self.bbox_so_embd = MaskedConv1D(n_bbox_so, n_embd, n_embd_ks,
                                         device=device)
        self.so_visual_bbox_fuse = ConvMLP(2 * n_embd, n_embd, n_embd,
                                           num_layers=2, kernel_size=fuse_ks,
                                           device=device)
        for i in range(arch[2]):
            self.add_module(f"branch_{i}", TransformerBlock(
                n_embd, n_head, n_ds_strides=(scale_factor, scale_factor),
                path_pdrop=path_pdrop, mha_win_size=mha_win_size[1 + i],
                use_rel_pe=use_rel_pe, proj_pdrop=proj_pdrop,
                device=device))
        if use_abs_pe:
            # a fixed table, not a parameter (reference registers it as a
            # non-persistent buffer, backbones.py:70-72)
            pe = torch.from_numpy(mops.sinusoid_encoding(max_len, n_embd))
            self.register_buffer("pos_embd", (pe / n_embd ** 0.5).to(device),
                                 persistent=False)

    def _split_channels(self, x: Tensor):
        nv, nso, ne = self.n_visual, self.n_bbox_so, self.n_bbox_entity
        expect = 2 * nv + nso + 2 * ne
        if x.shape[-1] != expect:
            raise ValueError(f"packed input has {x.shape[-1]} channels, "
                             f"expected {expect}")
        return (x[..., :nv], x[..., nv:2 * nv], x[..., 2 * nv:2 * nv + nso],
                x[..., 2 * nv + nso:2 * nv + nso + ne],
                x[..., 2 * nv + nso + ne:])

    def _pe(self, t: int) -> Tensor:
        """The table cut to t frames; at eval, stretched linearly past
        max_len (training sequences never exceed it)."""
        if self.training:
            if t > self.max_len:
                raise ValueError(f"training sequence of {t} frames exceeds "
                                 f"max_seq_len {self.max_len}")
            return self.pos_embd[:t]
        if t >= self.max_len:
            return mops.resize_pe_linear(self.pos_embd, t)
        return self.pos_embd[:t]

    def _norm_relu(self, norm: Optional[nn.Module], x: Tensor) -> Tensor:
        return F.relu(norm(x) if norm is not None else x)

    def forward(self, x: Tensor, mask: Tensor,
                generator: Optional[torch.Generator] = None
                ) -> tuple[tuple[Tensor, ...], tuple[Tensor, ...]]:
        """x: (B, T, C_packed), mask: (B, T) bool. Returns (feats, masks):
        pyramid tuples, level 0 at full resolution. ``generator`` feeds
        stochastic depth and dropout in training."""
        g = generator
        s_feat, o_feat, so_bbox, s_bbox, o_bbox = self._split_channels(x)
        mask_f = mask[..., None].to(s_feat.dtype)

        # shared-weight conv embedding of both visual streams
        for i in range(self.arch[0]):
            conv = getattr(self, f"visual_embd_{i}")
            norm = getattr(self, f"visual_embd_norm_{i}", None)
            s_feat = self._norm_relu(norm, conv(s_feat, mask)[0])
            o_feat = self._norm_relu(norm, conv(o_feat, mask)[0])

        if self.use_abs_pe:
            if s_feat.dtype != torch.float32:
                # the fp32 table promotes the streams to fp32, and the JAX
                # package's next convolution then refuses fp32 inputs with
                # bf16 weights (lax.conv_general_dilated): no bf16 path
                raise TypeError(
                    f"use_abs_pe takes float32 features and parameters, got "
                    f"{s_feat.dtype}, as in the JAX package")
            pe = self._pe(s_feat.shape[1])[None]
            s_feat = s_feat + pe * mask_f
            o_feat = o_feat + pe * mask_f

        # bbox geometry streams (shared entity embedding)
        s_bbox = self._norm_relu(self.bbox_entity_norm,
                                 self.bbox_entity_embd(s_bbox, mask)[0])
        o_bbox = self._norm_relu(self.bbox_entity_norm,
                                 self.bbox_entity_embd(o_bbox, mask)[0])
        s_feat = self.visual_bbox_fuse(torch.cat([s_feat, s_bbox], -1),
                                       g) * mask_f
        o_feat = self.visual_bbox_fuse(torch.cat([o_feat, o_bbox], -1),
                                       g) * mask_f

        # stem: per-stream encoding + subject-object mutual cross-attention
        for i in range(self.arch[1]):
            blk = getattr(self, f"stem_{i}")
            s_feat, _ = blk(s_feat, mask, generator=g)
            o_feat, _ = blk(o_feat, mask, generator=g)
            s_mut, _ = getattr(self, f"s_attn_{i}")(s_feat, o_feat, mask, mask,
                                                    generator=g)
            o_mut, _ = getattr(self, f"o_attn_{i}")(o_feat, s_feat, mask, mask,
                                                    generator=g)
            s_feat = s_feat + s_mut
            o_feat = o_feat + o_mut

        s_feat = self.s_fuse_norm(s_feat)
        o_feat = self.o_fuse_norm(o_feat)
        so_feat = self.so_fuse(torch.cat([s_feat, o_feat], -1), g) * mask_f
        so_bbox, _ = self.bbox_so_embd(so_bbox, mask)
        so_embedding = self.so_visual_bbox_fuse(
            torch.cat([so_feat, so_bbox], -1), g) * mask_f

        feats = (so_embedding,)
        masks = (mask,)
        for i in range(self.arch[2]):
            so_embedding, mask = getattr(self, f"branch_{i}")(
                so_embedding, mask, generator=g)
            feats += (so_embedding,)
            masks += (mask,)
        return feats, masks
