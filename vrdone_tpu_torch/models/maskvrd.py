"""MaskVRD: one-stage video relation detection as 1-D instance segmentation
(counterpart of ``vrdone_tpu/models/maskvrd.py``, ``MaskVRD.__call__``).

The eval forward only: backbone -> FPN neck -> query predictor. Training
(losses, Hungarian matching) is not ported yet; see ROADMAP.md queue 1.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import ModelConfig
from .backbone import SOSBackbone
from .fpn import FPN1DFuse
from .layers import init_weights
from .predictor import MaskedTransformerPredictor

Tensor = torch.Tensor


class MaskVRD(nn.Module):
    """``generator`` fills the weights with the reference's random init;
    without one they are left uninitialised for ``load_state_dict``."""

    def __init__(self, config: ModelConfig, *, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = config
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype {cfg.compute_dtype!r}: the port serves fp32 "
                "only so far; see ROADMAP.md")
        self.config = cfg
        self.backbone = SOSBackbone(
            n_visual=cfg.visual_dim,
            n_bbox_entity=cfg.bbox_entity_dim,
            n_bbox_so=cfg.bbox_so_dim,
            n_embd=cfg.embd_dim,
            n_head=cfg.n_head,
            n_embd_ks=cfg.embd_kernel_size,
            fuse_ks=cfg.fuse_ks,
            n_fuse_head=cfg.fuse_head,
            fuse_path_drop=cfg.fuse_path_drop,
            fuse_qx_stride=cfg.fuse_qx_stride,
            fuse_kv_stride=cfg.fuse_kv_stride,
            max_len=cfg.max_seq_len,
            arch=cfg.backbone_arch,
            mha_win_size=cfg.mha_win_size,
            scale_factor=cfg.scale_factor,
            with_ln=cfg.embd_with_ln,
            path_pdrop=cfg.droppath,
            use_abs_pe=cfg.use_abs_pe,
            use_rel_pe=cfg.use_rel_pe,
            use_local=cfg.use_local,
            n_clip=cfg.clip_dim if cfg.with_clip_feature else None,
            device=device)
        self.neck = FPN1DFuse(
            in_channels=(cfg.embd_dim,) * (cfg.backbone_arch[-1] + 1),
            out_channel=cfg.fpn_dim,
            scale_factor=cfg.scale_factor,
            start_level=cfg.fpn_start_level,
            with_ln=cfg.fpn_with_ln,
            norm_first=cfg.fpn_norm_first,
            device=device)
        p = cfg.predictor
        self.predictor = MaskedTransformerPredictor(
            n_input=p.n_input, n_embd=p.n_embd, n_head=p.n_head,
            n_hidden=p.n_hidden, num_queries=p.num_queries,
            num_classes=p.num_classes, path_pdrop=p.path_pdrop,
            cls_prior_prob=p.cls_prior_prob, n_qx_stride=p.n_qx_stride,
            n_kv_stride=p.n_kv_stride, num_layers=p.num_layers,
            deep_supervision=p.deep_supervision,
            enforce_input_project=p.enforce_input_project, device=device)
        if generator is not None:
            init_weights(self, generator)
        self.eval()

    def forward(self, feats: Tensor, mask: Tensor) -> dict:
        """feats: (B, T, C_packed) fp32, mask: (B, T) bool -> predictions
        dict (pred_logits, pred_masks, aux_outputs, output_mask)."""
        if self.training:
            raise NotImplementedError(
                "the port runs the eval forward only; training is "
                "ROADMAP.md queue 1, item 5")
        pyramid, masks = self.backbone(feats, mask)
        fpn_feat, _ = self.neck(pyramid, masks)
        return self.predictor(pyramid[-1], fpn_feat, masks[-1],
                              output_mask=masks[0])
