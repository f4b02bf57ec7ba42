"""MaskVRD: one-stage video relation detection as 1-D instance segmentation
(counterpart of ``vrdone_tpu/models/maskvrd.py``, ``MaskVRD.__call__``).

Backbone -> FPN neck -> query predictor, in eval mode (``model.eval()``)
or training mode (``model.train()``, stochastic depth and dropout from the
``generator`` handed to ``forward``), plus the training objective:
Hungarian matching, focal/dice mask losses with fuzzy boundaries and
weighted CE, with deep supervision (``compute_losses``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.hungarian import match_padded
from . import losses as LO
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
            proj_pdrop=cfg.dropout,
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
            enforce_input_project=p.enforce_input_project,
            proj_pdrop=p.proj_pdrop, device=device)
        if generator is not None:
            init_weights(self, generator)
        self.eval()

    def forward(self, feats: Tensor, mask: Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        """feats: (B, T, C_packed), mask: (B, T) bool -> predictions dict
        (pred_logits, pred_masks, aux_outputs, output_mask). In training
        mode ``generator`` draws the drop-path and dropout masks.

        Precision, as in the JAX package: the network computes in the float
        dtype its parameters and ``feats`` carry (both bf16 for bf16
        serving: ``utils.precision.cast_floating``); LayerNorm statistics
        and the attention softmax run in fp32 inside, and the heads come
        back in fp32. ``compute_dtype`` is not read here (the JAX train
        loop reads it)."""
        pyramid, masks = self.backbone(feats, mask, generator)
        fpn_feat, _ = self.neck(pyramid, masks)
        preds = self.predictor(pyramid[-1], fpn_feat, masks[-1],
                               output_mask=masks[0], generator=generator)
        return _heads_to_f32(preds)


def _heads_to_f32(x):
    """Every floating tensor of the predictions (nested in lists and dicts)
    in fp32; the bool output mask as it is."""
    if isinstance(x, dict):
        return {k: _heads_to_f32(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_heads_to_f32(v) for v in x]
    return x.float() if x.is_floating_point() else x


# ---------------------------------------------------------------------------
# training objective (functions of predictions + padded gt)
# ---------------------------------------------------------------------------
#
# Training batch contract (vrdone_tpu_torch/data/batching.py), as tensors:
#     feats (B, T, C), seq_mask (B, T) bool, item_valid (B,) bool,
#     gt_labels (B, G) int, gt_masks (B, G, T) float, gt_segs (B, G, 2) int,
#     gt_valid (B, G) bool.

def match(cfg: ModelConfig, pred_logits: Tensor, pred_masks: Tensor,
          gt: dict) -> tuple[Tensor, Tensor]:
    """Hungarian matching of L stacked levels at once.

    pred_logits (L, B, Q, K+1), pred_masks (L, B, Q, T). Returns
    (row_for_col (L, B, G) int64, matched (B, G) bool). One batched matcher
    call over all L x B problems, as the JAX package vmaps the levels."""
    scale_range = cfg.scale_range if cfg.with_fuzzy else None
    with torch.no_grad():
        cost = LO.matching_cost(
            pred_logits, pred_masks, gt["gt_labels"], gt["gt_masks"],
            gt["gt_segs"], gt["gt_valid"], gt["seq_mask"],
            cost_class=cfg.cost_class, cost_mask=cfg.cost_mask,
            cost_dice=cfg.cost_dice, scale_range=scale_range)
    levels, b, q, g = cost.shape
    valid = gt["gt_valid"]
    row_for_col, _ = match_padded(
        cost.reshape(levels * b, q, g),
        valid.expand(levels, b, g).reshape(levels * b, g))
    return row_for_col.reshape(levels, b, g), valid


def _single_level_losses(cfg: ModelConfig, pred_logits: Tensor,
                         pred_masks: Tensor, gt: dict, num_masks: Tensor,
                         row_for_col: Tensor, matched: Tensor) -> dict:
    b, q, _ = pred_logits.shape
    item_valid = gt["item_valid"]
    out = {}
    if "labels" in cfg.loss_types:
        # scatter matched labels into (B, Q); rows are distinct per item
        labels = torch.where(matched, gt["gt_labels"].long(), 0)
        target = torch.zeros((b, q), dtype=torch.int64,
                             device=pred_logits.device)
        target = target.scatter(1, row_for_col, labels)
        logp = F.log_softmax(pred_logits, dim=-1)
        ce = -logp.gather(-1, target[..., None])[..., 0]
        # padded batch items weigh nothing (the reference's batches are
        # ragged and never hold them)
        w = torch.where(target == 0, cfg.eos_coef, 1.0).to(ce.dtype)
        w = w * item_valid[:, None].to(w.dtype)
        loss_ce = (w * ce).sum() / w.sum().clamp(min=1e-6)
        out["loss_class"] = cfg.loss_class * loss_ce

    if "masks" in cfg.loss_types:
        tgt = gt["gt_masks"]
        g, t = tgt.shape[1:]
        pred_sel = pred_masks.gather(
            1, row_for_col[..., None].expand(b, g, t))      # (B, G, T)
        loss_mask = gt["seq_mask"][:, None, :].expand(tgt.shape)
        pv = (matched & item_valid[:, None]).reshape(-1)

        def flat(x):
            return x.reshape(-1, t)

        if cfg.with_fuzzy:
            segs = gt["gt_segs"].reshape(-1, 2)
            out["loss_mask"] = cfg.loss_mask * LO.matched_focal_fuzzy_loss(
                flat(pred_sel), flat(tgt), segs, flat(loss_mask), pv,
                num_masks, cfg.scale_range)
            out["loss_dice"] = cfg.loss_dice * LO.matched_dice_fuzzy_loss(
                flat(pred_sel), flat(tgt), segs, flat(loss_mask), pv,
                num_masks, cfg.scale_range)
        else:
            out["loss_mask"] = cfg.loss_mask * LO.matched_focal_loss(
                flat(pred_sel), flat(tgt), flat(loss_mask), pv, num_masks)
            out["loss_dice"] = cfg.loss_dice * LO.matched_dice_loss(
                flat(pred_sel), flat(tgt), flat(loss_mask), pv, num_masks)
    return out


def compute_losses(cfg: ModelConfig, predictions: dict, gt: dict) -> dict:
    """The training objective with deep supervision (reference
    maskvrd.py:569-588): the final level's terms as ``loss_*``, auxiliary
    level i's as ``loss_*_{i}``, and their sum as ``total_loss``.
    ``num_masks`` is the global count of valid ground truth in valid
    items."""
    num_masks = (gt["gt_valid"] & gt["item_valid"][:, None]).sum().clamp(
        min=1).float()
    aux = predictions.get("aux_outputs") or []
    logits = torch.stack([predictions["pred_logits"],
                          *[a["pred_logits"] for a in aux]])
    masks = torch.stack([predictions["pred_masks"],
                         *[a["pred_masks"] for a in aux]])
    row_for_col, matched = match(cfg, logits, masks, gt)
    # each level's terms in sorted order, as the JAX package's vmap returns
    # them (the order of the sum that makes total_loss)
    per = [dict(sorted(_single_level_losses(
        cfg, logits[i], masks[i], gt, num_masks, row_for_col[i],
        matched).items())) for i in range(logits.shape[0])]
    loss_dict = dict(per[0])
    for i, level in enumerate(per[1:]):
        loss_dict.update({f"{k}_{i}": v for k, v in level.items()})
    loss_dict["total_loss"] = sum(loss_dict.values())
    return loss_dict
