"""Region proposal network of the C4 detector (counterpart of
``vrdone_tpu/models/rpn.py``): the anchor grid, the box coder and its
inverse (the training targets), the head and the static-shape proposal
selection."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops

Tensor = torch.Tensor

ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
STRIDE = 16
BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)


def make_anchors(feat_h: int, feat_w: int,
                 sizes=ANCHOR_SIZES, ratios=ANCHOR_RATIOS,
                 stride: int = STRIDE) -> np.ndarray:
    """(feat_h * feat_w * A, 4) xyxy anchor grid (host-side constant)."""
    base = []
    for s in sizes:
        area = float(s) ** 2
        for r in ratios:
            w = np.sqrt(area / r)
            h = w * r
            base.append([-w / 2, -h / 2, w / 2, h / 2])
    base = np.asarray(base, np.float32)                  # (A, 4)
    xs = (np.arange(feat_w) + 0.5) * stride
    ys = (np.arange(feat_h) + 0.5) * stride
    cx, cy = np.meshgrid(xs, ys)
    shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    anchors = shifts + base[None]                        # (HW, A, 4)
    return anchors.reshape(-1, 4).astype(np.float32)


def decode_boxes(anchors: Tensor, deltas: Tensor,
                 weights=BBOX_REG_WEIGHTS) -> Tensor:
    """Apply (dx, dy, dw, dh) regression deltas to xyxy anchors."""
    wx, wy, ww, wh = weights
    widths = anchors[:, 2] - anchors[:, 0]
    heights = anchors[:, 3] - anchors[:, 1]
    ctr_x = anchors[:, 0] + 0.5 * widths
    ctr_y = anchors[:, 1] + 0.5 * heights
    clip = float(np.log(1000.0 / 16))
    dx = deltas[:, 0] / wx
    dy = deltas[:, 1] / wy
    dw = (deltas[:, 2] / ww).clamp(max=clip)
    dh = (deltas[:, 3] / wh).clamp(max=clip)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([
        pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h], dim=1)


def encode_boxes(ref: Tensor, proposals: Tensor,
                 weights=BBOX_REG_WEIGHTS) -> Tensor:
    """The inverse of ``decode_boxes``: the deltas that move ``proposals``
    onto ``ref`` (the regression targets). Widths and heights are clamped
    to 1 pixel, so degenerate (clipped or padded) boxes give finite
    targets; the losses gate them out."""
    wx, wy, ww, wh = weights
    pw = (proposals[:, 2] - proposals[:, 0]).clamp(min=1.0)
    ph = (proposals[:, 3] - proposals[:, 1]).clamp(min=1.0)
    px = proposals[:, 0] + 0.5 * pw
    py = proposals[:, 1] + 0.5 * ph
    gw = (ref[:, 2] - ref[:, 0]).clamp(min=1.0)
    gh = (ref[:, 3] - ref[:, 1]).clamp(min=1.0)
    gx = ref[:, 0] + 0.5 * gw
    gy = ref[:, 1] + 0.5 * gh
    return torch.stack([
        wx * (gx - px) / pw, wy * (gy - py) / ph,
        ww * torch.log(gw / pw), wh * torch.log(gh / ph)], dim=1)


class RPNHead(nn.Module):
    """3x3 conv + 1x1 objectness and box heads: (N, C, H, W) ->
    logits (N, H, W, A) and deltas (N, H, W, 4A), the JAX layout."""

    def __init__(self, channels: int = 1024,
                 num_anchors: int = len(ANCHOR_SIZES) * len(ANCHOR_RATIOS), *,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, device=device)
        self.cls_logits = nn.Conv2d(channels, num_anchors, 1, device=device)
        self.bbox_pred = nn.Conv2d(channels, 4 * num_anchors, 1,
                                   device=device)
        with torch.no_grad():
            for m in (self.conv, self.cls_logits, self.bbox_pred):
                nn.init.normal_(m.weight, 0.0, 0.01, generator=generator)
                m.bias.zero_()

    def forward(self, feat: Tensor) -> tuple[Tensor, Tensor]:
        h = F.relu(self.conv(feat))
        return (self.cls_logits(h).permute(0, 2, 3, 1),
                self.bbox_pred(h).permute(0, 2, 3, 1))


def select_proposals(anchors: Tensor, logits: Tensor, bbox_deltas: Tensor,
                     image_hw, *, pre_nms_top_n: int = 6000,
                     post_nms_top_n: int = 300, nms_thresh: float = 0.7,
                     min_size: int = 0) -> tuple[Tensor, Tensor, Tensor]:
    """Anchor scores + deltas -> the post-NMS proposal set.

    anchors (N, 4), logits (N,), bbox_deltas (N, 4), image_hw (h, w).
    Returns (boxes (P, 4), sigmoid scores (P,), valid (P,)),
    P = post_nms_top_n; slots past the survivors repeat box 0's entry and
    are marked invalid."""
    n = anchors.shape[0]
    k = min(pre_nms_top_n, n)
    # a stable descending sort: ties keep the lower index first, as
    # lax.top_k does
    top_scores, top_idx = torch.sort(logits, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    boxes = decode_boxes(anchors[top_idx], bbox_deltas[top_idx])
    h, w = float(image_hw[0]), float(image_hw[1])
    boxes = torch.stack([
        boxes[:, 0].clamp(0, w - 1), boxes[:, 1].clamp(0, h - 1),
        boxes[:, 2].clamp(0, w - 1), boxes[:, 3].clamp(0, h - 1)], dim=1)
    keep = ((boxes[:, 2] - boxes[:, 0] >= min_size)
            & (boxes[:, 3] - boxes[:, 1] >= min_size))
    scores = torch.where(keep, top_scores, -math.inf)
    keep_idx, keep_valid = box_ops.nms(boxes, scores, nms_thresh,
                                       max_out=post_nms_top_n)
    return boxes[keep_idx], torch.sigmoid(scores[keep_idx]), keep_valid
