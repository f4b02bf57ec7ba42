"""Mask and keypoint RoI heads, Mask R-CNN's and Keypoint R-CNN's
(counterpart of ``vrdone_tpu/models/mask_keypoint.py``): the heads, their
training targets and losses on static shapes (validity masks, "only
positive boxes" as a weight), and the host post-processing.

The modules carry the flax names (``mask_fcn1``, ``conv5_mask``,
``kps_score_lowres``, ...), so ``convert.py`` crosses the JAX parameters one
to one. Heads take and return JAX's layout, (R, res, res, C), and run NCHW
inside; a convolution computes in the common dtype of its input and
parameters, as flax promotes them, and ``Deconv`` casts its kernel to the
input's dtype, as JAX's does. ``_bilinear_resize``, ``paste_masks_in_image``
and ``heatmaps_to_keypoints`` (numpy) are word-for-word copies of the JAX
package's, pinned by ``tests/test_torch_copies.py``.

Deviation from the reference, as in the JAX package: heatmaps_to_keypoints
upsamples per-roi heatmaps with bilinear interpolation instead of the
reference's cv2 INTER_CUBIC (inference.py:73-75); argmax locations agree
except near plateau ties.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .detector_train import match_boxes
from .retinanet import conv

Tensor = torch.Tensor


def _kaiming_out(layer: nn.Module, generator: torch.Generator | None
                 ) -> None:
    """kaiming_normal_(mode="fan_out", relu) of the weight (out, in, kh,
    kw), a zero bias: the Caffe2 MSRAFill init both reference predictors
    use."""
    out, _, kh, kw = layer.weight.shape
    with torch.no_grad():
        nn.init.normal_(layer.weight, 0.0, math.sqrt(2.0 / (kh * kw * out)),
                        generator=generator)
        layer.bias.zero_()


def _conv(in_ch: int, out: int, k: int, dilation: int, device, generator
          ) -> nn.Conv2d:
    layer = nn.Conv2d(in_ch, out, k, padding=dilation * (k // 2),
                      dilation=dilation, device=device)
    _kaiming_out(layer, generator)
    return layer


class Deconv(nn.Module):
    """torch ConvTranspose2d(k, s, p) as JAX computes it: a convolution of
    the zero-inserted input (``lhs_dilation``) padded k - 1 - p with the
    kernel JAX stores pre-flipped. ``weight`` (out, in, kh, kw) is that
    flipped forward kernel (``convert.py``'s 4-D rule from JAX's (kh, kw,
    in, out)), so the transposed convolution here runs on it flipped back
    and with in and out swapped."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int,
                 padding: int, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel,
                                               kernel, device=device))
        self.bias = nn.Parameter(torch.empty(features, device=device))
        self.stride, self.padding = stride, padding
        _kaiming_out(self, generator)

    def forward(self, x: Tensor) -> Tensor:
        w = self.weight.to(x.dtype).flip(2, 3).transpose(0, 1)
        return F.conv_transpose2d(x, w, self.bias.to(x.dtype),
                                  stride=self.stride, padding=self.padding)


class MaskHead(nn.Module):
    """MaskRCNNFPNFeatureExtractor conv tower + MaskRCNNC4Predictor.

    conv_layers=() degenerates to the bare predictor, the C4 /
    SHARE_BOX_FEATURE_EXTRACTOR path, where the input is the box head's
    (R, 7, 7, 2048) C5 features. num_classes counts background, like the
    reference channel dim.

    (R, res, res, C) pooled features -> (R, 2*res, 2*res, num_classes)
    per-class mask logits."""

    def __init__(self, in_channels: int, num_classes: int,
                 conv_layers: Sequence[int] = (256, 256, 256, 256),
                 dim_reduced: int | None = None, dilation: int = 1, *,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.n_convs = len(conv_layers)
        ch = in_channels
        for i, out in enumerate(conv_layers):
            self.add_module(f"mask_fcn{i + 1}", _conv(ch, out, 3, dilation,
                                                      **kw))
            ch = out
        dim = dim_reduced if dim_reduced is not None else (
            conv_layers[-1] if conv_layers else 256)
        self.conv5_mask = Deconv(ch, dim, 2, 2, 0, **kw)
        self.mask_fcn_logits = _conv(dim, num_classes, 1, 1, **kw)

    def forward(self, x: Tensor) -> Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            x = F.relu(conv(getattr(self, f"mask_fcn{i + 1}"), x))
        x = F.relu(self.conv5_mask(x))
        return conv(self.mask_fcn_logits, x).permute(0, 2, 3, 1)


class KeypointHead(nn.Module):
    """KeypointRCNNFeatureExtractor (8x conv3x3-512) +
    KeypointRCNNPredictor (deconv k4 s2 p1, then 2x bilinear upsample with
    half-pixel centres, as jax.image.resize samples, the border rows
    clamped).

    (R, res, res, C) -> (R, 4*res, 4*res, num_keypoints) heatmap logits."""

    def __init__(self, in_channels: int, num_keypoints: int = 17,
                 conv_layers: Sequence[int] = (512,) * 8, *,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.n_convs = len(conv_layers)
        ch = in_channels
        for i, out in enumerate(conv_layers):
            self.add_module(f"conv_fcn{i + 1}", _conv(ch, out, 3, 1, **kw))
            ch = out
        self.kps_score_lowres = Deconv(ch, num_keypoints, 4, 2, 1, **kw)

    def forward(self, x: Tensor) -> Tensor:
        x = x.permute(0, 3, 1, 2)
        for i in range(self.n_convs):
            x = F.relu(conv(getattr(self, f"conv_fcn{i + 1}"), x))
        x = self.kps_score_lowres(x)
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Training targets + losses
# ---------------------------------------------------------------------------

def project_masks_on_boxes(gt_bitmaps: Tensor, boxes: Tensor, m: int
                           ) -> Tensor:
    """Crop+resize GT bitmaps to per-roi (m, m) binary targets: bilinear
    samples at the m x m bin centres inside each box (crop width floored at
    1 px), thresholded at 0.5. The bilinear weights fold into one (R, m, Hm)
    and one (R, m, Wm) matrix, as ``ops/boxes.py::roi_align`` folds them.

    gt_bitmaps: (R, Hm, Wm) each roi's matched GT mask in image
    coordinates; boxes: (R, 4) xyxy in the same frame."""
    r, hm, wm = gt_bitmaps.shape
    x1, y1, x2, y2 = boxes.unbind(1)
    bw = (x2 - x1).clamp(min=1.0)
    bh = (y2 - y1).clamp(min=1.0)
    centres = (torch.arange(m, device=boxes.device) + 0.5)[None, :] / m
    xs = x1[:, None] + centres * bw[:, None]
    ys = y1[:, None] + centres * bh[:, None]

    def weights(coords, size):
        cc = coords.clamp(0.0, size - 1.0)
        lo = torch.floor(cc).long()
        hi = (lo + 1).clamp(max=size - 1)
        f = cc - lo
        return ((1.0 - f)[..., None] * F.one_hot(lo, size)
                + f[..., None] * F.one_hot(hi, size))

    wy = weights(ys, hm)                      # (R, m, Hm)
    wx = weights(xs, wm)                      # (R, m, Wm)
    vals = torch.einsum("rmh,rhw,rnw->rmn", wy, gt_bitmaps.to(wy.dtype), wx)
    return (vals >= 0.5).float()


def mask_head_targets(proposals: Tensor, proposals_valid: Tensor,
                      gt_boxes: Tensor, gt_labels: Tensor, gt_valid: Tensor,
                      gt_bitmaps: Tensor, m: int, *, fg_iou: float = 0.5,
                      bg_iou: float = 0.5):
    """Match proposals to GT (no low-quality matches; positives are
    matched and valid) and build mask targets. Returns (labels (P,)
    matched class ids, pos_weight (P,) 1.0 on positives, mask_targets (P,
    m, m))."""
    match = match_boxes(proposals, gt_boxes, gt_valid, high=fg_iou,
                        low=bg_iou, force_match=False)
    pos = (match.labels == 1) & proposals_valid
    labels = torch.where(pos, gt_labels[match.matched_idx], 0)
    targets = project_masks_on_boxes(gt_bitmaps[match.matched_idx],
                                     proposals, m)
    return labels, pos.float(), targets


def mask_loss(mask_logits: Tensor, labels: Tensor, pos_weight: Tensor,
              mask_targets: Tensor) -> Tensor:
    """BCE-with-logits on each positive roi's own-class channel, averaged
    over every element of the positive set.

    mask_logits: (P, M, M, K); labels: (P,) int class ids; pos_weight:
    (P,) float; mask_targets: (P, M, M) in {0, 1}."""
    sel = torch.take_along_dim(mask_logits,
                               labels.long()[:, None, None, None],
                               dim=-1)[..., 0]
    bce = (sel.clamp(min=0) - sel * mask_targets
           + torch.log1p(torch.exp(-sel.abs())))
    per_roi = bce.mean(dim=(1, 2))
    denom = pos_weight.sum().clamp(min=1.0)
    return (pos_weight * per_roi).sum() / denom


def keypoints_to_heatmap(keypoints: Tensor, rois: Tensor,
                         heatmap_size: int) -> tuple[Tensor, Tensor]:
    """Reference keypoints_to_heat_map (structures/keypoint.py:154-188):
    linear heatmap bin + validity per (roi, keypoint), int32, in JAX's
    fp32 arithmetic. keypoints: (R, K, 3) xyv; rois: (R, 4)."""
    hs = heatmap_size
    offset_x = rois[:, 0:1]
    offset_y = rois[:, 1:2]
    scale_x = hs / (rois[:, 2:3] - rois[:, 0:1])
    scale_y = hs / (rois[:, 3:4] - rois[:, 1:2])

    x_raw = keypoints[..., 0]
    y_raw = keypoints[..., 1]
    x_boundary = x_raw == rois[:, 2:3]
    y_boundary = y_raw == rois[:, 3:4]
    x = torch.floor((x_raw - offset_x) * scale_x).int()
    y = torch.floor((y_raw - offset_y) * scale_y).int()
    x = torch.where(x_boundary, hs - 1, x)
    y = torch.where(y_boundary, hs - 1, y)

    valid_loc = (x >= 0) & (y >= 0) & (x < hs) & (y < hs)
    vis = keypoints[..., 2] > 0
    valid = (valid_loc & vis).int()
    heatmaps = (y * hs + x) * valid
    return heatmaps, valid


def keypoint_loss(kp_logits: Tensor, heatmaps: Tensor, valid: Tensor,
                  roi_weight: Tensor | None = None) -> Tensor:
    """Spatial-softmax cross entropy over heatmap bins at valid keypoints.

    kp_logits: (P, H, W, K); heatmaps: (P, K) linear bin targets;
    valid: (P, K) {0,1}; roi_weight optionally masks sampled rois."""
    p, h, w, k = kp_logits.shape
    flat = kp_logits.permute(0, 3, 1, 2).reshape(p * k, h * w)
    logp = F.log_softmax(flat, dim=-1)
    ce = -torch.take_along_dim(logp, heatmaps.reshape(p * k, 1).long(),
                               dim=-1)[:, 0]
    wgt = valid.float()
    if roi_weight is not None:
        wgt = wgt * roi_weight[:, None]
    wgt = wgt.reshape(p * k)
    return (wgt * ce).sum() / wgt.sum().clamp(min=1.0)


def keypoint_head_targets(proposals: Tensor, proposals_valid: Tensor,
                          gt_boxes: Tensor, gt_valid: Tensor,
                          gt_keypoints: Tensor, heatmap_size: int, *,
                          fg_iou: float = 0.5, bg_iou: float = 0.5):
    """Match proposals to GT keypoint sets and build heatmap targets. A
    positive needs at least one visible keypoint inside the matched box.
    gt_keypoints: (G, K, 3). Returns (pos_weight (P,), heatmaps (P, K),
    valid (P, K)); ``keypoint_loss`` gates validity by pos_weight through
    roi_weight."""
    match = match_boxes(proposals, gt_boxes, gt_valid, high=fg_iou,
                        low=bg_iou, force_match=False)
    kp = gt_keypoints[match.matched_idx]                # (P, K, 3)
    boxes = gt_boxes[match.matched_idx]
    within = ((kp[..., 0] >= boxes[:, 0:1]) & (kp[..., 0] <= boxes[:, 2:3])
              & (kp[..., 1] >= boxes[:, 1:2])
              & (kp[..., 1] <= boxes[:, 3:4]))
    vis = kp[..., 2] > 0
    is_visible = (within & vis).sum(1) > 0
    pos = (match.labels == 1) & proposals_valid & is_visible
    heatmaps, valid = keypoints_to_heatmap(kp, proposals, heatmap_size)
    return pos.float(), heatmaps, valid


# ---------------------------------------------------------------------------
# Inference post-processing
# ---------------------------------------------------------------------------

def select_mask_probs(mask_logits: Tensor, labels: Tensor) -> Tensor:
    """sigmoid + per-roi predicted-class channel (reference
    MaskPostProcessor.forward): (R, M, M, K), (R,) -> (R, M, M)."""
    probs = torch.sigmoid(mask_logits)
    return torch.take_along_dim(probs, labels.long()[:, None, None, None],
                                dim=-1)[..., 0]


def _bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """numpy bilinear resize, half-pixel centers (align_corners=False) —
    matches torch F.interpolate(mode="bilinear")."""
    h, w = img.shape
    ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def paste_masks_in_image(mask_probs: np.ndarray, boxes: np.ndarray,
                         image_hw, *, thresh: float = 0.5,
                         padding: int = 1) -> np.ndarray:
    """Project per-roi (M, M) mask probabilities into full-image binary
    masks (reference Masker / paste_mask_in_image,
    mask_head/inference.py:110-160): pad by 1, expand the box by the same
    ratio, bilinear-resize to the box, threshold, paste.

    Host numpy, like the detector's postprocess_frame. Returns
    (R, H, W) bool."""
    im_h, im_w = int(image_hw[0]), int(image_hw[1])
    r, m, _ = mask_probs.shape
    out = np.zeros((r, im_h, im_w), bool)
    scale = float(m + 2 * padding) / m
    for i in range(r):
        padded = np.zeros((m + 2 * padding, m + 2 * padding), np.float32)
        padded[padding:-padding or None, padding:-padding or None] = \
            mask_probs[i]
        b = boxes[i].astype(np.float64)
        w_half = (b[2] - b[0]) * 0.5 * scale
        h_half = (b[3] - b[1]) * 0.5 * scale
        x_c = (b[2] + b[0]) * 0.5
        y_c = (b[3] + b[1]) * 0.5
        box = np.array([x_c - w_half, y_c - h_half,
                        x_c + w_half, y_c + h_half]).astype(np.int32)
        w = max(int(box[2] - box[0] + 1), 1)
        h = max(int(box[3] - box[1] + 1), 1)
        resized = _bilinear_resize(padded, h, w) > thresh
        x_0, x_1 = max(box[0], 0), min(box[2] + 1, im_w)
        y_0, y_1 = max(box[1], 0), min(box[3] + 1, im_h)
        if x_1 > x_0 and y_1 > y_0:
            out[i, y_0:y_1, x_0:x_1] = resized[
                y_0 - box[1]:y_1 - box[1], x_0 - box[0]:x_1 - box[0]]
    return out


def heatmaps_to_keypoints(maps: np.ndarray, rois: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Heatmap logits -> keypoint coordinates + scores (reference
    keypoint_head/inference.py:40-93 semantics; bilinear instead of
    cv2 INTER_CUBIC upsampling — see module docstring).

    maps: (R, H, W, K); rois: (R, 4). Returns (xy_preds (R, K, 3) with
    (x, y, 1), scores (R, K))."""
    r, _, _, k = maps.shape
    xy = np.zeros((r, k, 3), np.float32)
    scores = np.zeros((r, k), np.float32)
    widths = np.maximum(rois[:, 2] - rois[:, 0], 1)
    heights = np.maximum(rois[:, 3] - rois[:, 1], 1)
    for i in range(r):
        rw = int(np.ceil(widths[i]))
        rh = int(np.ceil(heights[i]))
        wc = widths[i] / rw
        hc = heights[i] / rh
        for kk in range(k):
            roi_map = _bilinear_resize(maps[i, :, :, kk], rh, rw)
            pos = roi_map.reshape(-1).argmax()
            x_int = pos % rw
            y_int = pos // rw
            xy[i, kk, 0] = (x_int + 0.5) * wc + rois[i, 0]
            xy[i, kk, 1] = (y_int + 0.5) * hc + rois[i, 1]
            xy[i, kk, 2] = 1.0
            scores[i, kk] = roi_map[y_int, x_int]
    return xy, scores
