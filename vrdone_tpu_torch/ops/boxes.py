"""Box ops of the detection stage: IoU, greedy NMS, RoIAlign (counterpart of
``vrdone_tpu/ops/boxes.py``).

Plain PyTorch on whatever device the tensors lie: none of these is a Pallas
kernel in the JAX package, and torchvision, whose compiled versions the
reference calls, is not installed. A CUDA NMS and RoIAlign are later work
(ROADMAP.md queue 1, the benchmark (CUDA NMS)).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def box_iou(a: Tensor, b: Tensor) -> Tensor:
    """Pairwise IoU. a: (N, 4), b: (M, 4) xyxy. Returns (N, M)."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    w = (torch.minimum(a[:, 2:3], b[None, :, 2])
         - torch.maximum(a[:, 0:1], b[None, :, 0])).clamp(min=0)
    h = (torch.minimum(a[:, 3:4], b[None, :, 3])
         - torch.maximum(a[:, 1:2], b[None, :, 1])).clamp(min=0)
    inter = w * h
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-9)


def nms(boxes: Tensor, scores: Tensor, iou_threshold: float,
        max_out: int | None = None, block: int = 256
        ) -> tuple[Tensor, Tensor]:
    """Greedy NMS. boxes: (N, 4), scores: (N,) with suppressed or invalid
    entries at -inf. Returns (keep_idx (K,) int64, keep_valid (K,) bool),
    K = max_out or N: the survivors' indices in score order (ties in input
    order), then zeros.

    The score-sorted boxes are walked in blocks: each block's (block, N)
    IoU tile resolves the suppression inside the block by iterating
    a_j = orig_j & !any(i < j: a_i & iou_ij > thr) to its fixed point (the
    greedy solution), then masks every later box its survivors suppress.
    The walk stops after the block of the last finite score: the blocks
    past it hold no live box, so they neither survive nor suppress.
    """
    n = boxes.shape[0]
    k = max_out if max_out is not None else n
    order = torch.sort(-scores, stable=True).indices
    boxes_s = boxes[order]
    alive = torch.isfinite(scores[order])
    live = int(torch.where(alive, torch.arange(n, device=boxes.device),
                           -1).max()) + 1 if n else 0
    for s in range(0, live, block):
        e = min(s + block, n)
        tile = box_iou(boxes_s[s:e], boxes_s) > iou_threshold    # (b, N)
        idx = torch.arange(e - s, device=boxes.device)
        over = tile[:, s:e] & (idx[:, None] < idx[None, :])      # i kills j
        orig = alive[s:e]
        a = orig
        while True:
            nxt = orig & ~(over & a[:, None]).any(0)
            if torch.equal(nxt, a):
                break
            a = nxt
        sup = (tile[:, e:] & a[:, None]).any(0)
        alive = torch.cat([alive[:s], a, alive[e:] & ~sup])
    rank = torch.cumsum(alive.long(), 0) - 1
    dest = torch.where(alive & (rank < k), rank, k)
    keep_idx = torch.zeros(k + 1, dtype=torch.int64, device=boxes.device)
    keep_idx[dest] = order
    keep_valid = torch.arange(k, device=boxes.device) < alive.sum().clamp(
        max=k)
    return keep_idx[:k], keep_valid


def roi_align(features: Tensor, rois: Tensor, *, spatial_scale: float,
              output_size: tuple[int, int], sampling_ratio: int = 2
              ) -> Tensor:
    """RoIAlign with torchvision's ``aligned=False`` semantics as the JAX
    package computes them: sample points clipped into the map, bilinear,
    ``sampling_ratio`` x ``sampling_ratio`` samples averaged per bin.

    features: (C, H, W); rois: (R, 4) xyxy in image coordinates. Returns
    (R, C, oh, ow). The bilinear weights and the average fold into one
    (R, oh, H) and one (R, ow, W) matrix, so the pooling is two products.
    """
    c, h, w = features.shape
    oh, ow = output_size
    sr = sampling_ratio
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in range(4))
    bin_w = (x2 - x1).clamp(min=1.0) / ow
    bin_h = (y2 - y1).clamp(min=1.0) / oh

    def weights(start, bin_size, n_out, size):
        i = torch.arange(n_out * sr, device=rois.device)
        off = (i % sr + 0.5) / sr
        coords = (start[:, None] + (i // sr)[None, :].float()
                  * bin_size[:, None] + off[None, :] * bin_size[:, None])
        cc = coords.clamp(0.0, size - 1.0)
        lo = torch.floor(cc).long()
        hi = (lo + 1).clamp(max=size - 1)
        frac = cc - lo.float()
        wgt = torch.zeros(*cc.shape, size, dtype=cc.dtype,
                          device=rois.device)
        wgt.scatter_add_(-1, lo[..., None], (1.0 - frac)[..., None])
        wgt.scatter_add_(-1, hi[..., None], frac[..., None])
        return wgt.reshape(-1, n_out, sr, size).mean(2).to(features.dtype)

    wy = weights(y1, bin_h, oh, h)                      # (R, oh, H)
    wx = weights(x1, bin_w, ow, w)                      # (R, ow, W)
    if w >= h:
        tmp = torch.einsum("rjw,chw->rjch", wx, features)
        return torch.einsum("rih,rjch->rcij", wy, tmp)
    tmp = torch.einsum("rih,chw->ricw", wy, features)
    return torch.einsum("rjw,ricw->rcij", wx, tmp)
