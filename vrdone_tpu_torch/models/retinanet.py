"""RetinaNet single-stage detector (counterpart of
``vrdone_tpu/models/retinanet.py``): ResNet C3-C5 -> FPN P3-P7 -> shared
conv towers -> per-anchor sigmoid classification + box regression, trained
with sigmoid focal loss and smooth-L1.

The modules carry the flax names (``body/layer4``, ``fpn/fpn_inner3``,
``head/cls_tower0``, ...), so ``convert.py`` crosses the JAX parameters one
to one. Activations run NCHW inside; at the boundaries the JAX layouts hold:
images (N, H, W, 3) BGR 0-255, per-level outputs (N, H, W, A*D), anchor-major
per cell as ``level_anchors`` orders them. The anchor functions are
word-for-word copies of the JAX package's (numpy only), pinned by
``tests/test_torch_copies.py``.

A bf16 forward computes with JAX's promotions: on a ``cast_floating`` copy
the network runs bf16 throughout; on fp32 parameters only the input is
rounded to bf16 (flax's convolution promotes it with the fp32 kernel).
``detect_image`` decodes and runs the class-wise NMS in fp32 either way.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..utils.precision import compute_dtype as dtype_of
from . import rpn as rpn_lib
from .detector import _pixel_mean
from .detector_train import match_boxes, smooth_l1
from .resnet import ResNetC4, ResStage

Tensor = torch.Tensor

# reference defaults.py:295-350
ANCHOR_SIZES = (32, 64, 128, 256, 512)
ANCHOR_STRIDES = (8, 16, 32, 64, 128)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
OCTAVE = 2.0
SCALES_PER_OCTAVE = 3
BOX_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def generate_cell_anchors(stride: int, sizes: Sequence[float],
                          ratios: Sequence[float] = ASPECT_RATIOS
                          ) -> np.ndarray:
    """Reference generate_anchors (anchor_generator.py:220-290): windows
    around (0,0,stride-1,stride-1) with the historic rounding."""
    scales = np.asarray(sizes, np.float32) / stride
    ratios = np.asarray(ratios, np.float32)
    base = np.asarray([0, 0, stride - 1, stride - 1], np.float32)

    def whctrs(a):
        w = a[2] - a[0] + 1
        h = a[3] - a[1] + 1
        return w, h, a[0] + 0.5 * (w - 1), a[1] + 0.5 * (h - 1)

    def mk(ws, hs, xc, yc):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack([xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                          xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)])

    w, h, xc, yc = whctrs(base)
    ws = np.round(np.sqrt(w * h / ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = mk(ws, hs, xc, yc)
    out = []
    for i in range(ratio_anchors.shape[0]):
        w, h, xc, yc = whctrs(ratio_anchors[i])
        out.append(mk(w * scales, h * scales, xc, yc))
    return np.vstack(out).astype(np.float32)


def octave_sizes(base_sizes=ANCHOR_SIZES, octave: float = OCTAVE,
                 scales_per_octave: int = SCALES_PER_OCTAVE):
    """Per-level anchor-size tuples (make_anchor_generator_retinanet,
    anchor_generator.py:146-166)."""
    return [tuple(size * octave ** (i / scales_per_octave)
                  for i in range(scales_per_octave))
            for size in base_sizes]


def level_anchors(feat_h: int, feat_w: int, stride: int,
                  cell: np.ndarray) -> np.ndarray:
    """(H*W*A, 4) anchors; shifts at multiples of the stride (reference
    grid_anchors, anchor_generator.py:73-95 — no half-cell offset)."""
    xs = np.arange(feat_w, dtype=np.float32) * stride
    ys = np.arange(feat_h, dtype=np.float32) * stride
    cx, cy = np.meshgrid(xs, ys)
    shifts = np.stack([cx, cy, cx, cy], axis=-1).reshape(-1, 1, 4)
    return (shifts + cell[None]).reshape(-1, 4).astype(np.float32)


def all_anchors(image_hw: tuple[int, int],
                strides=ANCHOR_STRIDES) -> np.ndarray:
    """(sum H*W*A, 4) anchors for a padded canvas (host-side constant)."""
    hh, ww = image_hw
    cells = [generate_cell_anchors(s, sz)
             for s, sz in zip(strides, octave_sizes())]
    levels = []
    for stride, cell in zip(strides, cells):
        fh = -(-hh // stride)
        fw = -(-ww // stride)
        levels.append(level_anchors(fh, fw, stride, cell))
    return np.concatenate(levels, axis=0)


# host constants kept on each device, as models/detector.py keeps its own
@functools.lru_cache(maxsize=None)
def _anchors(hh: int, ww: int, device: torch.device) -> Tensor:
    return torch.from_numpy(all_anchors((hh, ww))).to(device)


def conv(layer: nn.Conv2d, x: Tensor) -> Tensor:
    """A flax ``nn.Conv``: input, kernel and bias in their common dtype
    (JAX's promotion), then ``layer``'s convolution."""
    dt = torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.conv2d(x.to(dt), layer.weight.to(dt), bias, layer.stride,
                    layer.padding, layer.dilation)


def _conv2d(in_ch: int, out: int, k: int, stride: int, device, generator,
            std: float | None = None) -> nn.Conv2d:
    """A k x k conv with padding k // 2 and a zero bias; kernel drawn
    N(0, std) (flax ``normal(std)``) or, without ``std``, uniform with
    variance 1 / fan_in (``variance_scaling(1, "fan_in", "uniform")``, the
    reference's kaiming_uniform(a=1))."""
    layer = nn.Conv2d(in_ch, out, k, stride=stride, padding=k // 2,
                      device=device)
    with torch.no_grad():
        if std is None:
            bound = math.sqrt(3.0 / (in_ch * k * k))
            nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
        else:
            nn.init.normal_(layer.weight, 0.0, std, generator=generator)
        layer.bias.zero_()
    return layer


class ResNetBody(ResNetC4):
    """Stem + C2..C5 returning the (C3, C4, C5) pyramid (strides 8/16/32),
    NCHW. layers=(3, 4, 23, 3) is ResNet-101."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3),
                 stride_in_1x1: bool = False, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__(layers[:3], stride_in_1x1, device=device,
                         generator=generator)
        self.layer4 = ResStage(1024, 512, layers[3], stride=2,
                               stride_in_1x1=stride_in_1x1, device=device,
                               generator=generator)

    def forward(self, x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        h = F.relu(self.stem_bn(self.stem(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        c3 = self.layer2(self.layer1(h))
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


def _up2(x: Tensor, like: Tensor) -> Tensor:
    """Nearest 2x upsampling cropped to ``like``'s size (JAX's
    ``jnp.repeat`` on both axes, then the crop)."""
    up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return up[:, :, :like.shape[2], :like.shape[3]]


class FPNP3P7(nn.Module):
    """FPN over (C3, C4, C5) plus P6/P7 extra levels; P6 reads C5 when
    ``use_c5``, P7 reads relu(P6)."""

    def __init__(self, out_channels: int = 256, use_c5: bool = True,
                 in_channels: Sequence[int] = (512, 1024, 2048), *,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        c = out_channels
        kw = dict(device=device, generator=generator)
        for i, ch in enumerate(in_channels):
            self.add_module(f"fpn_inner{i + 1}", _conv2d(ch, c, 1, 1, **kw))
            self.add_module(f"fpn_layer{i + 1}", _conv2d(c, c, 3, 1, **kw))
        self.p6 = _conv2d(in_channels[2] if use_c5 else c, c, 3, 2, **kw)
        self.p7 = _conv2d(c, c, 3, 2, **kw)
        self.use_c5 = use_c5

    def forward(self, c3: Tensor, c4: Tensor, c5: Tensor) -> list[Tensor]:
        inner5 = conv(self.fpn_inner3, c5)
        inner4 = conv(self.fpn_inner2, c4)
        inner3 = conv(self.fpn_inner1, c3)
        p5 = conv(self.fpn_layer3, inner5)
        last4 = inner4 + _up2(inner5, inner4)
        p4 = conv(self.fpn_layer2, last4)
        p3 = conv(self.fpn_layer1, inner3 + _up2(last4, inner3))
        p6 = conv(self.p6, c5 if self.use_c5 else p5)
        p7 = conv(self.p7, F.relu(p6))
        return [p3, p4, p5, p6, p7]


class RetinaNetHead(nn.Module):
    """Shared cls/bbox conv towers over every level: NCHW features ->
    per-level logits (N, H, W, A*K) and deltas (N, H, W, A*4)."""

    def __init__(self, num_classes: int, channels: int = 256,
                 num_convs: int = 4,
                 num_anchors: int = len(ASPECT_RATIOS) * SCALES_PER_OCTAVE,
                 prior_prob: float = 0.01, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, generator=generator, std=0.01)
        self.num_convs = num_convs
        for tower in ("cls_tower", "bbox_tower"):
            for i in range(num_convs):
                self.add_module(f"{tower}{i}",
                                _conv2d(channels, channels, 3, 1, **kw))
        self.cls_logits = _conv2d(channels, num_anchors * num_classes, 3, 1,
                                  **kw)
        self.bbox_pred = _conv2d(channels, num_anchors * 4, 3, 1, **kw)
        with torch.no_grad():
            self.cls_logits.bias.fill_(
                -math.log((1 - prior_prob) / prior_prob))

    def tower(self, name: str, f: Tensor) -> Tensor:
        for i in range(self.num_convs):
            f = F.relu(conv(getattr(self, f"{name}{i}"), f))
        return f

    def forward(self, feats: list[Tensor]) -> tuple[list[Tensor],
                                                    list[Tensor]]:
        logits = [conv(self.cls_logits, self.tower("cls_tower", f))
                  .permute(0, 2, 3, 1) for f in feats]
        bbox = [conv(self.bbox_pred, self.tower("bbox_tower", f))
                .permute(0, 2, 3, 1) for f in feats]
        return logits, bbox


class RetinaNet(nn.Module):
    """backbone -> FPN P3-P7 -> RetinaNetHead, under the flax names
    ``body``, ``fpn``, ``head``. Starts in eval mode (frozen norms; nothing
    draws)."""

    def __init__(self, num_classes: int,
                 resnet_layers: Sequence[int] = (3, 4, 23, 3),
                 out_channels: int = 256, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.body = ResNetBody(resnet_layers, **kw)
        self.fpn = FPNP3P7(out_channels, **kw)
        self.head = RetinaNetHead(num_classes, out_channels, **kw)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.head.cls_logits.weight.device

    @property
    def param_dtype(self) -> torch.dtype:
        return self.head.cls_logits.weight.dtype

    def forward(self, images: Tensor,
                compute_dtype: torch.dtype = torch.float32
                ) -> tuple[list[Tensor], list[Tensor]]:
        """images (N, H, W, 3) BGR 0-255 (uint8 fine; cast on the device).
        The mean comes off in fp32, the result is cast to ``compute_dtype``
        and, as flax promotes it, to the parameters' dtype where that is
        wider. Returns per-level (logits, bbox_deltas) lists, NHWC."""
        x = (images.float() - _pixel_mean(images.device)).to(compute_dtype)
        x = x.to(torch.promote_types(x.dtype, self.param_dtype))
        feats = self.fpn(*self.body(x.permute(0, 3, 1, 2).contiguous()))
        return self.head(feats)


def flatten_levels(level_outputs: list[Tensor], last_dim: int) -> Tensor:
    """[(N, H, W, A*D)...] -> (N, sum(H*W*A), D), anchor-major per cell
    (matches level_anchors ordering)."""
    return torch.cat([x.reshape(x.shape[0], -1, last_dim)
                      for x in level_outputs], dim=1)


def optax_sigmoid_ce(logits: Tensor, labels: Tensor) -> Tensor:
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits: Tensor, targets_onehot: Tensor,
                       valid: Tensor, *, alpha: float = 0.25,
                       gamma: float = 2.0) -> Tensor:
    """Reference SigmoidFocalLoss semantics (sum over anchors x classes;
    ignored anchors excluded)."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets_onehot)
    p_t = p * targets_onehot + (1 - p) * (1 - targets_onehot)
    a_t = alpha * targets_onehot + (1 - alpha) * (1 - targets_onehot)
    loss = a_t * (1 - p_t) ** gamma * ce
    return (loss * valid[..., None]).sum()


def retinanet_losses(anchors: Tensor, cls_logits: Tensor,
                     bbox_deltas: Tensor, gt_boxes: Tensor,
                     gt_labels: Tensor, gt_valid: Tensor, *,
                     num_classes: int, reg_beta: float = 0.11,
                     reg_norm: float = 4.0) -> dict:
    """Batch loss (reference retinanet/loss.py:43-82): matching at 0.5 /
    0.4 with each GT's best anchor forced positive, cls / (num_pos + N
    images), reg / max(1, num_pos * 4).

    anchors (A, 4); cls_logits (N, A, K); bbox_deltas (N, A, 4); gt_*
    padded per image with gt_valid masks; labels 1..K."""
    n = cls_logits.shape[0]
    labels, tgt_cls, reg_t = [], [], []
    for gtb, gtl, gtv in zip(gt_boxes, gt_labels.long(), gt_valid):
        m = match_boxes(anchors, gtb, gtv, high=0.5, low=0.4,
                        force_match=True)
        labels.append(m.labels)
        tgt_cls.append(torch.where(m.labels == 1, gtl[m.matched_idx], 0))
        reg_t.append(rpn_lib.encode_boxes(gtb[m.matched_idx], anchors,
                                          weights=BOX_WEIGHTS))
    labels, tgt_cls, reg_t = (torch.stack(x) for x in (labels, tgt_cls,
                                                       reg_t))
    pos = labels == 1
    n_pos = pos.sum()
    # jax.nn.one_hot: an index off 0..K-1 gives a row of zeros
    onehot = (((tgt_cls - 1)[..., None]
               == torch.arange(num_classes, device=labels.device))
              & pos[..., None]).float()
    cls_loss = sigmoid_focal_loss(cls_logits, onehot, (labels >= 0).float())
    cls_loss = cls_loss / (n_pos + n)
    reg = smooth_l1(bbox_deltas - reg_t, beta=reg_beta).sum(-1)
    reg_loss = (reg * pos).sum() / (n_pos * reg_norm).clamp(min=1.0)
    return {"loss_retina_cls": cls_loss, "loss_retina_reg": reg_loss,
            "num_pos": n_pos}


@torch.no_grad()
def detect_image(model: RetinaNet, image, image_hw, *,
                 pre_nms_top_n: int = 1000, score_thresh: float = 0.05,
                 nms_thresh: float = 0.4, dets_per_img: int = 100,
                 compute_dtype: str = "float32") -> dict:
    """Single-image inference (reference retinanet/inference.py): per-level
    top ``pre_nms_top_n`` candidates by best-class score, decode, clip,
    class-wise NMS, the top ``dets_per_img``. image (H, W, 3), an array or a
    tensor (moved to the model's device). ``compute_dtype="bfloat16"`` runs
    the network in bf16 on ``model``'s parameters as they are (pass a
    ``cast_floating`` copy for bf16 throughout; fp32 parameters promote, as
    in JAX); decode and NMS run fp32. Returns tensors on the model's device:
    boxes (D, 4), scores (D,), labels (D,) 1..K, valid (D,)."""
    image = torch.as_tensor(image, device=model.device)
    logits_l, bbox_l = model(image[None], dtype_of(compute_dtype))
    k = model.num_classes
    hh, ww = int(image.shape[0]), int(image.shape[1])
    anchors = _anchors(hh, ww, image.device)
    logits = flatten_levels([x.float() for x in logits_l], k)[0]   # (A, K)
    deltas = flatten_levels([x.float() for x in bbox_l], 4)[0]     # (A, 4)

    # per-level top pre_nms_top_n candidate anchors by best-class score; a
    # stable descending sort keeps the lower index first among ties, as
    # lax.top_k does
    scores = torch.sigmoid(logits)
    best = scores.amax(-1)
    off = 0
    keep_idx = []
    for stride in ANCHOR_STRIDES:
        na = (-(-hh // stride)) * (-(-ww // stride)) * \
            len(ASPECT_RATIOS) * SCALES_PER_OCTAVE
        kl = min(pre_nms_top_n, na)
        idx = torch.sort(best[off:off + na], descending=True,
                         stable=True).indices[:kl]
        keep_idx.append(idx + off)
        off += na
    cand = torch.cat(keep_idx)
    cand_scores = scores[cand]                                     # (C, K)
    boxes = rpn_lib.decode_boxes(anchors[cand], deltas[cand],
                                 weights=BOX_WEIGHTS)
    h, w = float(image_hw[0]), float(image_hw[1])
    boxes = torch.stack([
        boxes[:, 0].clamp(0, w - 1), boxes[:, 1].clamp(0, h - 1),
        boxes[:, 2].clamp(0, w - 1), boxes[:, 3].clamp(0, h - 1)], dim=1)

    # class-wise NMS via per-class coordinate offsets, one fused pass
    c = boxes.shape[0]
    cls_scores = torch.where(cand_scores > score_thresh, cand_scores,
                             -math.inf).T.reshape(-1)              # (K*C,)
    offs = (torch.arange(k, dtype=boxes.dtype, device=boxes.device)
            * (max(hh, ww) + 2.0))[:, None, None]
    boxes_off = (boxes[None] + offs).reshape(-1, 4)
    keep, valid = box_ops.nms(boxes_off, cls_scores, nms_thresh,
                              max_out=dets_per_img)
    return {"boxes": boxes[keep % c],
            "scores": torch.where(valid, cls_scores[keep], 0.0),
            "labels": torch.where(valid, keep // c + 1, 0), "valid": valid}
