"""Video object detector, MEGA flavour: ResNet-C4 + RPN + the MEGA
relation-attention RoI head (counterpart of ``vrdone_tpu/models/detector.py``).

It is the offline producer of the per-frame 1024-d RoI features that the
relation model reads, and of the detections the IoU tracker links into
proposal tracklets. ``detect_video`` runs a batched per-frame precompute
(backbone, RPN with NMS, RoIAlign -> C5 -> fc0), the sequential MEGA scan
over the frames (``models/mega.py::stream_video``) and the box predictor on
the enhanced features. On a CUDA device every MEGA attention goes through
the fused set-attention kernel; the host post-processing (per-class decode
and NMS) runs on the CPU. ``compute_dtype="bfloat16"`` (the serving
default of ``detect_torch.py``, as of ``tools/detect_and_track.py``) runs
the backbone, RoI head and MEGA scan on a bf16 copy of the detector, with
box decode, NMS and the box predictor in fp32. ``detect_video_tta`` runs
``detect_video`` on each augmented view (identity, hflip, rescaled copies
and their flips) and merges the views' candidates in one per-class NMS.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch
from torch import nn

from ..ops import boxes as box_ops
from . import rpn as rpn_lib
from ..utils.precision import cast_floating, compute_dtype as dtype_of
from .mega import MEGAHead, global_indices, stream_video
from .resnet import ResNetC4, ResNetC5Head

Tensor = torch.Tensor

# ImageNet mean in BGR order (Caffe2-lineage preprocessing)
PIXEL_MEAN = np.array([102.9801, 115.9465, 122.7717], np.float32)


# host constants kept on each device: a copy from pageable host memory
# would synchronise the stream every frame
@functools.lru_cache(maxsize=None)
def _pixel_mean(device: torch.device) -> Tensor:
    return torch.from_numpy(PIXEL_MEAN).to(device)


@functools.lru_cache(maxsize=None)
def _anchors(feat_h: int, feat_w: int, device: torch.device) -> Tensor:
    return torch.from_numpy(rpn_lib.make_anchors(feat_h, feat_w)).to(device)


class BoxHead(nn.Module):
    """RoIAlign (14x14) on C4 -> C5 -> pooled (R, 2048); the predictors read
    the MEGA-enhanced 1024-d features."""

    def __init__(self, num_classes: int, c5_blocks: int = 3,
                 stride_in_1x1: bool = False, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.c5 = ResNetC5Head(c5_blocks, stride_in_1x1=stride_in_1x1,
                               device=device, generator=generator)
        self.cls_score = nn.Linear(1024, num_classes + 1, device=device)
        self.bbox_pred = nn.Linear(1024, 4 * (num_classes + 1), device=device)
        with torch.no_grad():
            self.cls_score.weight.normal_(0.0, 0.01, generator=generator)
            self.bbox_pred.weight.normal_(0.0, 0.001, generator=generator)
            self.cls_score.bias.zero_()
            self.bbox_pred.bias.zero_()

    def pooled_features(self, c4_feat: Tensor, rois: Tensor) -> Tensor:
        """c4_feat (C, H, W) of one image, rois (R, 4) -> (R, 2048)."""
        crops = box_ops.roi_align(c4_feat, rois, spatial_scale=1.0 / 16,
                                  output_size=(14, 14), sampling_ratio=2)
        return self.c5(crops)

    def predictions(self, enhanced: Tensor) -> tuple[Tensor, Tensor]:
        """(R, 1024) MEGA output -> (cls_logits, bbox_deltas)."""
        return self.cls_score(enhanced), self.bbox_pred(enhanced)


class MegaDetector(nn.Module):
    """The video detector with the MEGA head, under the flax names
    (``backbone``, ``rpn``, ``box_head``, ``mega``). Defaults are the
    reference's: R-101-C4, stage 3, 16 groups, base_num 75 reference
    proposals a frame, advanced_num = base_num * 0.2, window 25 with the
    key at slot 12, global_size 10, one global residual stage; the
    long-range memory holds ``window`` frames."""

    def __init__(self, num_classes: int,
                 resnet_layers: tuple[int, ...] = (3, 4, 23), stage: int = 3,
                 groups: int = 16, global_res_stage: int = 1,
                 global_enable: bool = True, memory_enable: bool = True,
                 base_num: int = 75, ratio: float = 0.2, window: int = 25,
                 key_loc: int = 12, global_size: int = 10,
                 advanced_num_override: int | None = None,
                 stride_in_1x1: bool = False, *,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.stage, self.groups = stage, groups
        self.global_res_stage, self.global_enable = (global_res_stage,
                                                     global_enable)
        self.memory_enable = memory_enable
        self.base_num, self.ratio = base_num, ratio
        self.window, self.key_loc = window, key_loc
        self.global_size = global_size
        self.advanced_num_override = advanced_num_override
        kw = dict(device=device, generator=generator)
        self.backbone = ResNetC4(resnet_layers, stride_in_1x1=stride_in_1x1,
                                 **kw)
        self.rpn = rpn_lib.RPNHead(**kw)
        self.box_head = BoxHead(num_classes, stride_in_1x1=stride_in_1x1,
                                **kw)
        self.mega = make_mega_head(self, **kw)
        self.eval()

    @property
    def advanced_num(self) -> int:
        """Distilled proposals per frame."""
        if self.advanced_num_override is not None:
            return self.advanced_num_override
        return max(1, int(self.base_num * self.ratio))

    @property
    def device(self) -> torch.device:
        return self.rpn.conv.weight.device

    def features(self, images: Tensor,
                 compute_dtype: torch.dtype = torch.float32) -> Tensor:
        """images (N, H, W, 3) raw BGR pixels, uint8 or float -> C4
        features (N, 1024, H/16, W/16), NCHW. The mean is taken off here,
        in fp32, before the cast to ``compute_dtype`` (bf16 on a
        ``cast_floating`` copy of the detector)."""
        x = (images.float() - _pixel_mean(images.device)).to(compute_dtype)
        return self.backbone(x.permute(0, 3, 1, 2).contiguous())

    def propose(self, c4_feat: Tensor, image_hw, *,
                pre_nms_top_n: int = 6000, post_nms_top_n: int = 300
                ) -> tuple[Tensor, Tensor, Tensor]:
        """One image: c4_feat (C, H', W') -> (boxes, scores, valid). Box
        decode and NMS run in fp32."""
        logits, deltas = self.rpn(c4_feat[None])
        hp, wp, a = logits.shape[1], logits.shape[2], logits.shape[3]
        anchors = _anchors(hp, wp, c4_feat.device)
        return rpn_lib.select_proposals(
            anchors, logits[0].reshape(-1).float(),
            deltas[0].reshape(hp * wp * a, 4).float(), image_hw,
            pre_nms_top_n=pre_nms_top_n, post_nms_top_n=post_nms_top_n)

    def frame_fc0(self, c4_feat: Tensor, rois: Tensor, valid: Tensor
                  ) -> Tensor:
        """Pool one frame's RoIs and lift them to fc0-level 1024-d
        features (zero where invalid)."""
        x = self.mega.pre_calculate(self.box_head.pooled_features(c4_feat,
                                                                  rois))
        return x * valid[:, None].to(x.dtype)

    def enhance(self, *args, **kw):
        return self.mega.enhance(*args, **kw)

    def predictions(self, enhanced: Tensor) -> tuple[Tensor, Tensor]:
        return self.box_head.predictions(enhanced)


def make_mega_head(det: MegaDetector, fused_pe_bias: bool = False,
                   fused_attention: bool = False, *, device: torch.device,
                   generator: torch.Generator | None = None) -> MEGAHead:
    """The MEGAHead matching a detector's knobs (fc0 lifts C5's 2048-d
    pooled features to 1024)."""
    return MEGAHead(
        feat_dim=1024, groups=det.groups, stage=det.stage,
        global_res_stage=det.global_res_stage,
        global_enable=det.global_enable, memory_enable=det.memory_enable,
        advanced_num=det.advanced_num, fused_pe_bias=fused_pe_bias,
        fused_attention=fused_attention, in_dim=2048, device=device,
        generator=generator)


# ---------------------------------------------------------------------------
# Whole-video drivers
# ---------------------------------------------------------------------------

def precompute_chunk(det: MegaDetector, images: Tensor, image_hw, *,
                     key_post_nms: int,
                     compute_dtype: torch.dtype = torch.float32):
    """The per-frame precompute of a chunk of frames (N, H, W, 3): C4, key
    proposals and their fc0 features, and the reference set (the top
    ``base_num`` proposals) with its fc0 features, on ``det`` in
    ``compute_dtype`` (a bf16 copy for bf16; the fc0 features come back
    fp32). Returns the per-frame (kb, kv, ks, key_fc0, rb, rv, ref_fc0),
    each stacked over the chunk."""
    c4 = det.features(images, compute_dtype)
    outs = []
    for c4f in c4:
        kb, ks, kv = det.propose(c4f, image_hw, post_nms_top_n=key_post_nms)
        key_fc0 = det.frame_fc0(c4f, kb, kv).float()
        if key_post_nms >= det.base_num:
            # greedy NMS keeps are score-sorted and prefix-stable in
            # max_out, so the reference set is the key set's prefix
            rb, rv = kb[:det.base_num], kv[:det.base_num]
            ref_fc0 = key_fc0[:det.base_num]
        else:
            rb, _, rv = det.propose(c4f, image_hw,
                                    post_nms_top_n=det.base_num)
            ref_fc0 = det.frame_fc0(c4f, rb, rv).float()
        outs.append((kb, kv, ks, key_fc0, rb, rv, ref_fc0))
    return tuple(torch.stack(x) for x in zip(*outs))


class _PhaseClock:
    """Host-clock laps ended by a device synchronisation; does nothing
    without a dict to fill."""

    def __init__(self, device: torch.device, timings: dict | None):
        self.device, self.timings = device, timings
        self.t0 = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = now - self.t0
        self.t0 = now


def _cast(det: MegaDetector, dtype: torch.dtype) -> MegaDetector:
    """The detector the precompute and the MEGA scan run on: ``det`` for
    fp32, else a copy with every floating parameter cast once a call (as
    JAX casts its parameter tree outside the per-chunk program; FrozenBN's
    statistics are parameters, cast too)."""
    return det if dtype == torch.float32 else cast_floating(det, dtype)


@torch.no_grad()
def detect_video(det: MegaDetector, images, image_hw, *,
                 key_post_nms: int = 300, seed: int = 0, chunk: int = 4,
                 fused_pe_bias: bool = True,
                 fused_attention: bool | None = None,
                 compute_dtype: str = "float32",
                 timings: dict | None = None) -> dict:
    """Detect every frame of a video with full MEGA semantics.

    images: (T, H, W, 3) array or any indexable sequence of (H, W, 3) BGR
    frames, uint8 preferred (a quarter of the host-to-device bytes; the
    model casts on the device). Frames go to the precompute ``chunk`` at a
    time. ``fused_attention=None`` turns the fused set-attention kernel on
    when the detector lies on a CUDA device. A ``timings`` dict receives
    the seconds of the three phases (``precompute``, ``stream``,
    ``predict``), each ended by a device synchronisation.
    ``compute_dtype="bfloat16"`` runs the precompute (after the bf16 copy
    of the detector, which the precompute phase counts) and the MEGA scan
    in bf16; box decode and NMS stay fp32, and the box predictor runs on
    the fp32 detector. Returns numpy arrays stacked over frames: proposals
    (T, Nk, 4), proposal_scores, valid, cls_logits (T, Nk, K+1),
    bbox_deltas, visual (T, Nk, 1024), all fp32."""
    dt = dtype_of(compute_dtype)
    dev = det.device
    if fused_attention is None:
        fused_attention = dev.type == "cuda"
    clock = _PhaseClock(dev, timings)
    cdet = _cast(det, dt)
    t_total = len(images)
    chunk = max(1, min(chunk, t_total))
    outs = []
    for lo in range(0, t_total, chunk):
        hi = min(lo + chunk, t_total)
        imgs = np.stack([np.ascontiguousarray(images[t])
                         for t in range(lo, hi)])
        outs.append(precompute_chunk(cdet, torch.from_numpy(imgs).to(dev),
                                     image_hw, key_post_nms=key_post_nms,
                                     compute_dtype=dt))
    kb, kv, ks, kf, rb, rv, rf = (torch.cat([o[i] for o in outs])
                                  for i in range(7))
    clock.lap("precompute")
    glob_idx = None
    if det.global_enable:
        glob_idx = global_indices(t_total, min(det.global_size, t_total),
                                  seed=seed)
    visual = stream_video(
        cdet.mega.routed(fused_pe_bias, fused_attention),
        key_feat=kf, key_rois=kb, key_valid=kv, key_is_fc0=True,
        ref_feat=rf, ref_rois=rb, ref_valid=rv, mem_size=det.window,
        window=det.window, key_loc=det.key_loc, glob_idx=glob_idx,
        compute_dtype=compute_dtype)
    clock.lap("stream")
    cls_logits, bbox_deltas = det.predictions(visual.reshape(-1, 1024))
    clock.lap("predict")
    nk = kb.shape[1]
    return {"proposals": kb.cpu().numpy(),
            "proposal_scores": ks.cpu().numpy(),
            "valid": kv.cpu().numpy(),
            "cls_logits": cls_logits.reshape(t_total, nk, -1).cpu().numpy(),
            "bbox_deltas": bbox_deltas.reshape(t_total, nk, -1).cpu().numpy(),
            "visual": visual.cpu().numpy()}


@torch.no_grad()
def extract_video_features(det: MegaDetector, images, rois, valid, *,
                           seed: int = 0, batch: int = 8,
                           compute_dtype: str = "float32") -> np.ndarray:
    """GT-box feature extraction for a whole video: the given boxes serve
    as the key, window and global sets, through the dense attention route.

    images: (T, H, W, 3) array, or a callable (lo, hi) -> (hi - lo, H, W, 3)
    that loads frames lazily; rois (T, N, 4); valid (T, N).
    ``compute_dtype="bfloat16"`` runs the backbone, the RoI head and the
    MEGA scan on a bf16 copy of the detector. Returns (T, N, 1024)
    MEGA-enhanced features, fp32."""
    dt = dtype_of(compute_dtype)
    cdet = _cast(det, dt)
    dev = det.device
    t_total = rois.shape[0]
    load = images if callable(images) else (lambda lo, hi: images[lo:hi])
    rois_t = torch.as_tensor(np.asarray(rois, np.float32), device=dev)
    valid_t = torch.as_tensor(np.asarray(valid, bool), device=dev)
    feats = []
    for lo in range(0, t_total, batch):
        hi = min(lo + batch, t_total)
        c4 = cdet.features(torch.from_numpy(np.asarray(load(lo, hi)))
                           .to(dev), dt)
        feats.extend(cdet.frame_fc0(c4[i], rois_t[lo + i], valid_t[lo + i])
                     .float() for i in range(hi - lo))
    fc0 = torch.stack(feats)
    glob_idx = None
    if det.global_enable:
        glob_idx = global_indices(t_total, min(det.global_size, t_total),
                                  seed=seed)
    out = stream_video(
        cdet.mega.routed(False, False), key_feat=fc0, key_rois=rois_t,
        key_valid=valid_t, key_is_fc0=True, ref_feat=fc0, ref_rois=rois_t,
        ref_valid=valid_t, mem_size=det.window, window=det.window,
        key_loc=det.key_loc, glob_idx=glob_idx, compute_dtype=compute_dtype)
    return out.cpu().numpy()


class _ViewFrames:
    """Lazy augmented view over a frame sequence (host-side resize/flip)."""

    def __init__(self, base, scale: float = 1.0, hflip: bool = False):
        self.base = base
        self.scale = scale
        self.hflip = hflip

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        img = np.asarray(self.base[i])
        if self.scale != 1.0:
            from PIL import Image
            h, w = img.shape[:2]
            # frames are float BGR; PIL resize in uint8 RGB
            im = Image.fromarray(img.astype(np.uint8)[..., ::-1])
            im = im.resize((int(round(w * self.scale)),
                            int(round(h * self.scale))))
            img = np.asarray(im, np.float32)[..., ::-1]
        if self.hflip:
            img = np.ascontiguousarray(img[:, ::-1])
        return img


@torch.no_grad()
def detect_video_tta(det: MegaDetector, images, image_hw, *,
                     scales=(), hflip: bool = True,
                     key_post_nms: int = 300, seed: int = 0,
                     score_thresh: float = 0.05, nms_thresh: float = 0.5,
                     dets_per_img: int = 100,
                     compute_dtype: str = "float32") -> list[dict]:
    """Test-time-augmented video detection (reference
    mega_core/engine/bbox_aug.py:16-112: the model runs on each augmented
    view -- identity, hflip, and resized copies +- their flips -- and all
    candidate pools share one per-class NMS). Each view is one
    ``detect_video`` call, so on a CUDA device each runs the fused
    set-attention kernel.

    Returns one post-processed detection dict per frame.
    """
    h, w = int(image_hw[0]), int(image_hw[1])
    view_specs = [(None, _ViewFrames(images), (h, w))]
    if hflip:
        view_specs.append(("hflip", _ViewFrames(images, hflip=True),
                           (h, w)))
    for s in scales:
        sh, sw = int(round(h * s)), int(round(w * s))
        fx, fy = sw / w, sh / h
        view_specs.append((("scale", fx, fy),
                           _ViewFrames(images, scale=s), (sh, sw)))
        if hflip:
            view_specs.append((("scale_hflip", fx, fy),
                               _ViewFrames(images, scale=s, hflip=True),
                               (sh, sw)))

    outs = []
    for tfm, frames, vhw in view_specs:
        out = detect_video(det, frames, np.asarray(vhw, np.float32),
                           key_post_nms=key_post_nms, seed=seed,
                           compute_dtype=compute_dtype)
        outs.append((tfm, out))

    t_total = len(images)
    results = []
    for t in range(t_total):
        views = [(out["proposals"][t], out["cls_logits"][t],
                  out["bbox_deltas"][t], out["valid"][t], tfm)
                 for tfm, out in outs]
        results.append(postprocess_frame_tta(
            views, (h, w), score_thresh=score_thresh,
            nms_thresh=nms_thresh, dets_per_img=dets_per_img))
    return results


# ---------------------------------------------------------------------------
# Host post-processing (decode + NMS)
# ---------------------------------------------------------------------------

def _decode_candidates(boxes, cls_logits, bbox_deltas, valid, image_hw,
                       score_thresh):
    """Per-class decoded candidate pools: {class: (boxes, scores)}."""
    num_classes = cls_logits.shape[1] - 1
    probs = np.exp(cls_logits - cls_logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    h, w = image_hw
    out = {}
    for c in range(1, num_classes + 1):
        scores_c = probs[:, c]
        keep = (scores_c > score_thresh) & valid
        if not keep.any():
            continue
        deltas_c = bbox_deltas[keep, 4 * c:4 * (c + 1)]
        boxes_c = rpn_lib.decode_boxes(
            torch.from_numpy(np.ascontiguousarray(boxes[keep])),
            torch.from_numpy(np.ascontiguousarray(deltas_c)),
            weights=(10.0, 10.0, 5.0, 5.0)).numpy()
        boxes_c[:, 0::2] = boxes_c[:, 0::2].clip(0, w - 1)
        boxes_c[:, 1::2] = boxes_c[:, 1::2].clip(0, h - 1)
        out[c] = (boxes_c, scores_c[keep])
    return out


def hflip_boxes(boxes: np.ndarray, width: float) -> np.ndarray:
    """Mirror xyxy boxes around the vertical image axis."""
    out = boxes.copy()
    out[:, 0] = width - 1 - boxes[:, 2]
    out[:, 2] = width - 1 - boxes[:, 0]
    return out


def scale_boxes(boxes: np.ndarray, factor_xy) -> np.ndarray:
    """Rescale xyxy boxes by (fx, fy)."""
    fx, fy = factor_xy
    out = boxes.copy()
    out[:, 0::2] *= fx
    out[:, 1::2] *= fy
    return out


def postprocess_frame(boxes: np.ndarray, cls_logits: np.ndarray,
                      bbox_deltas: np.ndarray, valid: np.ndarray,
                      image_hw, *, score_thresh: float = 0.05,
                      nms_thresh: float = 0.5,
                      dets_per_img: int = 100) -> dict:
    """Per-class decode + NMS on the host. Returns boxes/scores/labels."""
    return postprocess_frame_tta(
        [(boxes, cls_logits, bbox_deltas, valid, None)], image_hw,
        score_thresh=score_thresh, nms_thresh=nms_thresh,
        dets_per_img=dets_per_img)


def postprocess_frame_tta(views, image_hw, *, score_thresh: float = 0.05,
                          nms_thresh: float = 0.5,
                          dets_per_img: int = 100) -> dict:
    """Decode + NMS over one or more augmented views: (boxes, cls_logits,
    bbox_deltas, valid, transform), transform None, "hflip",
    ("scale", fx, fy) or ("scale_hflip", fx, fy). Each view is decoded in
    its own frame, mapped back, and all pools share one per-class NMS."""
    h, w = image_hw
    merged: dict[int, list] = {}
    for boxes, cls_logits, bbox_deltas, valid, tfm in views:
        view_hw = (image_hw if tfm is None or tfm == "hflip"
                   else (h * tfm[2], w * tfm[1]))
        cands = _decode_candidates(boxes, cls_logits, bbox_deltas, valid,
                                   view_hw, score_thresh)
        for c, (bx, sc) in cands.items():
            if tfm == "hflip":
                bx = hflip_boxes(bx, w)
            elif isinstance(tfm, tuple):
                kind, fx, fy = tfm
                if kind == "scale_hflip":
                    bx = hflip_boxes(bx, w * fx)
                bx = scale_boxes(bx, (1.0 / fx, 1.0 / fy))
                bx[:, 0::2] = bx[:, 0::2].clip(0, w - 1)
                bx[:, 1::2] = bx[:, 1::2].clip(0, h - 1)
            merged.setdefault(c, []).append((bx, sc))

    out_boxes, out_scores, out_labels = [], [], []
    for c, pools in merged.items():
        boxes_c = np.concatenate([b for b, _ in pools])
        scores_c = np.concatenate([s for _, s in pools])
        keep_idx, keep_valid = box_ops.nms(torch.from_numpy(boxes_c),
                                           torch.from_numpy(scores_c),
                                           nms_thresh)
        ki = keep_idx.numpy()[keep_valid.numpy()]
        out_boxes.append(boxes_c[ki])
        out_scores.append(scores_c[ki])
        out_labels.append(np.full(len(ki), c, np.int64))
    if not out_boxes:
        return {"boxes": np.zeros((0, 4), np.float32),
                "scores": np.zeros((0,), np.float32),
                "labels": np.zeros((0,), np.int64)}
    boxes = np.concatenate(out_boxes)
    scores = np.concatenate(out_scores)
    labels = np.concatenate(out_labels)
    order = np.argsort(-scores)[:dets_per_img]
    return {"boxes": boxes[order], "scores": scores[order],
            "labels": labels[order]}
