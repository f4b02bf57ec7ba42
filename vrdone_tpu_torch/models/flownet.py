"""FlowNetS, EmbedNet and the FGFA and DFF video detectors (counterpart of
``vrdone_tpu/models/flownet.py``).

FGFA (flow-guided feature aggregation): reference-frame C4 features are
warped onto the key frame along FlowNetS flow, embedded, and summed with
per-pixel cosine-similarity softmax weights. DFF (deep feature flow): only
key frames run the backbone; the other frames take the key frame's features
warped by flow and scaled by the flow net's scale map. Both detect with the
plain Faster R-CNN head (RPN, RoIAlign, C5, two FC layers) on the
aggregated or propagated map.

The modules carry the flax names, so ``convert.py`` maps the JAX parameters
one to one (a ``nn.ConvTranspose(transpose_kernel=True)`` kernel (kh, kw,
out, in) crosses by the conv rule to ``ConvTranspose2d``'s (in, out, kh,
kw), with no flip). Feature maps and flows are NCHW, as in the rest of the
port's detector; images are (N, H, W, 3) raw BGR pixels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import boxes as box_ops
from ..ops.warp import warp_features
from ..utils.precision import compute_dtype as dtype_of
from . import rpn as rpn_lib
from .detector import MegaDetector, _cast, frames_on, stack_outputs
from .mega import _dense, window_indices
from .resnet import ResNetC4, ResNetC5Head, init_truncated

Tensor = torch.Tensor


def _lrelu(x: Tensor) -> Tensor:
    return F.leaky_relu(x, 0.1)


def avg_pool_ceil(x: Tensor, k: int = 2) -> Tensor:
    """``AvgPool2d(k, stride=k, ceil_mode=True)``: partial windows at the
    bottom and right edges average over the elements present."""
    return F.avg_pool2d(x, k, k, ceil_mode=True, count_include_pad=False)


def crop_like(x: Tensor, target: Tensor) -> Tensor:
    """The reference's crop_like: rows and columns [1, size + 1)."""
    th, tw = target.shape[2:]
    if x.shape[2:] == target.shape[2:]:
        return x
    return x[:, :, 1:th + 1, 1:tw + 1]


def _conv(in_ch: int, out: int, k: int, s: int, device, generator,
          bias: bool = True) -> nn.Conv2d:
    """A flax ``nn.Conv`` with padding k // 2: lecun-normal kernel, bias
    0."""
    conv = nn.Conv2d(in_ch, out, k, stride=s, padding=k // 2, bias=bias,
                     device=device)
    with torch.no_grad():
        init_truncated(conv.weight, in_ch * k * k, 1.0, generator)
        if bias:
            conv.bias.zero_()
    return conv


def _deconv(in_ch: int, out: int, device, generator) -> nn.ConvTranspose2d:
    """``nn.ConvTranspose(out, (4, 4), strides=(2, 2), "VALID",
    transpose_kernel=True)``: out = (in - 1) * 2 + 4; lecun-normal over
    flax's fan in (4 * 4 * out), bias 0."""
    conv = nn.ConvTranspose2d(in_ch, out, 4, stride=2, padding=0,
                              device=device)
    with torch.no_grad():
        init_truncated(conv.weight, 16 * out, 1.0, generator)
        conv.bias.zero_()
    return conv


class FlowNetS(nn.Module):
    """The reference FlowNetS: (N, 6, H, W) image pairs scaled to [0, 1] ->
    flow (N, 2, H/16, W/16) times 2.5, and with ``dff_scale`` the scale map
    (N, 1024, H/16, W/16) + 1 from a zero-initialised 1x1 convolution."""

    _CONVS = (("flow_conv1", 6, 64, 7, 2), ("conv2", 64, 128, 5, 2),
              ("conv3", 128, 256, 5, 2), ("conv3_1", 256, 256, 3, 1),
              ("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
              ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
              ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1),
              ("Convolution1", 1024, 2, 3, 1), ("Convolution2", 1026, 2, 3, 1),
              ("Convolution3", 770, 2, 3, 1), ("Convolution4", 386, 2, 3, 1),
              ("Convolution5", 194, 2, 3, 1))
    _DECONVS = (("deconv5", 1024, 512), ("deconv4", 1026, 256),
                ("deconv3", 770, 128), ("deconv2", 386, 64),
                ("upsample_flow6to5", 2, 2), ("upsample_flow5to4", 2, 2),
                ("upsample_flow4to3", 2, 2), ("upsample_flow3to2", 2, 2))

    def __init__(self, dff_scale: bool = False, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dff_scale = dff_scale
        for name, cin, cout, k, s in self._CONVS:
            setattr(self, name, _conv(cin, cout, k, s, device, generator))
        if dff_scale:
            self.Convolution5_scale = nn.Conv2d(194, 1024, 1, bias=False,
                                                device=device)
            with torch.no_grad():
                self.Convolution5_scale.weight.zero_()
        for name, cin, cout in self._DECONVS:
            setattr(self, name, _deconv(cin, cout, device, generator))

    def forward(self, x: Tensor):
        x = avg_pool_ceil(x)
        relu2 = _lrelu(self.conv2(_lrelu(self.flow_conv1(x))))
        relu4 = _lrelu(self.conv3_1(_lrelu(self.conv3(relu2))))
        relu6 = _lrelu(self.conv4_1(_lrelu(self.conv4(relu4))))
        relu8 = _lrelu(self.conv5_1(_lrelu(self.conv5(relu6))))
        relu10 = _lrelu(self.conv6_1(_lrelu(self.conv6(relu8))))

        def refine(conv, upsample, deconv, coarse, fine):
            flow = conv(coarse)
            up = crop_like(upsample(flow), fine)
            d = _lrelu(crop_like(deconv(coarse), fine))
            return torch.cat([fine, d, up], dim=1)

        concat2 = refine(self.Convolution1, self.upsample_flow6to5,
                         self.deconv5, relu10, relu8)
        concat3 = refine(self.Convolution2, self.upsample_flow5to4,
                         self.deconv4, concat2, relu6)
        concat4 = refine(self.Convolution3, self.upsample_flow4to3,
                         self.deconv3, concat3, relu4)
        concat5 = refine(self.Convolution4, self.upsample_flow3to2,
                         self.deconv2, concat4, relu2)
        concat5 = avg_pool_ceil(concat5)
        flow = self.Convolution5(concat5) * 2.5
        if self.dff_scale:
            return flow, self.Convolution5_scale(concat5) + 1.0
        return flow


class EmbedNet(nn.Module):
    """1x1 -> 3x3 -> 1x1 (1024 -> 512 -> 512 -> 2048), kernels uniform
    +-sqrt(3 / fan_in), biases 0."""

    def __init__(self, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        for name, cin, cout, k in (("embed_conv1", 1024, 512, 1),
                                   ("embed_conv2", 512, 512, 3),
                                   ("embed_conv3", 512, 2048, 1)):
            conv = nn.Conv2d(cin, cout, k, padding=k // 2, device=device)
            with torch.no_grad():
                bound = math.sqrt(3.0 / (cin * k * k))
                conv.weight.uniform_(-bound, bound, generator=generator)
                conv.bias.zero_()
            setattr(self, name, conv)

    def forward(self, x: Tensor) -> Tensor:
        x = F.relu(self.embed_conv1(x))
        x = F.relu(self.embed_conv2(x))
        return self.embed_conv3(x)


def cosine_weights(embed_refs: Tensor, embed_cur: Tensor) -> Tensor:
    """Per-pixel cosine similarity, softmax over the reference axis:
    embed_refs (R, C, H, W), embed_cur (1, C, H, W) -> (R, 1, H, W). The
    cosine and the softmax run in fp32 at least; the weights come back in
    the embeddings' dtype."""
    dt = embed_refs.dtype
    acc = torch.promote_types(dt, torch.float32)
    refs, cur = embed_refs.to(acc), embed_cur.to(acc)

    def unit(e):
        return e / (torch.linalg.vector_norm(e, dim=1, keepdim=True) + 1e-10)

    w = (unit(refs) * unit(cur)).sum(dim=1, keepdim=True)
    return torch.softmax(w, dim=0).to(dt)


def _pairs(img_cur: Tensor, imgs: Tensor, dtype: torch.dtype) -> Tensor:
    """(1, H, W, 3) and (R, H, W, 3) raw pixels -> the (R, 6, H, W) pairs
    [cur, img] / 255 in ``dtype``."""
    r = imgs.shape[0]
    pair = torch.cat([img_cur.expand(r, -1, -1, -1) / 255.0, imgs / 255.0],
                     dim=-1)
    return pair.to(dtype).permute(0, 3, 1, 2)


class FGFA(nn.Module):
    """Flow-guided aggregation: the flow net, the embedding net and the
    cosine softmax."""

    def __init__(self, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.flownet = FlowNetS(device=device, generator=generator)
        self.embednet = EmbedNet(device=device, generator=generator)

    def aggregate_train(self, img_cur: Tensor, imgs_ref: Tensor,
                        feats_cur: Tensor, feats_refs: Tensor) -> Tensor:
        """Training: flow from the key frame to each reference frame, the
        reference features warped, [key; warped] embedded, the cosine
        softmax over the references, and the weighted sum of the warped
        references only (the key frame takes part through its copy among
        them when sampled). Returns (1, C, h, w)."""
        flow = self.flownet(_pairs(img_cur, imgs_ref, feats_cur.dtype))
        warped = warp_features(feats_refs, flow)
        embeds = self.embednet(torch.cat([feats_cur, warped]))
        w = cosine_weights(embeds[1:], embeds[:1])
        return (w * warped).sum(dim=0, keepdim=True)

    def precompute_frame(self, feats: Tensor) -> Tensor:
        """Per-frame cat([feats, embednet(feats)]) for the streaming
        path."""
        return torch.cat([feats, self.embednet(feats)], dim=1)

    def aggregate_test(self, img_cur: Tensor, imgs_win: Tensor,
                       featembeds_win: Tensor, key_loc: int) -> Tensor:
        """Test: flow from the key image to every window frame, features and
        embeddings warped together, cosine weights against the key row
        ``key_loc``, the weighted sum of the features. Returns (1, 1024, h,
        w)."""
        flow = self.flownet(_pairs(img_cur, imgs_win, featembeds_win.dtype))
        warped = warp_features(featembeds_win, flow)
        feats, embeds = warped[:, :1024], warped[:, 1024:]
        w = cosine_weights(embeds, embeds[key_loc:key_loc + 1])
        return (w * feats).sum(dim=0, keepdim=True)


class DFF(nn.Module):
    """Deep feature flow: a frame's features are the key frame's warped by
    flow and multiplied by the flow net's scale map."""

    def __init__(self, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.flownet = FlowNetS(dff_scale=True, device=device,
                                generator=generator)

    def propagate(self, img_cur: Tensor, img_key: Tensor,
                  feats_key: Tensor) -> Tensor:
        """feats(cur) = scale * warp(feats(key), flow(cur -> key))."""
        flow, scale = self.flownet(_pairs(img_cur, img_key, feats_key.dtype))
        return warp_features(feats_key, flow) * scale.to(feats_key.dtype)


# Copy of vrdone_tpu/models/flownet.py::fgfa_stream_indices over the port's
# window_indices; tests pin it.
def fgfa_stream_indices(t: int, seg_len, *, window: int = 19,
                        key_loc: int = 9, device=None) -> Tensor:
    """FGFA's 19-frame window (FGFA.ALL_FRAME_INTERVAL /
    KEY_FRAME_LOCATION): the prefill and clamp of MEGA's deque."""
    return window_indices(t, seg_len, window=window, key_loc=key_loc,
                          device=device)


class TwoFCHead(nn.Module):
    """The plain Faster R-CNN head: pooled C5 features (R, 2048) -> fc6 ->
    fc7 -> (cls_logits (R, K+1), bbox_deltas (R, 4(K+1))); fc6 and fc7
    uniform +-sqrt(3 / fan_in), cls_score normal(0.01), bbox_pred
    normal(0.001), biases 0."""

    def __init__(self, num_classes: int, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.fc6 = _dense(2048, 1024, "fc", **kw)
        self.fc7 = _dense(1024, 1024, "fc", **kw)
        self.cls_score = nn.Linear(1024, num_classes + 1, device=device)
        self.bbox_pred = nn.Linear(1024, 4 * (num_classes + 1), device=device)
        with torch.no_grad():
            self.cls_score.weight.normal_(0.0, 0.01, generator=generator)
            self.bbox_pred.weight.normal_(0.0, 0.001, generator=generator)
            self.cls_score.bias.zero_()
            self.bbox_pred.bias.zero_()

    def forward(self, pooled: Tensor) -> tuple[Tensor, Tensor]:
        x = F.relu(self.fc7(F.relu(self.fc6(pooled))))
        return self.cls_score(x), self.bbox_pred(x)


class TwoFCDetector(nn.Module):
    """What the base, FGFA and DFF detectors share: the ResNet-C4 backbone,
    the RPN, C5 on RoIAlign crops and the two-FC head (flax names
    ``backbone``, ``rpn``, ``c5``, ``head``), and detection on one feature
    map."""

    features = MegaDetector.features
    propose = MegaDetector.propose
    device = MegaDetector.device

    def __init__(self, num_classes: int, resnet_layers=(3, 4, 23),
                 stride_in_1x1: bool = False, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        kw = dict(device=device, generator=generator)
        self.backbone = ResNetC4(resnet_layers, stride_in_1x1=stride_in_1x1,
                                 **kw)
        self.rpn = rpn_lib.RPNHead(**kw)
        self.c5 = ResNetC5Head(3, stride_in_1x1=stride_in_1x1, **kw)
        self.head = TwoFCHead(num_classes, **kw)

    def pooled(self, feat_map: Tensor, boxes: Tensor) -> Tensor:
        """RoIAlign (14 x 14) on a (C, h, w) map -> C5 -> (R, 2048)."""
        crops = box_ops.roi_align(feat_map, boxes, spatial_scale=1.0 / 16,
                                  output_size=(14, 14), sampling_ratio=2)
        return self.c5(crops)

    def detect_on(self, feat_map: Tensor, image_hw, *,
                  post_nms_top_n: int = 300) -> dict:
        """The RPN and the head on a (1, C, h, w) map. Box decode and NMS
        run in fp32, and the logits and deltas come back in fp32 whatever
        the compute dtype."""
        boxes, scores, valid = self.propose(feat_map[0], image_hw,
                                            post_nms_top_n=post_nms_top_n)
        cls_logits, bbox_deltas = self.head(self.pooled(feat_map[0], boxes))
        return {"proposals": boxes, "proposal_scores": scores,
                "valid": valid, "cls_logits": cls_logits.float(),
                "bbox_deltas": bbox_deltas.float()}


class FGFADetector(TwoFCDetector):
    """The FGFA video detector (``backbone``, ``fgfa``, ``rpn``, ``c5``,
    ``head``): the RPN and the head on the flow-guided aggregate of a
    ``window``-frame window with the key at ``key_loc``."""

    def __init__(self, num_classes: int, resnet_layers=(3, 4, 23),
                 window: int = 19, key_loc: int = 9, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__(num_classes, resnet_layers, device=device,
                         generator=generator)
        self.window, self.key_loc = window, key_loc
        self.fgfa = FGFA(device=device, generator=generator)
        self.eval()

    def detect_frame(self, img_cur: Tensor, imgs_ref: Tensor, image_hw, *,
                     post_nms_top_n: int = 300) -> dict:
        """One key frame (1, H, W, 3) with its reference frames (R, H, W,
        3), aggregated as in training."""
        feats = self.features(torch.cat([img_cur, imgs_ref]))
        agg = self.fgfa.aggregate_train(img_cur, imgs_ref, feats[:1],
                                        feats[1:])
        return self.detect_on(agg, image_hw, post_nms_top_n=post_nms_top_n)


class DFFDetector(TwoFCDetector):
    """The DFF video detector (``backbone``, ``dff``, ``rpn``, ``c5``,
    ``head``): key frames run the backbone, the others propagate the key
    frame's features by flow and the scale map."""

    def __init__(self, num_classes: int, resnet_layers=(3, 4, 23), *,
                 device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__(num_classes, resnet_layers, device=device,
                         generator=generator)
        self.dff = DFF(device=device, generator=generator)
        self.eval()

    def detect_frame(self, img_cur: Tensor, img_key: Tensor,
                     feats_key: Tensor, image_hw, *,
                     post_nms_top_n: int = 300) -> dict:
        agg = self.dff.propagate(img_cur, img_key, feats_key)
        return self.detect_on(agg, image_hw, post_nms_top_n=post_nms_top_n)


@torch.no_grad()
def fgfa_detect_video(det: FGFADetector, images, image_hw, *,
                      post_nms_top_n: int = 300,
                      compute_dtype: str = "float32") -> dict:
    """Whole-video FGFA detection: every frame's C4 features and
    embeddings first (the (T, 3072, h, w) buffer), then for each key frame
    its window's features and embeddings warped along FlowNetS flow and
    detected on the cosine-weighted aggregate. ``compute_dtype="bfloat16"``
    runs the backbone, the embedding and flow nets and the aggregation on a
    bf16 copy of the detector; box decode, NMS and the cosine softmax stay
    fp32. Returns numpy arrays stacked over frames: proposals (T, P, 4),
    proposal_scores, valid, cls_logits (T, P, K+1), bbox_deltas."""
    dt = dtype_of(compute_dtype)
    cdet = _cast(det, dt)
    imgs = frames_on(images, det.device)
    t_total = imgs.shape[0]
    fe = torch.cat([cdet.fgfa.precompute_frame(cdet.features(imgs[t:t + 1],
                                                             dt))
                    for t in range(t_total)])
    outs = []
    for t in range(t_total):
        widx = fgfa_stream_indices(t, t_total, window=det.window,
                                   key_loc=det.key_loc, device=imgs.device)
        in_win = int(torch.nonzero(widx == t)[0, 0])
        agg = cdet.fgfa.aggregate_test(imgs[t:t + 1], imgs[widx], fe[widx],
                                       in_win)
        outs.append(cdet.detect_on(agg, image_hw,
                                   post_nms_top_n=post_nms_top_n))
    return stack_outputs(outs)


@torch.no_grad()
def dff_detect_video(det: DFFDetector, images, image_hw, *,
                     key_interval: int = 10, post_nms_top_n: int = 300,
                     compute_dtype: str = "float32") -> dict:
    """Whole-video DFF detection: frames at multiples of ``key_interval``
    run the backbone; every frame (the key frames too) detects on the
    latest key frame's features warped by flow times the scale map.
    ``compute_dtype="bfloat16"`` runs the backbone, the flow net and the
    RoI pass on a bf16 copy of the detector (box decode and NMS stay
    fp32). Returns what ``fgfa_detect_video`` returns."""
    dt = dtype_of(compute_dtype)
    cdet = _cast(det, dt)
    imgs = frames_on(images, det.device)
    outs = []
    for t in range(imgs.shape[0]):
        img = imgs[t:t + 1]
        if t % key_interval == 0:
            img_key, feats_key = img, cdet.features(img, dt)
        outs.append(cdet.detect_frame(img, img_key, feats_key, image_hw,
                                      post_nms_top_n=post_nms_top_n))
    return stack_outputs(outs)
