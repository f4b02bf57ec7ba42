"""The RDN relation-distillation head and video detector (counterpart of
``vrdone_tpu/models/rdn.py``).

RDN shares MEGA's grouped, position-biased attention but has no
content-free query ``u``, no long-range memory and no global stages:

  * base stages: x = relu(fc_i(x)); x += attention(x, refs) over the whole
    reference set of the window;
  * advanced stages (``advanced_stage`` > 0): a distilled subset (the first
    ``advanced_num`` proposals of each frame) is refined by attending over
    the whole set, then the key rows attend over the distilled set.

The attention is the dense einsum-softmax form, as in the JAX package
(MEGA's fused kernel is not on this path). Sets are padded with validity
masks; a set with no valid key gives zeros. Whole-video detection is a
per-frame precompute (proposals, pooled key features, fc0-level reference
features), then a loop over the sliding window with no carried state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import compute_dtype as dtype_of
from . import rpn as rpn_lib
from .detector import BoxHead, MegaDetector, _cast, frames_on
from .mega import (NEG_INF, BoxSet, GroupedLinear, _dense,
                   cal_position_embedding, dense, flatten_set, promoted,
                   window_indices)
from .resnet import ResNetC4

Tensor = torch.Tensor


class RDNHead(nn.Module):
    """Per attention ``Wg<i>``, ``Wq<i>``, ``Wk<i>``, ``Wv<i>`` and per stage
    ``fc<i>`` (fc0 lifts the pooled ``in_dim`` features), under the flax
    names: ``base_stage`` attentions without an advanced stage, else
    ``base_stage + advanced_stage + 1``."""

    def __init__(self, feat_dim: int = 1024, embed_dim: int = 64,
                 groups: int = 16, base_stage: int = 2,
                 advanced_stage: int = 0, advanced_num: int = 15,
                 in_dim: int = 2048, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.feat_dim, self.embed_dim, self.groups = feat_dim, embed_dim, groups
        self.base_stage, self.advanced_stage = base_stage, advanced_stage
        self.advanced_num = advanced_num
        n_fc = base_stage + advanced_stage
        n_att = n_fc + (1 if advanced_stage else 0)
        kw = dict(device=device, generator=generator)
        for i in range(n_fc):
            setattr(self, f"fc{i}", _dense(in_dim if i == 0 else feat_dim,
                                           feat_dim, "fc", **kw))
        for i in range(n_att):
            setattr(self, f"Wg{i}", _dense(embed_dim, groups, "std", **kw))
            setattr(self, f"Wq{i}", _dense(feat_dim, feat_dim, "fc", **kw))
            setattr(self, f"Wk{i}", _dense(feat_dim, feat_dim, "fc", **kw))
            setattr(self, f"Wv{i}", GroupedLinear(feat_dim, groups, **kw))

    def fc(self, i: int, x: Tensor) -> Tensor:
        return F.relu(dense(getattr(self, f"fc{i}"), x))

    def attention(self, roi_feat: Tensor, rois: Tensor, ref: BoxSet,
                  index: int) -> Tensor:
        """Grouped content attention of the (N, D) queries over the (M, D)
        reference set plus the log-added geometric bias log(relu(Wg . PE) +
        1e-6), the padded slots masked with the finite ``NEG_INF``, the
        softmax times the validity, then the grouped projection."""
        g = self.groups
        dg = self.feat_dim // g
        q = dense(getattr(self, f"Wq{index}"), roi_feat)
        k = dense(getattr(self, f"Wk{index}"), ref.feat)
        q = q.reshape(-1, g, dg).transpose(0, 1)
        k = k.reshape(-1, g, dg).transpose(0, 1)
        aff = torch.einsum("gnd,gmd->gnm", *promoted(q, k)) / math.sqrt(dg)
        pe = cal_position_embedding(rois, ref.rois, self.embed_dim)
        wg = F.relu(dense(getattr(self, f"Wg{index}"), pe))       # (N, M, g)
        aff = aff + torch.log(wg + 1e-6).permute(2, 0, 1)
        aff = torch.where(ref.valid[None, None, :], aff, NEG_INF)
        att = torch.softmax(aff, dim=-1)
        att = att * ref.valid[None, None, :].to(att.dtype)
        out = torch.einsum("gnm,md->gnd", *promoted(att, ref.feat))
        return getattr(self, f"Wv{index}")(out)

    def pre_calculate(self, pooled: Tensor) -> Tensor:
        """fc0 on pooled RoI features: the stored reference features."""
        return self.fc(0, pooled)

    def enhance(self, key_pooled: Tensor, key_rois: Tensor, key_valid: Tensor,
                window: BoxSet) -> Tensor:
        """The RDN flow: ``key_pooled`` (Nk, in_dim) raw pooled (fc0 runs in
        the stage loop), ``window`` fc0-level (F, B, D) frame-major. Returns
        (Nk, D)."""
        a, d = self.advanced_num, self.feat_dim
        f = window.feat.shape[0]
        ref = flatten_set(window)
        x = key_pooled
        for i in range(self.base_stage):
            x = self.fc(i, x)
            x = x + self.attention(x, key_rois, ref, i)
            x = x * key_valid[:, None].to(x.dtype)
        if self.advanced_stage > 0:
            if a > window.feat.shape[1]:
                raise ValueError(f"advanced_num {a} > per-frame slots "
                                 f"{window.feat.shape[1]}")
            cur = ref.feat.reshape(f, -1, d)[:, :a].reshape(-1, d)
            cur_rois = window.rois[:, :a].reshape(-1, 4)
            cur_valid = window.valid[:, :a].reshape(-1)
            for i in range(self.advanced_stage):
                att = self.attention(cur, cur_rois, ref, i + self.base_stage)
                cur = self.fc(i + self.base_stage, cur + att)
                cur = cur * cur_valid[:, None].to(cur.dtype)
            adv = BoxSet(cur, cur_rois, cur_valid)
            x = x + self.attention(x, key_rois, adv,
                                   self.base_stage + self.advanced_stage)
            x = x * key_valid[:, None].to(x.dtype)
        return x


class RDNDetector(nn.Module):
    """The RDN video detector under the flax names ``backbone``, ``rpn``,
    ``box_head``, ``rdn``: ResNet-C4, the RPN, RoIAlign -> C5 on the key
    frame's proposals, the RDN head over the window's reference proposals,
    and the box predictors on the enhanced 1024-d features. Defaults are
    the reference's: R-101-C4, 2 base stages, 16 groups, base_num 75,
    advanced_num = base_num * 0.2, window 37 with the key at 18."""

    features = MegaDetector.features
    propose = MegaDetector.propose
    device = MegaDetector.device

    def __init__(self, num_classes: int, resnet_layers=(3, 4, 23),
                 base_stage: int = 2, advanced_stage: int = 0,
                 groups: int = 16, base_num: int = 75, ratio: float = 0.2,
                 window: int = 37, key_loc: int = 18,
                 stride_in_1x1: bool = False, *, device: torch.device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_classes = num_classes
        self.base_stage, self.advanced_stage = base_stage, advanced_stage
        self.groups, self.base_num, self.ratio = groups, base_num, ratio
        self.window, self.key_loc = window, key_loc
        kw = dict(device=device, generator=generator)
        self.backbone = ResNetC4(resnet_layers, stride_in_1x1=stride_in_1x1,
                                 **kw)
        self.rpn = rpn_lib.RPNHead(**kw)
        self.box_head = BoxHead(num_classes, stride_in_1x1=stride_in_1x1,
                                **kw)
        self.rdn = RDNHead(groups=groups, base_stage=base_stage,
                           advanced_stage=advanced_stage,
                           advanced_num=self.advanced_num, **kw)
        self.eval()

    @property
    def advanced_num(self) -> int:
        return max(1, int(self.base_num * self.ratio))

    def frame_fc0(self, c4_feat: Tensor, rois: Tensor, valid: Tensor
                  ) -> Tensor:
        """One frame's fc0-level reference features (zero where
        invalid)."""
        x = self.rdn.pre_calculate(self.box_head.pooled_features(c4_feat,
                                                                 rois))
        return x * valid[:, None].to(x.dtype)

    def predictions(self, enhanced: Tensor) -> tuple[Tensor, Tensor]:
        return self.box_head.predictions(enhanced)


def stream_video_rdn(head: RDNHead, *, key_pooled: Tensor, key_rois: Tensor,
                     key_valid: Tensor, ref_feat: Tensor, ref_rois: Tensor,
                     ref_valid: Tensor, window: int = 37,
                     key_loc: int = 18) -> Tensor:
    """Enhance every frame over its sliding window (the prefill and clamp
    of MEGA's deque; no memory, no global set). key_pooled (T, Nk, in_dim)
    raw pooled key sets; ref_feat (T, B, D) fc0-level. Returns (T, Nk,
    D)."""
    t_total = ref_feat.shape[0]
    outs = []
    for t in range(t_total):
        widx = window_indices(t, t_total, window=window, key_loc=key_loc,
                              device=ref_feat.device)
        win = BoxSet(ref_feat[widx], ref_rois[widx], ref_valid[widx])
        outs.append(head.enhance(key_pooled[t], key_rois[t], key_valid[t],
                                 win))
    return torch.stack(outs)


@torch.no_grad()
def rdn_detect_video(det: RDNDetector, images, image_hw, *,
                     key_post_nms: int = 300,
                     compute_dtype: str = "float32") -> dict:
    """Whole-video RDN detection: per frame the key proposals, their pooled
    features and the reference set (the key set's first ``base_num`` when
    ``key_post_nms >= base_num``, else its own proposals) with its fc0
    features; then the RDN head over each frame's window, then the box
    predictors. ``compute_dtype="bfloat16"`` runs the precompute on a bf16
    copy of the detector (box decode and NMS stay fp32; the pooled and fc0
    features come back fp32), and the head and predictors in fp32. Returns
    numpy arrays: proposals (T, Nk, 4), proposal_scores, valid, cls_logits
    (T, Nk, K+1), bbox_deltas, visual (T, Nk, 1024)."""
    dt = dtype_of(compute_dtype)
    cdet = _cast(det, dt)
    imgs = frames_on(images, det.device)
    bn = det.base_num
    outs = []
    for t in range(imgs.shape[0]):
        c4 = cdet.features(imgs[t:t + 1], dt)[0]
        kb, ks, kv = cdet.propose(c4, image_hw, post_nms_top_n=key_post_nms)
        key_pooled = cdet.box_head.pooled_features(c4, kb)
        key_pooled = (key_pooled * kv[:, None].to(key_pooled.dtype)).float()
        if key_post_nms >= bn:
            rb, rv = kb[:bn], kv[:bn]
            ref_fc0 = cdet.rdn.pre_calculate(key_pooled[:bn])
            ref_fc0 = ref_fc0 * rv[:, None].to(ref_fc0.dtype)
        else:
            rb, _, rv = cdet.propose(c4, image_hw, post_nms_top_n=bn)
            ref_fc0 = cdet.frame_fc0(c4, rb, rv)
        outs.append((kb, ks, kv, key_pooled, rb, rv, ref_fc0.float()))
    kb, ks, kv, kp, rb, rv, rf = (torch.stack(x) for x in zip(*outs))
    visual = stream_video_rdn(det.rdn, key_pooled=kp, key_rois=kb,
                              key_valid=kv, ref_feat=rf, ref_rois=rb,
                              ref_valid=rv, window=det.window,
                              key_loc=det.key_loc)
    t_total, nk = kb.shape[:2]
    cls_logits, bbox_deltas = det.predictions(visual.reshape(t_total * nk, -1))
    return {"proposals": kb.cpu().numpy(),
            "proposal_scores": ks.cpu().numpy(),
            "valid": kv.cpu().numpy(),
            "cls_logits": cls_logits.reshape(t_total, nk, -1).cpu().numpy(),
            "bbox_deltas": bbox_deltas.reshape(t_total, nk, -1).cpu().numpy(),
            "visual": visual.cpu().numpy()}
