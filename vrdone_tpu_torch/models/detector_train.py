"""Detector training (counterpart of ``vrdone_tpu/models/detector_train.py``):
the IoU matcher, the balanced sampler, the RPN and box-head losses, MEGA's
training forward with its long-range memory, the training forwards of the
base, RDN, FGFA and DFF methods, and one data-parallel step for any of the
five.

Faster-RCNN losses with static shapes, as in the JAX package: each GT's
best anchor is force-matched, the pos/neg subsample is a top-k over random
priorities (a shortfall of positives leaves weights at 0), binary
objectness and smooth-L1 for the RPN, per-class cross-entropy and
smooth-L1 for the box head. The training forward runs the key, local,
memory and global frames through the shared backbone, takes the RPN losses
on the key frame, and the box-head losses on the MEGA-enhanced features of
the key proposals plus the GT boxes; the attention takes the dense route,
as JAX trains it.

The other methods (``method_detector_losses``): base runs the key frame
alone; RDN runs the key and reference frames through the backbone, the
reference proposals of [key, refs] (boxes without gradient, fc0 with it)
form the attention's set, and the box head reads the RDN-enhanced key
proposals; FGFA runs the RPN and the head on the flow-guided aggregate of
the reference frames' features; DFF runs the backbone on its one reference
frame and the RPN and the head on the features propagated to the key frame.
Each appends the GT boxes to its key proposals, which carry no gradient.

Where the JAX package draws the sampler's priorities inside the loss
(``jax.random.uniform``), the port takes them as tensors from a ``draw``
callable; the step draws them from a CPU generator seeded from (seed,
step, sample), so a rank draws for its samples of the global batch what one
process draws for them. The memory frames add nothing to the gradient, so
their backbone runs without it.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from ..convert import load_npz, load_params, params_from_jax, params_to_jax
from ..ops import boxes as box_ops
from ..parallel import mesh
from ..train.checkpoint import write_atomically
from . import rpn as rpn_lib
from .detector import MegaDetector, _anchors
from .flownet import DFFDetector, FGFADetector
from .mega import BoxSet, flatten_set
from .rdn import RDNDetector

Tensor = torch.Tensor
# (n_rpn, n_box) -> the RPN's and the box head's sampling priorities
Draw = Callable[[int, int], tuple[Tensor, Tensor]]
LOSS_NAMES = ("loss_rpn_cls", "loss_rpn_reg", "loss_box_cls", "loss_box_reg",
              "total_loss")


class MatchResult(NamedTuple):
    matched_idx: Tensor   # (N,) index of the matched GT
    labels: Tensor        # (N,) 1 positive, 0 negative, -1 ignored


def match_boxes(candidates: Tensor, gt_boxes: Tensor, gt_valid: Tensor, *,
                high: float, low: float,
                force_match: bool = True) -> MatchResult:
    """The IoU matcher: a candidate is positive at IoU >= ``high`` with its
    best GT, negative below ``low``, ignored between; with ``force_match``
    each valid GT's best candidate is positive. Ties take the first index.
    A padded GT (IoU -1 everywhere) names candidate 0 as its best and
    writes ``False`` there; where several GTs name one candidate the last
    GT's validity stands, as JAX's scatter on the CPU leaves it."""
    iou = box_ops.box_iou(candidates, gt_boxes)
    iou = torch.where(gt_valid[None, :], iou, -1.0)
    best_gt = torch.argmax(iou, dim=1)
    best_iou = iou.amax(dim=1)
    labels = torch.where(best_iou >= high, 1, torch.where(best_iou < low,
                                                          0, -1))
    if force_match:
        best_cand = torch.argmax(iou, dim=0)                       # (G,)
        n, g = iou.shape
        named = best_cand[None, :] == torch.arange(n, device=iou.device
                                                   )[:, None]      # (N, G)
        last = torch.where(named, torch.arange(g, device=iou.device), -1
                           ).amax(dim=1)
        force = (last >= 0) & gt_valid[last.clamp(min=0)]
        labels = torch.where(force, 1, labels)
        best_gt = torch.where(
            force, torch.argmax(torch.where(force[:, None], iou, -torch.inf),
                                dim=1), best_gt)
    return MatchResult(best_gt, labels)


def balanced_sample(labels: Tensor, priorities: Tensor, *, num_samples: int,
                    pos_fraction: float) -> tuple[Tensor, Tensor]:
    """Balanced pos/neg selection with static counts: the positives and
    negatives of highest priority, up to ``num_samples * pos_fraction``
    positives and the rest of ``num_samples`` negatives; when fewer exist
    than the quota, every one is taken. ``priorities``: (N,) uniforms in
    [0, 1). Returns (pos_weight, neg_weight), 1.0 where selected."""
    n = labels.shape[0]
    n_pos = min(int(num_samples * pos_fraction), n)
    n_neg = min(num_samples - n_pos, n)
    pos_p = torch.where(labels == 1, priorities, -1.0)
    neg_p = torch.where(labels == 0, priorities, -1.0)
    pos_thr = torch.topk(pos_p, n_pos).values[-1].clamp(min=0.0)
    neg_thr = torch.topk(neg_p, n_neg).values[-1].clamp(min=0.0)
    pos_w = ((labels == 1) & (pos_p >= pos_thr)).float()
    neg_w = ((labels == 0) & (neg_p >= neg_thr)).float()
    return pos_w, neg_w


def smooth_l1(x: Tensor, beta: float = 1.0 / 9) -> Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def rpn_losses(anchors: Tensor, objectness: Tensor, box_deltas: Tensor,
               gt_boxes: Tensor, gt_valid: Tensor, priorities: Tensor, *,
               batch_per_image: int = 256,
               pos_fraction: float = 0.5) -> dict:
    """objectness (N,), box_deltas (N, 4) over the anchors."""
    match = match_boxes(anchors, gt_boxes, gt_valid, high=0.7, low=0.3)
    pos_w, neg_w = balanced_sample(match.labels, priorities,
                                   num_samples=batch_per_image,
                                   pos_fraction=pos_fraction)
    w = pos_w + neg_w
    tgt = (match.labels == 1).float()
    bce = (torch.maximum(objectness, torch.zeros_like(objectness))
           - objectness * tgt + torch.log1p(torch.exp(-objectness.abs())))
    denom = w.sum().clamp(min=1.0)
    cls_loss = (w * bce).sum() / denom
    reg_tgt = rpn_lib.encode_boxes(gt_boxes[match.matched_idx], anchors)
    diff = torch.where(pos_w[:, None] > 0, box_deltas - reg_tgt, 0.0)
    reg_loss = (pos_w * smooth_l1(diff).sum(-1)).sum() / denom
    return {"loss_rpn_cls": cls_loss, "loss_rpn_reg": reg_loss}


def box_head_losses(proposals: Tensor, proposals_valid: Tensor,
                    cls_logits: Tensor, bbox_deltas: Tensor, gt_boxes: Tensor,
                    gt_labels: Tensor, gt_valid: Tensor, priorities: Tensor,
                    *, batch_per_image: int = 256, pos_fraction: float = 0.25,
                    reg_weights=(10.0, 10.0, 5.0, 5.0)) -> dict:
    """cls_logits (P, K+1), bbox_deltas (P, 4(K+1)) over the proposals."""
    match = match_boxes(proposals, gt_boxes, gt_valid, high=0.5, low=0.5,
                        force_match=False)
    labels = torch.where(proposals_valid, match.labels, -1)
    pos_w, neg_w = balanced_sample(labels, priorities,
                                   num_samples=batch_per_image,
                                   pos_fraction=pos_fraction)
    w = pos_w + neg_w
    cls_tgt = torch.where(labels == 1, gt_labels[match.matched_idx].long(), 0)
    logp = torch.log_softmax(cls_logits, dim=-1)
    ce = -logp.gather(1, cls_tgt[:, None])[:, 0]
    denom = w.sum().clamp(min=1.0)
    cls_loss = (w * ce).sum() / denom
    reg_tgt = rpn_lib.encode_boxes(gt_boxes[match.matched_idx], proposals,
                                   weights=reg_weights)
    idx = cls_tgt[:, None] * 4 + torch.arange(4, device=cls_tgt.device)
    deltas_c = bbox_deltas.gather(1, idx)
    diff = torch.where(pos_w[:, None] > 0, deltas_c - reg_tgt, 0.0)
    reg_loss = (pos_w * smooth_l1(diff).sum(-1)).sum() / denom
    return {"loss_box_cls": cls_loss, "loss_box_reg": reg_loss}


def _rpn_on_map(det, feat_map: Tensor):
    """The RPN on a (1, C, h, w) map -> (anchors, objectness, deltas)
    flattened over locations x anchors."""
    logits, deltas = det.rpn(feat_map)
    anchors = _anchors(logits.shape[1], logits.shape[2], feat_map.device)
    return anchors, logits[0].reshape(-1), deltas[0].reshape(-1, 4)


def _train_rois(anchors: Tensor, obj: Tensor, dl: Tensor, image_hw,
                gt_boxes: Tensor, gt_valid: Tensor, *,
                post_nms_top_n: int) -> tuple[Tensor, Tensor]:
    """The top ``post_nms_top_n`` RPN proposals after NMS, without
    gradient, with the GT boxes appended."""
    boxes, _, valid = rpn_lib.select_proposals(
        anchors, obj.detach(), dl.detach(), image_hw, pre_nms_top_n=2000,
        post_nms_top_n=post_nms_top_n)
    return torch.cat([boxes, gt_boxes]), torch.cat([valid, gt_valid])


def _ref_sets(det, frames: Tensor, image_hw) -> BoxSet:
    """Per frame of ``frames`` (F, C, h, w): the top ``base_num`` reference
    proposals (without gradient) and their fc0 features, frame-major."""
    sets = []
    for c4f in frames:
        with torch.no_grad():
            b, _, v = det.propose(c4f, image_hw, post_nms_top_n=det.base_num)
        sets.append((det.frame_fc0(c4f, b, v), b, v))
    return BoxSet(*(torch.stack(x) for x in zip(*sets)))


def train_forward(det: MegaDetector, key_image: Tensor, local_images: Tensor,
                  mem_images: Tensor | None, glob_images: Tensor | None,
                  image_hw, gt_boxes: Tensor, gt_valid: Tensor, *,
                  post_nms_top_n: int = 128):
    """The MEGA training forward of one sample: images (H, W, 3), (L, H, W,
    3), (M, ...) or None, (G, ...) or None, raw BGR pixels. The key
    frame's RPN output; its top ``post_nms_top_n`` proposals after NMS with
    the GT boxes appended (the proposals without gradient); per frame the
    top ``base_num`` reference proposals and their fc0 features (the
    window is the key frame's set then the local frames'; the memory
    frames' without gradient); the key proposals' features through the
    dense MEGA route's ``enhance_train`` and the box predictor. Returns
    (anchors, objectness, deltas, key_boxes, key_valid, cls_logits,
    bbox_deltas)."""
    mega = det.mega.routed(False, False)
    n_l = local_images.shape[0]
    parts = [key_image[None], local_images]
    if glob_images is not None:
        parts.append(glob_images)
    c4 = det.features(torch.cat(parts))
    anchors, obj, dl = _rpn_on_map(det, c4[:1])
    key_boxes, key_valid = _train_rois(anchors, obj, dl, image_hw, gt_boxes,
                                       gt_valid,
                                       post_nms_top_n=post_nms_top_n)
    window = _ref_sets(det, c4[:1 + n_l], image_hw)
    mem_frames = None
    if mem_images is not None:
        with torch.no_grad():
            mem_frames = _ref_sets(det, det.features(mem_images), image_hw)
    glob = None
    if glob_images is not None:
        glob = flatten_set(_ref_sets(det, c4[1 + n_l:], image_hw))
    key_pooled = det.box_head.pooled_features(c4[0], key_boxes)
    x = mega.enhance_train(key_pooled, key_boxes, key_valid, window,
                           mem_frames, glob)
    cls_logits, bbox_deltas = det.box_head.predictions(x)
    return anchors, obj, dl, key_boxes, key_valid, cls_logits, bbox_deltas


def mega_detector_losses(det: MegaDetector, key_image: Tensor,
                         local_images: Tensor, mem_images: Tensor | None,
                         glob_images: Tensor | None, image_hw,
                         gt_boxes: Tensor, gt_labels: Tensor,
                         gt_valid: Tensor, draw: Draw, *,
                         post_nms_top_n: int = 128) -> dict:
    """The per-sample MEGA training losses: the RPN's on the key frame,
    the box head's on the enhanced key proposals, and their sum
    ``total_loss``. ``draw(n_rpn, n_box)`` gives the two samplers'
    priorities (JAX's uniforms from the sample's two keys)."""
    (anchors, obj, dl, boxes, valid, cls_logits,
     bbox_deltas) = train_forward(det, key_image, local_images, mem_images,
                                  glob_images, image_hw, gt_boxes, gt_valid,
                                  post_nms_top_n=post_nms_top_n)
    p_rpn, p_box = draw(anchors.shape[0], boxes.shape[0])
    losses = rpn_losses(anchors, obj, dl, gt_boxes, gt_valid, p_rpn)
    losses.update(box_head_losses(boxes, valid, cls_logits, bbox_deltas,
                                  gt_boxes, gt_labels, gt_valid, p_box))
    losses["total_loss"] = sum(losses.values())
    return losses


# ---------------------------------------------------------------------------
# The base, RDN, FGFA and DFF training forwards
# ---------------------------------------------------------------------------

def _two_fc_on_map(det, feat_map: Tensor, image_hw, gt_boxes: Tensor,
                   gt_valid: Tensor, post_nms_top_n: int):
    """The RPN and the two-FC head on one (1, C, h, w) map (base, FGFA and
    DFF)."""
    anchors, obj, dl = _rpn_on_map(det, feat_map)
    boxes, valid = _train_rois(anchors, obj, dl, image_hw, gt_boxes, gt_valid,
                               post_nms_top_n=post_nms_top_n)
    cls_logits, bbox_deltas = det.head(det.pooled(feat_map[0], boxes))
    return anchors, obj, dl, boxes, valid, cls_logits, bbox_deltas


def base_train_forward(det, key_image: Tensor, ref_images: Tensor,
                       image_hw, gt_boxes: Tensor, gt_valid: Tensor, *,
                       post_nms_top_n: int = 128):
    """Plain Faster R-CNN on the key frame alone (``ref_images`` unused)."""
    return _two_fc_on_map(det, det.features(key_image[None]), image_hw,
                          gt_boxes, gt_valid, post_nms_top_n)


def fgfa_train_forward(det: FGFADetector, key_image: Tensor,
                       ref_images: Tensor, image_hw, gt_boxes: Tensor,
                       gt_valid: Tensor, *, post_nms_top_n: int = 128):
    """The backbone over key + refs, the refs' features warped onto the key
    frame and aggregated, the RPN and the head on the aggregate."""
    feats = det.features(torch.cat([key_image[None], ref_images]))
    agg = det.fgfa.aggregate_train(key_image[None], ref_images, feats[:1],
                                   feats[1:])
    return _two_fc_on_map(det, agg, image_hw, gt_boxes, gt_valid,
                          post_nms_top_n)


def dff_train_forward(det: DFFDetector, key_image: Tensor,
                      ref_images: Tensor, image_hw, gt_boxes: Tensor,
                      gt_valid: Tensor, *, post_nms_top_n: int = 128):
    """The backbone on the one reference frame (1, H, W, 3) only, its
    features propagated to the key frame by flow and the scale map, the
    RPN and the head on the propagated map."""
    prop = det.dff.propagate(key_image[None], ref_images,
                             det.features(ref_images))
    return _two_fc_on_map(det, prop, image_hw, gt_boxes, gt_valid,
                          post_nms_top_n)


def rdn_train_forward(det: RDNDetector, key_image: Tensor,
                      ref_images: Tensor, image_hw, gt_boxes: Tensor,
                      gt_valid: Tensor, *, post_nms_top_n: int = 128):
    """The backbone over key + refs; the key frame's RPN output and
    proposals; per frame of [key, refs...] the top ``base_num`` reference
    proposals (without gradient) and their fc0 features (with it), the
    frame-major window; the key proposals' pooled features through
    ``RDNHead.enhance`` and the box predictors."""
    c4 = det.features(torch.cat([key_image[None], ref_images]))
    anchors, obj, dl = _rpn_on_map(det, c4[:1])
    key_boxes, key_valid = _train_rois(anchors, obj, dl, image_hw, gt_boxes,
                                       gt_valid,
                                       post_nms_top_n=post_nms_top_n)
    window = _ref_sets(det, c4, image_hw)
    x = det.rdn.enhance(det.box_head.pooled_features(c4[0], key_boxes),
                        key_boxes, key_valid, window)
    cls_logits, bbox_deltas = det.predictions(x)
    return anchors, obj, dl, key_boxes, key_valid, cls_logits, bbox_deltas


METHOD_FORWARDS = {"base": base_train_forward, "rdn": rdn_train_forward,
                   "fgfa": fgfa_train_forward, "dff": dff_train_forward}


def method_detector_losses(method: str, det, sample: dict[str, Tensor],
                           image_hw, gt_boxes: Tensor, gt_labels: Tensor,
                           gt_valid: Tensor, draw: Draw, *,
                           post_nms_top_n: int = 128) -> dict:
    """The per-sample losses of the base, RDN, FGFA and DFF methods: the
    RPN's on the method's key map, the box head's on its key proposals plus
    the GT boxes, and their sum ``total_loss``. ``sample``: key (H, W, 3)
    and ref (R, H, W, 3) raw pixels (R = 0 for base, 1 for DFF)."""
    (anchors, obj, dl, boxes, valid, cls_logits,
     bbox_deltas) = METHOD_FORWARDS[method](
        det, sample["key"], sample["ref"], image_hw, gt_boxes, gt_valid,
        post_nms_top_n=post_nms_top_n)
    p_rpn, p_box = draw(anchors.shape[0], boxes.shape[0])
    losses = rpn_losses(anchors, obj, dl, gt_boxes, gt_valid, p_rpn)
    losses.update(box_head_losses(boxes, valid, cls_logits, bbox_deltas,
                                  gt_boxes, gt_labels, gt_valid, p_box))
    losses["total_loss"] = sum(losses.values())
    return losses


class StepPriorities:
    """The sampling priorities of one train step: global sample i's RPN
    uniforms, then its box head's, from a CPU generator seeded from (seed,
    step, i). The same on every rank and device, and a resumed run draws
    what an unbroken one would."""

    def __init__(self, seed: int, step: int, device: torch.device):
        self.seed, self.step, self.device = seed, step, device

    def __call__(self, sample: int) -> Draw:
        def draw(n_rpn: int, n_box: int) -> tuple[Tensor, Tensor]:
            entropy = np.random.SeedSequence(
                [self.seed, self.step, sample]).generate_state(2)
            gen = torch.Generator().manual_seed(
                int(entropy[0]) << 32 | int(entropy[1]))
            return (torch.rand(n_rpn, generator=gen).to(self.device),
                    torch.rand(n_box, generator=gen).to(self.device))
        return draw


def detector_train_step(det: nn.Module, optimizer,
                        batch: dict[str, Tensor],
                        draws: Callable[[int], Draw], *, image_hw,
                        post_nms_top_n: int = 128,
                        method: str = "mega") -> dict[str, Tensor]:
    """One step of the JAX package's ``make_detector_train_step`` (MEGA) or
    ``make_method_train_step`` (``method`` base, rdn, fgfa or dff): the
    per-sample losses averaged over the global batch, their gradient, then
    ``optimizer`` (``train/optim.py::DetectorSGD``). ``batch``: this rank's
    samples, key (B, H, W, 3), gt_boxes (B, Gt, 4), gt_labels (B, Gt),
    gt_valid (B, Gt), and for MEGA local (B, L, ...), mem (B, M, ...) and
    glob (B, G, ...) with M or G 0 to disable, for the other methods ref
    (B, R, ...), on the detector's device; every rank holds the same B.
    ``draws(i)`` gives global sample i's priorities. Each
    sample's backward runs before the next sample's forward (one sample's
    activations at a time); under torchrun one flat all-reduce sums the
    ranks' gradients, divided by the world size. Returns the global
    batch's mean losses, detached."""
    b = batch["key"].shape[0]
    first = mesh.process_index() * b
    params = list(det.parameters())
    grads = [torch.zeros_like(p) for p in params]
    sums = dict.fromkeys(LOSS_NAMES, 0.0)
    for i in range(b):
        gt = (batch["gt_boxes"][i], batch["gt_labels"][i],
              batch["gt_valid"][i], draws(first + i))
        if method == "mega":
            mem = batch["mem"][i] if batch["mem"].shape[1] else None
            glob = batch["glob"][i] if batch["glob"].shape[1] else None
            losses = mega_detector_losses(
                det, batch["key"][i], batch["local"][i], mem, glob, image_hw,
                *gt, post_nms_top_n=post_nms_top_n)
        else:
            losses = method_detector_losses(
                method, det, {"key": batch["key"][i], "ref": batch["ref"][i]},
                image_hw, *gt, post_nms_top_n=post_nms_top_n)
        g = torch.autograd.grad(losses["total_loss"] / b, params,
                                allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as in JAX
        torch._foreach_add_(grads, [torch.zeros_like(p) if x is None else x
                                    for p, x in zip(params, g)])
        for k in LOSS_NAMES:
            sums[k] = sums[k] + losses[k].detach()
    losses = torch.stack([sums[k] for k in LOSS_NAMES]) / b
    if mesh.is_distributed():
        world = mesh.process_count()
        flat = mesh.all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
        flat /= world
        grads = [g.view_as(p) for g, p in
                 zip(flat.split([p.numel() for p in params]), params)]
        losses = mesh.all_reduce_sum(losses) / world
    optimizer.update([p.data for p in params], grads)
    return dict(zip(LOSS_NAMES, losses.unbind()))


# ---------------------------------------------------------------------------
# Initial weights and checkpoints
# ---------------------------------------------------------------------------

def _flatten(prefix: str, node) -> dict[str, np.ndarray]:
    if hasattr(node, "items"):
        out = {}
        for k, v in node.items():
            out.update(_flatten(f"{prefix}/{k}", v))
        return out
    return {prefix: np.asarray(node)}


def graft_backbone(det: nn.Module, backbone_pkl: dict) -> None:
    """Seed the C4 backbone and the C5 head of any of the five detectors in
    place from a converted torchvision ResNet pickle (``{"c4": ...,
    "c5": ...}`` flax trees, as ``convert_resnet.convert`` or
    ``tools/convert_torch_resnet.py`` write it): C5 lies under
    ``box_head/c5`` in MEGA and RDN, under ``c5`` in base, FGFA and DFF.
    The trees must hold exactly the modules' leaves, with their shapes;
    values are cast to the parameters' dtype."""
    c5 = "box_head/c5" if hasattr(det, "box_head") else "c5"
    state = {}
    for prefix, tree in (("backbone", backbone_pkl["c4"]),
                         (c5, backbone_pkl["c5"])):
        part = params_from_jax(_flatten(prefix, tree))
        own = {k: v for k, v in det.state_dict().items()
               if k.startswith(prefix.replace("/", ".") + ".")}
        if set(part) != set(own):
            raise ValueError(
                f"backbone graft: {prefix} leaves differ (missing "
                f"{sorted(set(own) - set(part))}, unexpected "
                f"{sorted(set(part) - set(own))})")
        for k, v in part.items():
            if v.shape != own[k].shape:
                raise ValueError(
                    f"backbone graft shape mismatch at {k}: "
                    f"{tuple(own[k].shape)} vs {tuple(v.shape)} (is the "
                    "pickle in torch (O,I,H,W) layout? run "
                    "convert_torch_resnet_torch.py)")
        state.update(part)
    det.load_state_dict(state, strict=False)


def load_finetune_params(det: nn.Module, ckpt_path: str) -> None:
    """Weights-only restore (the reference's finetune): every parameter
    from a detector ``.npz`` of flax keys; the optimizer and the schedule
    start fresh. Raises if a key is missing or extra, or a shape
    differs."""
    load_params(det, load_npz(ckpt_path))


def save_detector_checkpoint(exp_dir: str, it: int, det: nn.Module,
                             optimizer, data_rng: np.random.Generator
                             ) -> str:
    """Rank 0 writes ``detector_{it}.npz`` (the weights under flax keys,
    ``tools/export_params_npz.py``'s layout) and ``detector_{it}.state.pt``
    (the momentum buffers and step count, the iteration and the data
    sampler's generator state); then every rank meets at a barrier.
    Returns the ``.npz`` path."""
    path = os.path.join(exp_dir, f"detector_{it}.npz")
    if mesh.process_index() == 0:
        flat = params_to_jax(det.state_dict())

        def write_npz(tmp):
            with open(tmp, "wb") as f:
                np.savez(f, **flat)

        write_atomically(path, write_npz)
        write_atomically(path[:-4] + ".state.pt", lambda tmp: torch.save(
            {"optimizer": optimizer.state_dict(), "it": it,
             "data_rng": data_rng.bit_generator.state}, tmp))
    mesh.barrier()
    return path


def latest_checkpoint(exp_dir: str) -> str | None:
    """The ``.npz`` of the highest iteration in ``exp_dir`` that has its
    ``.state.pt`` beside it, or None."""
    its = []
    for name in os.listdir(exp_dir):
        stem = name[len("detector_"):-len(".npz")]
        if (name.startswith("detector_") and name.endswith(".npz")
                and stem.isdigit() and os.path.exists(
                    os.path.join(exp_dir, f"detector_{stem}.state.pt"))):
            its.append(int(stem))
    return os.path.join(exp_dir, f"detector_{max(its)}.npz") if its else None


def restore_detector_checkpoint(path: str, det: nn.Module, optimizer,
                                data_rng: np.random.Generator) -> int:
    """Load ``path`` (``.npz``) and its ``.state.pt`` into the detector,
    the optimizer and the data generator, in place. Returns the
    iteration."""
    load_params(det, load_npz(path))
    state = torch.load(path[:-4] + ".state.pt", map_location="cpu",
                       weights_only=True)
    optimizer.load_state_dict(state["optimizer"], det.device)
    data_rng.bit_generator.state = state["data_rng"]
    return int(state["it"])


# Copy of vrdone_tpu/models/detector_train.py::sample_ref_indices, kept so
# that the port imports nothing of the JAX package; tests pin it.
def sample_ref_indices(rng: np.random.Generator, frame_id: int,
                       seg_len: int, *, n_local: int = 2, n_mem: int = 3,
                       n_glob: int = 2, min_offset: int = -12,
                       max_offset: int = 12,
                       all_frame_interval: int = 25) -> dict:
    """Host-side reference-frame sampling for one key frame (reference
    vid_mega.py:_get_train, :30-64): local offsets uniform in
    [min_offset, max_offset]; memory offsets around
    frame_id - ALL_FRAME_INTERVAL; global frames uniform over the video.
    Returns dict of frame-index arrays {"local", "mem", "glob"}."""
    span = max_offset - min_offset + 1

    def clamp(ids):
        return np.clip(ids, 0, seg_len - 1)

    local = clamp(frame_id + rng.choice(span, size=n_local, replace=False)
                  + min_offset)
    center = max(frame_id - all_frame_interval, 0)
    mem = clamp(center + rng.choice(span, size=n_mem, replace=False)
                + min_offset)
    # keep exactly n_glob frames (static shapes under jit) — sample with
    # replacement only when the video is shorter than n_glob
    glob = rng.choice(seg_len, size=n_glob, replace=seg_len < n_glob)
    return {"local": local, "mem": mem, "glob": glob}


# Copies of vrdone_tpu/models/detector_train.py::METHOD_REF_OFFSETS and
# ::sample_method_refs, kept so that the port imports nothing of the JAX
# package; tests pin them.
METHOD_REF_OFFSETS = {
    # method: (min_offset, max_offset, ref_num) — reference defaults.py
    "rdn": (-18, 18, 2),    # VID.RDN (:419-424)
    "fgfa": (-9, 9, 2),     # VID.FGFA (:453-458)
    "dff": (-9, 0, 1),      # VID.DFF (:462-463, one ref frame)
    "base": (0, 0, 0),
}


def sample_method_refs(rng: np.random.Generator, method: str,
                       frame_id: int, seg_len: int,
                       ref_num: int | None = None) -> np.ndarray:
    """Reference-frame sampling for the non-MEGA methods (reference
    vid_rdn/vid_fgfa/vid_dff.py _get_train: offsets chosen without
    replacement in [MIN_OFFSET, MAX_OFFSET], clamped to the segment)."""
    lo, hi, n = METHOD_REF_OFFSETS[method]
    if ref_num is not None:
        n = ref_num
    if n == 0:
        return np.zeros((0,), np.int64)
    offsets = rng.choice(hi - lo + 1, size=n, replace=False) + lo
    return np.clip(frame_id + offsets, 0, seg_len - 1)
