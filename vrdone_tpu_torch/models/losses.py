"""Matching costs and training losses (focal / dice, plus fuzzy-boundary
variants) over padded ground truth (counterpart of
``vrdone_tpu/models/losses.py``).

Each batch item carries up to G ground-truth relations with a validity
column mask; costs are per-item (Q, G) blocks, batched over any leading
axes, and every reduction is mask-weighted. Invalid entries never
contribute.

Shapes (``...`` is any batch of leading axes):
    pred_logits: (..., Q, K+1)    pred_masks: (..., Q, T) logits
    gt_labels:   (..., G) int     gt_masks:   (..., G, T) {0,1}
    gt_segs:     (..., G, 2)      gt_valid:   (..., G) bool
    seq_mask:    (..., T) bool    -- the per-item temporal validity

Under sequence parallelism (inside ``parallel.collectives.time_sharded``)
T is a rank's contiguous columns of the global time axis: the time
reductions take their partial sums over the rank's columns and sum them
over the sp ranks before any nonlinear use (the numerators and
denominators of the costs and of the dice loss, never the finished
values), the focal loss's per-pair mean divides by the global T, and the
fuzzy targets' positions start at the columns' global offset.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..parallel import collectives

Tensor = torch.Tensor

FOCAL_ALPHA = 0.25
FOCAL_GAMMA = 2.0


def _total(*xs: Tensor) -> tuple:
    """Each of ``xs`` summed over the sp ranks when the tensors are
    time-sharded (one collective), else as it is."""
    layout = collectives.time_layout()
    if layout is None:
        return xs
    return tuple(collectives.sum_time(torch.stack(xs), layout).unbind(0))


def _bce_with_logits(logits: Tensor, targets: Tensor) -> Tensor:
    """Numerically stable binary cross entropy with logits."""
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def fuzzy_targets(gt_masks: Tensor, gt_segs: Tensor, seq_mask: Tensor,
                  scale_range: float) -> Tensor:
    """Cosine-tapered soft targets around segment boundaries (reference
    models/losses.py:215-225): binary inside the inner band
    (|t-c| < L/2*sr), sqrt(relu(cos(pi*sr/L*(t-c)))) in the fuzzy ring
    (inner < |t-c| < L/2/sr).

    gt_masks: (..., G, T), gt_segs: (..., G, 2), seq_mask: (..., T) bool.
    """
    s = gt_segs[..., 0].float()
    e = gt_segs[..., 1].float()
    center = (e - 1 + s) / 2.0                       # (..., G)
    length = e - s
    # padded slots have length 0; keep the math finite
    safe_len = torch.where(length > 0, length, torch.ones_like(length))
    t = gt_masks.shape[-1]
    layout = collectives.time_layout()
    start = 0 if layout is None else layout.sp * t
    t_idx = torch.arange(start, start + t, dtype=torch.float32,
                         device=gt_masks.device)
    dist = (t_idx - center[..., None]).abs()         # (..., G, T)
    smask = seq_mask[..., None, :]
    abs_pos = dist < (length[..., None] / 2.0 * scale_range)
    all_rng = (dist < (length[..., None] / 2.0 / scale_range)) & smask
    fuzzy = torch.logical_xor(all_rng, abs_pos) & smask
    w = torch.cos(math.pi * scale_range / safe_len[..., None]
                  * (t_idx - center[..., None]))
    w = torch.sqrt(w * (w > 0))
    return w * fuzzy + gt_masks * abs_pos


# ---------------------------------------------------------------------------
# pairwise matching costs
# ---------------------------------------------------------------------------

def pairwise_class_cost(pred_logits: Tensor, gt_labels: Tensor) -> Tensor:
    """(..., Q, K+1) x (..., G) -> (..., Q, G) cross-entropy cost
    (reference maskvrd.py:450-452)."""
    logp = F.log_softmax(pred_logits, dim=-1)
    idx = gt_labels.long()[..., None, :].expand(
        *logp.shape[:-1], gt_labels.shape[-1])
    return -logp.gather(-1, idx)


def pairwise_focal_cost(pred_masks: Tensor, gt_tgt: Tensor,
                        seq_mask: Tensor) -> Tensor:
    """(..., Q, T) logits x (..., G, T) targets -> (..., Q, G) focal cost
    (reference batch_masked_sigmoid_focal_loss, models/losses.py:4-42).
    gt_tgt may be soft (fuzzy) targets."""
    prob = torch.sigmoid(pred_masks)
    fp = ((1 - prob) ** FOCAL_GAMMA
          * _bce_with_logits(pred_masks, torch.ones_like(pred_masks))
          * FOCAL_ALPHA)
    fn = (prob ** FOCAL_GAMMA
          * _bce_with_logits(pred_masks, torch.zeros_like(pred_masks))
          * (1 - FOCAL_ALPHA))
    m = seq_mask.to(fp.dtype)[..., None, :]
    fp = fp * m
    fn = fn * m
    tgt = gt_tgt * m
    cost = fp @ tgt.transpose(-1, -2) + fn @ ((1 - gt_tgt) * m).transpose(
        -1, -2)
    if collectives.time_layout() is None:
        return cost / m.sum(-1, keepdim=True)
    cost, count = _total(cost, m.sum(-1, keepdim=True).expand(cost.shape))
    return cost / count


def pairwise_dice_cost(pred_masks: Tensor, gt_tgt: Tensor,
                       seq_mask: Tensor) -> Tensor:
    """(..., Q, T) x (..., G, T) -> (..., Q, G) dice cost
    (reference batch_masked_dice_loss, models/losses.py:75-96)."""
    m = seq_mask.to(pred_masks.dtype)[..., None, :]
    p = torch.sigmoid(pred_masks) * m
    tgt = gt_tgt * m
    num = 2.0 * (p @ tgt.transpose(-1, -2))
    den = p.sum(-1)[..., :, None] + tgt.sum(-1)[..., None, :]
    num, den = _total(num, den)
    return 1.0 - (num + 1.0) / (den + 1.0)


def matching_cost(pred_logits: Tensor, pred_masks: Tensor, gt_labels: Tensor,
                  gt_masks: Tensor, gt_segs: Tensor | None, gt_valid: Tensor,
                  seq_mask: Tensor, *, cost_class: float, cost_mask: float,
                  cost_dice: float, scale_range: float | None) -> Tensor:
    """(..., Q, G) total matching cost, finite everywhere (invalid columns
    are re-masked by the matcher). Time-sharded, every sp rank gets the
    whole cost."""
    del gt_valid  # the matcher masks the invalid columns
    if scale_range is not None:
        tgt = fuzzy_targets(gt_masks, gt_segs, seq_mask, scale_range)
    else:
        tgt = gt_masks
    c = (cost_class * pairwise_class_cost(pred_logits, gt_labels)
         + cost_mask * pairwise_focal_cost(pred_masks, tgt, seq_mask)
         + cost_dice * pairwise_dice_cost(pred_masks, tgt, seq_mask))
    return torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0)


# ---------------------------------------------------------------------------
# post-match losses over the padded batch
# ---------------------------------------------------------------------------

def classification_loss(pred_logits: Tensor, target_classes: Tensor,
                        eos_coef: float) -> Tensor:
    """Weighted CE over all queries (reference loss_labels,
    maskvrd.py:498-512): sum(w_i * ce_i) / sum(w_i), w = eos_coef on the
    background class 0. target_classes: (B, Q) int."""
    logp = F.log_softmax(pred_logits, dim=-1)
    ce = -logp.gather(-1, target_classes.long()[..., None])[..., 0]
    w = torch.where(target_classes == 0, eos_coef, 1.0).to(ce.dtype)
    return (w * ce).sum() / w.sum()


def _focal(pred: Tensor, tgt: Tensor, bce_tgt: Tensor,
           loss_mask: Tensor, pair_valid: Tensor, num_masks: Tensor) -> Tensor:
    """The focal loss; time-sharded, this rank's partial sum of it (the
    per-pair mean over the global T)."""
    prob = torch.sigmoid(pred)
    ce = _bce_with_logits(pred, bce_tgt)
    p_t = prob * tgt + (1 - prob) * (1 - tgt)
    loss = ce * (1 - p_t) ** FOCAL_GAMMA
    alpha_t = FOCAL_ALPHA * tgt + (1 - FOCAL_ALPHA) * (1 - tgt)
    loss = alpha_t * loss * loss_mask.to(loss.dtype)
    layout = collectives.time_layout()
    mean = (loss.mean(dim=1) if layout is None
            else loss.sum(dim=1) / (layout.n_sp * loss.shape[1]))
    per_pair = mean * pair_valid.to(loss.dtype)
    return per_pair.sum() / num_masks


def matched_focal_loss(pred: Tensor, tgt: Tensor, loss_mask: Tensor,
                       pair_valid: Tensor, num_masks: Tensor) -> Tensor:
    """Focal loss over matched (pred, gt) mask pairs (reference
    masked_sigmoid_focal_loss, models/losses.py:98-129): per-pair mean over
    the full padded T, summed, divided by num_masks. pred/tgt/loss_mask
    (N, T); pair_valid (N,) marks real matches. tgt may be soft."""
    return _focal(pred, tgt, tgt, loss_mask, pair_valid, num_masks)


def matched_focal_fuzzy_loss(pred: Tensor, tgt: Tensor, segs: Tensor,
                             loss_mask: Tensor, pair_valid: Tensor,
                             num_masks: Tensor, scale_range: float) -> Tensor:
    """Fuzzy-boundary focal loss (reference masked_sigmoid_focal_fuzzy_loss,
    models/losses.py:272-316), with the reference's quirk: the BCE target is
    (targets_pos * loss_mask) while p_t and alpha_t use the unmasked
    targets_pos."""
    tgt_pos = fuzzy_targets(tgt[:, None, :], segs[:, None, :], loss_mask,
                            scale_range)[:, 0, :]
    mask_f = loss_mask.to(pred.dtype)
    return _focal(pred, tgt_pos, tgt_pos * mask_f, loss_mask, pair_valid,
                  num_masks)


def _dice(pred: Tensor, tgt: Tensor, loss_mask: Tensor, pair_valid: Tensor,
          num_masks: Tensor) -> Tensor:
    """The dice loss; time-sharded, its numerators and denominators summed
    over the sp ranks, so every rank has the whole loss."""
    m = loss_mask.to(pred.dtype)
    p = torch.sigmoid(pred) * m
    t = tgt * m
    num = 2.0 * (p * t).sum(-1)
    den = p.sum(-1) + t.sum(-1)
    num, den = _total(num, den)
    loss = (1.0 - (num + 1.0) / (den + 1.0)) * pair_valid.to(pred.dtype)
    return loss.sum() / num_masks


def matched_dice_loss(pred: Tensor, tgt: Tensor, loss_mask: Tensor,
                      pair_valid: Tensor, num_masks: Tensor) -> Tensor:
    """Dice loss over matched pairs (reference masked_dice_loss,
    models/losses.py:152-172)."""
    return _dice(pred, tgt, loss_mask, pair_valid, num_masks)


def matched_dice_fuzzy_loss(pred: Tensor, tgt: Tensor, segs: Tensor,
                            loss_mask: Tensor, pair_valid: Tensor,
                            num_masks: Tensor, scale_range: float) -> Tensor:
    """Fuzzy dice (reference masked_dice_fuzzy_loss,
    models/losses.py:320-354)."""
    tgt_pos = fuzzy_targets(tgt[:, None, :], segs[:, None, :], loss_mask,
                            scale_range)[:, 0, :]
    return _dice(pred, tgt_pos, loss_mask, pair_valid, num_masks)
