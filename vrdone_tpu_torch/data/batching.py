"""Ragged -> static-shape batch packing (mirror of
``vrdone_tpu/data/batching.py``).

Kept as a copy so that the port does not import ``vrdone_tpu``;
``tests/test_torch_eval.py`` and ``tests/test_torch_train.py`` pin each
function, output for output, to the original. Train batches have one static
shape. For eval, short sequences pad to ``max_seq_len``; long ones to
``max_seq_len * 2**k`` rounded up to the model's ``max_div_factor``, so the
forward sees a handful of shapes.
"""

from __future__ import annotations

import numpy as np


def packed_channels(model_cfg) -> int:
    """Channels of one packed SO-pair frame: subject and object visual
    features, the pair's box features, each entity's box features and, with
    ``with_clip_feature``, each entity's CLIP features (``eval.py``'s and
    ``train.py``'s width)."""
    c = 2 * model_cfg.visual_dim + model_cfg.bbox_so_dim \
        + 2 * model_cfg.bbox_entity_dim
    if model_cfg.with_clip_feature:
        c += 2 * model_cfg.clip_dim
    return c


def pack_train_batch(pairs: list[dict], pack_size: int, max_seq_len: int,
                     num_gt: int, feat_dim: int) -> dict:
    """Pack per-pair dicts (from datasets.get_train_item) into the static
    training batch of ``models/maskvrd.py``. Pairs beyond pack_size are
    dropped."""
    p = pack_size
    item_valid = np.zeros((p,), bool)
    gt_labels = np.zeros((p, num_gt), np.int32)
    gt_masks = np.zeros((p, num_gt, max_seq_len), np.float32)
    gt_segs = np.zeros((p, num_gt, 2), np.int32)
    gt_valid = np.zeros((p, num_gt), bool)

    # the native packer (native/tracklet_ops.cpp) when it is built
    from . import native
    if native.have_native() and pairs:
        feats, seq_mask = native.pack_pairs(
            [pair["so_feat"] for pair in pairs[:p]], p, max_seq_len,
            feat_dim)
    else:
        feats = np.zeros((p, max_seq_len, feat_dim), np.float32)
        seq_mask = np.zeros((p, max_seq_len), bool)
        for i, pair in enumerate(pairs[:p]):
            t = pair["so_feat"].shape[0]
            feats[i, :t] = pair["so_feat"]
            seq_mask[i, :t] = True
        # keep one valid frame on padded rows (finite masked reductions)
        seq_mask[len(pairs[:p]):, 0] = True

    for i, pair in enumerate(pairs[:p]):
        item_valid[i] = True
        n = min(len(pair["preds"]), num_gt)
        gt_labels[i, :n] = pair["preds"][:n]
        gt_masks[i, :n] = pair["masks"][:n]
        gt_segs[i, :n] = pair["segs"][:n]
        gt_valid[i, :n] = True
    return {
        "feats": feats,
        "seq_mask": seq_mask,
        "item_valid": item_valid,
        "gt_labels": gt_labels,
        "gt_masks": gt_masks,
        "gt_segs": gt_segs,
        "gt_valid": gt_valid,
    }


def eval_bucket_lengths(lengths: np.ndarray, max_seq_len: int,
                        max_div_factor: int) -> np.ndarray:
    """Padded length per sequence: max_seq_len for short ones; for long
    ones, max_seq_len * 2**k rounded up to max_div_factor."""
    out = np.full(lengths.shape, max_seq_len, np.int64)
    long = lengths > max_seq_len
    if long.any():
        k = np.ceil(np.log2(lengths[long] / max_seq_len)).astype(np.int64)
        padded = max_seq_len * (2 ** k)
        padded = ((padded + max_div_factor - 1)
                  // max_div_factor) * max_div_factor
        out[long] = padded
    return out


def pack_eval_bucket(seqs: list[np.ndarray], pad_len: int,
                     pack_size: int, feat_dim: int) -> tuple[dict, int]:
    """Pack <= pack_size sequences of length <= pad_len into one batch.

    Returns (batch, n_real). Slots beyond n_real are padding with one valid
    frame (finite softmax) and must be dropped by the caller.
    """
    n = len(seqs)
    if n > pack_size:
        raise ValueError(f"{n} sequences do not fit a pack of {pack_size}")
    feats = np.zeros((pack_size, pad_len, feat_dim), np.float32)
    mask = np.zeros((pack_size, pad_len), bool)
    for i, s in enumerate(seqs):
        t = s.shape[0]
        if t > pad_len:
            raise ValueError(f"sequence of {t} frames exceeds {pad_len}")
        feats[i, :t] = s
        mask[i, :t] = True
    mask[n:, 0] = True
    return {"feats": feats, "seq_mask": mask}, n
