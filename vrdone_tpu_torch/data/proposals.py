"""Proposal-tracklet assembly: the per-video ``{"traj_proposal": ...}`` dict
the eval dataloaders read, from raw tracklets.

Copy of ``build_traj_proposal`` and the helpers it calls
(``linear_interpolate_boxes``, ``merge_durations``) from
``vrdone_tpu/data/proposals.py``, kept so that the port imports nothing of
the JAX package; ``tests/test_torch_copies.py`` holds each function's source
to the original's.
"""

from __future__ import annotations

import numpy as np


def linear_interpolate_boxes(frame_ids: np.ndarray,
                             boxes: np.ndarray) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Fill missing frames of a tracklet by linear interpolation
    (reference VidSGG-BIG utils_func.linear_interpolation behaviour).

    frame_ids: sorted int64 (n,); boxes: (n, 4). Returns (dense_frame_ids,
    dense_boxes) covering [frame_ids[0], frame_ids[-1]]."""
    start, end = int(frame_ids[0]), int(frame_ids[-1])
    dense_ids = np.arange(start, end + 1)
    dense = np.empty((len(dense_ids), 4), np.float32)
    for d in range(4):
        dense[:, d] = np.interp(dense_ids, frame_ids, boxes[:, d])
    return dense_ids, dense


def merge_durations(durations: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merge overlapping [start, end) spans (utils_func.merge_duration_list)."""
    if not durations:
        return []
    durations = sorted(durations)
    out = [list(durations[0])]
    for s, e in durations[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(d) for d in out]


def build_traj_proposal(video_name: str, tracklets: list[dict],
                        video_wh: tuple[int, int], video_len: int,
                        max_proposal: int = 180,
                        dim_feat: int = 1024) -> dict:
    """Assemble the per-video proposal dict from raw tracklets.

    Each tracklet: {"category_id", "score", "frame_ids" (sorted, possibly
    gappy), "boxes" (n, 4), "features" (n, dim)}. Gappy tracklets are
    densified by linear interpolation of boxes and nearest-fill of
    features; tracklets are score-sorted and clipped to max_proposal
    (reference dataloader_vidvrd.py:39-52).
    """
    tracklets = sorted(tracklets, key=lambda t: -float(t["score"]))
    tracklets = tracklets[:max_proposal]

    cat_ids, scores, bboxes_list, durations, features_list = \
        [], [], [], [], []
    for t in tracklets:
        fids = np.asarray(t["frame_ids"], np.int64)
        boxes = np.asarray(t["boxes"], np.float32)
        feats = np.asarray(t["features"], np.float32)
        dense_ids, dense_boxes = linear_interpolate_boxes(fids, boxes)
        # features: nearest-previous fill on interpolated frames
        src = np.searchsorted(fids, dense_ids, side="right") - 1
        dense_feats = feats[np.clip(src, 0, len(fids) - 1)]
        cat_ids.append(int(t["category_id"]))
        scores.append(float(t["score"]))
        bboxes_list.append(dense_boxes)
        durations.append([int(dense_ids[0]), int(dense_ids[-1])])
        features_list.append(dense_feats)

    return {
        "MAX_PROPOSAL": max_proposal,
        "video_name": video_name,
        "cat_ids": np.asarray(cat_ids, np.int64),
        "scores": np.asarray(scores, np.float32),
        "bboxes_list": bboxes_list,
        "traj_durations": np.asarray(durations, np.int64),
        "features_list": features_list,
        "num_proposals": len(cat_ids),
        "dim_feat": dim_feat,
        "video_len": video_len,
        "video_wh": tuple(video_wh),
    }
