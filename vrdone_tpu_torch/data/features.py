# Copy of vrdone_tpu/data/features.py, kept so that the port imports nothing of
# vrdone_tpu; tests/test_torch_copies.py pins it to the original.
"""Per-pair feature assembly math (pure numpy, host-side).

Ports of the reference feature helpers (reference utils/misc.py:115-273)
reworked vectorised-numpy style: tracklet RoI-feature gathers, the 5-d
subject-relative-to-object geometry, the 8-d normalized box + velocity
descriptor, and the random training-window truncation. These run in the
input pipeline *before* anything touches the accelerator — the model sees
only fixed-shape padded arrays.
"""

from __future__ import annotations

import numpy as np


def gather_visual_features(box_features: dict, tid: int,
                           intervals) -> list[np.ndarray]:
    """Collect per-frame RoI features of a tracklet over [start, end) windows.

    box_features: {frame_id(1-based): {"frame_id", "tids", "visual_features"}}
    (the MEGA GT-feature pickle contract, reference utils/misc.py:115-136).
    """
    keys = sorted(box_features.keys())
    out = []
    for start, end in intervals:
        feats = []
        for k in keys:
            if (k - 1) < start:
                continue
            if (k - 1) >= end:
                break
            annos = box_features[k]
            assert k == annos["frame_id"]
            idx = np.where(np.asarray(annos["tids"]) == tid)[0]
            assert len(idx) == 1
            feats.append(np.asarray(annos["visual_features"])[idx])
        out.append(np.concatenate(feats, axis=0).astype(np.float32))
    return out


def gather_bboxes(trajectories, tid: int, intervals) -> list[np.ndarray]:
    """Collect per-frame [xmin, ymin, xmax, ymax] boxes of a tracklet
    (reference utils/misc.py:138-156)."""
    out = []
    for start, end in intervals:
        boxes = []
        for traj in trajectories[start:end]:
            for t in traj:
                if t["tid"] == tid:
                    bb = t["bbox"]
                    boxes.append([bb["xmin"], bb["ymin"],
                                  bb["xmax"], bb["ymax"]])
        assert len(boxes) == end - start
        out.append(np.asarray(boxes, dtype=np.float32))
    return out


def so_spatial_features(sbbox: np.ndarray, obbox: np.ndarray) -> np.ndarray:
    """5-d subject-relative-to-object geometry per frame
    (reference utils/misc.py:158-178)."""
    s_ctx = (sbbox[:, 2] + sbbox[:, 0]) / 2
    s_cty = (sbbox[:, 3] + sbbox[:, 1]) / 2
    s_w = sbbox[:, 2] - sbbox[:, 0]
    s_h = sbbox[:, 3] - sbbox[:, 1]
    o_ctx = (obbox[:, 2] + obbox[:, 0]) / 2
    o_cty = (obbox[:, 3] + obbox[:, 1]) / 2
    o_w = obbox[:, 2] - obbox[:, 0]
    o_h = obbox[:, 3] - obbox[:, 1]
    return np.stack([
        (s_ctx - o_ctx) / o_ctx,
        (s_cty - o_cty) / o_cty,
        np.log(s_w / o_w),
        np.log(s_h / o_h),
        np.log((s_w * s_h) / (o_w * o_h)),
    ], axis=1).astype(np.float32)


def entity_spatial_features(bboxes: np.ndarray, w: float,
                            h: float) -> np.ndarray:
    """8-d normalized center/size + finite-difference velocity
    (reference utils/misc.py:181-217). The first velocity sample is linearly
    back-extrapolated when >=3 frames exist, else duplicated."""
    b = bboxes.astype(np.float64).copy()
    b[:, 0:4:2] /= w
    b[:, 1:4:2] /= h
    ctx = (b[:, 2] + b[:, 0]) / 2
    cty = (b[:, 3] + b[:, 1]) / 2
    bw = b[:, 2] - b[:, 0]
    bh = b[:, 3] - b[:, 1]

    def vel(v):
        d = v[1:] - v[:-1]
        if len(d) > 1:
            first = d[0] - (d[1] - d[0])
        else:
            first = d[0]
        return np.concatenate([[first], d])

    feat = np.stack([ctx, vel(ctx), cty, vel(cty),
                     bw, vel(bw), bh, vel(bh)], axis=1)
    return feat.astype(np.float32)


def truncate_feats(so_feat: np.ndarray, preds: np.ndarray,
                   segments: np.ndarray, max_seq_len: int,
                   rng: np.random.Generator, trunc_thresh: float = 0.5,
                   max_times: int = 10):
    """Random crop to max_seq_len keeping segments with >=trunc_thresh
    overlap (reference utils/misc.py:219-273).

    so_feat: (T, C) time-major. Returns (so_feat, preds, segments) or None
    after max_times failed draws.
    """
    feat_len = so_feat.shape[0]
    if feat_len <= max_seq_len:
        return so_feat, preds, segments

    seg = segments.astype(np.float64)
    for _ in range(max_times):
        st = int(rng.integers(0, feat_len - max_seq_len + 1))
        ed = st + max_seq_len
        left = np.maximum(st, seg[:, 0])
        right = np.minimum(ed, seg[:, 1])
        inter = np.clip(right - left, 0, None)
        ratio = inter / np.abs(seg[:, 1] - seg[:, 0])
        keep = ratio >= trunc_thresh
        if keep.sum() > 0:
            new_seg = np.stack([left[keep], right[keep]], axis=1) - st
            return (so_feat[st:ed], preds[keep],
                    new_seg.astype(segments.dtype))
    return None


def segments_to_masks(segments: np.ndarray, max_seq_len: int) -> np.ndarray:
    """[start, end) integer segments -> (N, max_seq_len) binary masks
    (reference dataloaders/vidvrd.py:433-446)."""
    n = segments.shape[0]
    masks = np.zeros((n, max_seq_len), dtype=np.float32)
    for i, (s, e) in enumerate(segments.astype(np.int64)):
        assert 0 <= s < e <= max_seq_len, (s, e, max_seq_len)
        masks[i, s:e] = 1.0
    return masks


def clamp_boxes(bboxes: np.ndarray, w: float, h: float) -> np.ndarray:
    """Clamp boxes into the frame (reference dataloaders/vidvrd.py:345-353)."""
    out = bboxes.copy()
    out[:, 0] = np.clip(out[:, 0], 0, None)
    out[:, 1] = np.clip(out[:, 1], 0, None)
    out[:, 2] = np.clip(out[:, 2], None, w - 1)
    out[:, 3] = np.clip(out[:, 3], None, h - 1)
    return out
