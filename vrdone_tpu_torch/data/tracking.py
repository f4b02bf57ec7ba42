# Copy of vrdone_tpu/data/tracking.py on the port's own matcher, kept so that
# the port imports nothing of vrdone_tpu; tests/test_torch_copies.py pins it.
"""Online IoU tracker: per-frame detections -> proposal tracklets.

The reference stack has no tracker of its own — eval proposals come from
VidSGG-BIG's *released* tracklet pickles (SURVEY.md §2.2). This module
closes that external dependency: link per-frame detections of the same
class across frames by IoU (Hungarian assignment on the IoU matrix —
the port's ops/hungarian.py), tolerate short gaps, and emit tracklets
in the build_traj_proposal input format (data/proposals.py), so
raw video -> detector -> tracker -> relation model runs end to end in-repo.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

import torch

from ..ops.hungarian import match_padded


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter,
                              1e-9)


@dataclass
class _Track:
    category_id: int
    frame_ids: list = field(default_factory=list)
    boxes: list = field(default_factory=list)
    features: list = field(default_factory=list)
    scores: list = field(default_factory=list)
    missed: int = 0


class IoUTracker:
    """Greedy-optimal per-class association with gap tolerance."""

    def __init__(self, iou_threshold: float = 0.4, max_gap: int = 3,
                 min_length: int = 5):
        self.iou_threshold = iou_threshold
        self.max_gap = max_gap
        self.min_length = min_length
        self._active: list[_Track] = []
        self._done: list[_Track] = []

    def update(self, frame_id: int, boxes: np.ndarray, labels: np.ndarray,
               scores: np.ndarray, features: np.ndarray | None = None):
        """Add one frame of detections. features: (N, D) or None."""
        n = len(boxes)
        assigned = np.zeros(n, bool)
        if self._active and n:
            track_boxes = np.stack([t.boxes[-1] for t in self._active])
            track_cats = np.asarray([t.category_id for t in self._active])
            iou = iou_matrix(track_boxes, boxes)
            iou[track_cats[:, None] != labels[None, :]] = 0.0
            # optimal assignment (minimize -IoU); tracks = rows
            k = max(len(self._active), n)
            cost = np.full((k, k), 1.0, np.float32)
            cost[:len(self._active), :n] = -iou
            row_for_col, _ = match_padded(torch.from_numpy(cost)[None],
                                          torch.ones((1, k), dtype=torch.bool))
            row_for_col = row_for_col[0].numpy()
            for det in range(n):
                tr = int(row_for_col[det])
                if tr < len(self._active) and iou[tr, det] >= \
                        self.iou_threshold:
                    t = self._active[tr]
                    t.frame_ids.append(frame_id)
                    t.boxes.append(boxes[det])
                    t.scores.append(float(scores[det]))
                    if features is not None:
                        t.features.append(features[det])
                    t.missed = 0
                    assigned[det] = True

        for det in range(n):
            if assigned[det]:
                continue
            t = _Track(category_id=int(labels[det]))
            t.frame_ids.append(frame_id)
            t.boxes.append(boxes[det])
            t.scores.append(float(scores[det]))
            if features is not None:
                t.features.append(features[det])
            self._active.append(t)

        still = []
        for t in self._active:
            if t.frame_ids[-1] == frame_id:
                still.append(t)
            else:
                t.missed += 1
                if t.missed > self.max_gap:
                    self._done.append(t)
                else:
                    still.append(t)
        self._active = still

    def finish(self) -> list[dict]:
        """Tracklets in build_traj_proposal input format."""
        out = []
        for t in self._done + self._active:
            if len(t.frame_ids) < self.min_length:
                continue
            rec = {
                "category_id": t.category_id,
                "score": float(np.mean(t.scores)),
                "frame_ids": np.asarray(t.frame_ids, np.int64),
                "boxes": np.stack(t.boxes).astype(np.float32),
            }
            rec["features"] = (np.stack(t.features).astype(np.float32)
                               if t.features else
                               np.zeros((len(t.frame_ids), 0), np.float32))
            out.append(rec)
        return out
