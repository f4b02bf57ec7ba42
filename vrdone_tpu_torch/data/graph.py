# Copy of vrdone_tpu/data/graph.py, kept so that the port imports nothing of
# vrdone_tpu; tests/test_torch_copies.py pins it to the original.
"""GT relation graph for BIG-style training (VideoGraph equivalent).

The reference bundles VidSGG-BIG, whose training consumes a per-video
``VideoGraph``: GT entity trajectories, GT predicate instances, and a
(2, num_preds, num_trajs) subject/object adjacency tensor built from the
annotation JSON (reference
datasets/VidSGG-BIG/dataloaders/dataloader_vidvrd.py:84-146 container,
:327-455 construction; dataloader_vidor_v3.py:487+ is the same machinery
with VidOR vocabularies).

This rebuild is array-first: ragged per-trajectory box lists become one
(num_trajs, max_frames, 4) padded array with per-row frame counts, ready
to feed a fixed-shape XLA program. Construction order, duration
conventions (half-open while building, closed in the container), relation
merging, and the one-hot adjacency invariant all match the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .proposals import linear_interpolate_boxes, merge_durations


@dataclass
class VideoGraph:
    """Padded GT graph (reference dataloader_vidvrd.py:84-146).

    traj_durations / pred_durations use CLOSED intervals [start, end-1]
    (the reference subtracts 1 from the exclusive end in __init__,
    :102/:106). traj_boxes is padded over frames; traj_n_frames gives the
    valid length of each row. adj is (2, P, N): [0]=subject, [1]=object.
    """

    video_name: str
    video_len: int
    video_wh: tuple[int, int]
    traj_cat_ids: np.ndarray      # (N,)  int64
    traj_durations: np.ndarray    # (N,2) int64, closed
    traj_boxes: np.ndarray        # (N, Fmax, 4) float32, padded
    traj_n_frames: np.ndarray     # (N,)  int64
    pred_cat_ids: np.ndarray      # (P,)  int64
    pred_durations: np.ndarray    # (P,2) float32, closed
    adj: np.ndarray               # (2, P, N) float32, one-hot rows

    @property
    def num_trajs(self) -> int:
        return len(self.traj_cat_ids)

    @property
    def num_preds(self) -> int:
        return len(self.pred_cat_ids)


def _spans_overlap(a: tuple[int, int], b) -> bool:
    """Half-open [s, e) overlap; touching boundaries do not intersect
    (utils_func.is_overlap, :637-648)."""
    return not (a[1] <= b[0] or b[1] <= a[0])


def build_video_graph(anno: dict, video_name: str,
                      cat_name_to_id: dict[str, int],
                      pred_name_to_id: dict[str, int],
                      split: str = "train",
                      max_preds: int = 100) -> VideoGraph:
    """Build the GT graph from one annotation JSON dict
    (dataloader_vidvrd.py:_get_gt_graph, :327-455).

    1. Assemble per-tid trajectories from the frame-level annotations and
       densify gaps by linear interpolation (:345-371).
    2. Merge each (subject_tid, predicate, object_tid) trituple's
       annotated segments into maximal spans (:389-420; VidVRD annotates
       long relations as overlapping 30-frame pieces).
    3. One-hot subject/object adjacency rows, with the reference's
       row-sum==1 invariant asserted (:426-448).
    4. Closed-interval conversion and train-split clipping to max_preds
       (:102-117).
    """
    video_len = len(anno["trajectories"])
    video_wh = (anno["width"], anno["height"])

    tid2cat = {t["tid"]: t["category"] for t in anno["subject/objects"]}
    frames: dict[int, list[list[float]]] = {tid: [] for tid in tid2cat}
    fids: dict[int, list[int]] = {tid: [] for tid in tid2cat}
    for frame_id, frame_anno in enumerate(anno["trajectories"]):
        for b in frame_anno:
            bb = b["bbox"]
            frames[b["tid"]].append([bb["xmin"], bb["ymin"],
                                     bb["xmax"], bb["ymax"]])
            fids[b["tid"]].append(frame_id)

    tid2idx: dict[int, int] = {}
    cat_ids, durations, boxes_list = [], [], []
    for idx, tid in enumerate(tid2cat):
        tid2idx[tid] = idx
        ids = np.asarray(fids[tid], np.int64)
        _, dense = linear_interpolate_boxes(
            ids, np.asarray(frames[tid], np.float32))
        cat_ids.append(cat_name_to_id[tid2cat[tid]])
        durations.append((int(ids[0]), int(ids[-1]) + 1))  # half-open
        boxes_list.append(dense)
    n = len(cat_ids)

    # relation merging, preserving first-appearance trituple order
    # (defaultdict insertion order drives the MAX_PREDS clipping order)
    tri_durations: dict[tuple[int, str, int], list[tuple[int, int]]] = {}
    for rel in anno["relation_instances"]:
        key = (rel["subject_tid"], rel["predicate"], rel["object_tid"])
        tri_durations.setdefault(key, []).append(
            (rel["begin_fid"], rel["end_fid"]))

    pred_cat_ids, pred_durations, pred_so = [], [], []
    for (stid, pred_name, otid), spans in tri_durations.items():
        for span in merge_durations(spans):
            pred_cat_ids.append(pred_name_to_id[pred_name])
            pred_durations.append(span)
            pred_so.append((tid2idx[stid], tid2idx[otid]))
    p = len(pred_cat_ids)

    adj = np.zeros((2, p, n), np.float32)
    for i, ((si, oi), span) in enumerate(zip(pred_so, pred_durations)):
        if _spans_overlap(span, durations[si]):
            adj[0, i, si] = 1.0
        if _spans_overlap(span, durations[oi]):
            adj[1, i, oi] = 1.0
    assert (adj.sum(axis=2) == 1.0).all(), \
        f"video {video_name}: predicate span outside its tracklet"

    traj_durations = np.asarray(durations, np.int64)
    traj_durations[:, 1] -= 1                      # closed interval
    pred_dur = np.asarray(pred_durations, np.float32).reshape(p, 2)
    pred_dur[:, 1] -= 1.0

    if split == "train" and p > max_preds:
        pred_cat_ids = pred_cat_ids[:max_preds]
        pred_dur = pred_dur[:max_preds]
        adj = adj[:, :max_preds, :]

    fmax = max((b.shape[0] for b in boxes_list), default=0)
    traj_boxes = np.zeros((n, fmax, 4), np.float32)
    n_frames = np.zeros((n,), np.int64)
    for i, b in enumerate(boxes_list):
        traj_boxes[i, :b.shape[0]] = b
        n_frames[i] = b.shape[0]

    return VideoGraph(
        video_name=video_name, video_len=video_len, video_wh=video_wh,
        traj_cat_ids=np.asarray(cat_ids, np.int64),
        traj_durations=traj_durations, traj_boxes=traj_boxes,
        traj_n_frames=n_frames,
        pred_cat_ids=np.asarray(pred_cat_ids, np.int64),
        pred_durations=pred_dur, adj=adj)
