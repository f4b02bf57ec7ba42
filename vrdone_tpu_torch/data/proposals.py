"""Proposal-tracklet utilities: the per-video ``{"traj_proposal": ...}``
dict the eval dataloaders read, from raw tracklets, and the rebuild and
repackaging of BIG's released tracklet files.

Copy of every function of ``vrdone_tpu/data/proposals.py``
(``linear_interpolate_boxes``, ``merge_durations``, ``build_traj_proposal``,
``linear_interpolate_columns``, ``parse_raw_track_file``,
``rebuild_raw_proposal``, ``rebuild_vidvrd_proposals`` and
``repackage_monolithic_pickle``), kept so that the port imports nothing of
the JAX package; ``tests/test_torch_copies.py`` holds each function's source
to the original's. ``rebuild_vidvrd_proposals`` reads the port's own
``data/category.py`` and ``data/graph.py``.
"""

from __future__ import annotations

import os
import pickle

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


def linear_interpolate_columns(frame_ids: np.ndarray,
                               vectors: np.ndarray) -> np.ndarray:
    """Densify a gappy per-frame vector sequence by per-column linear
    interpolation (utils_func.linear_interpolation :292-317 — its
    per-gap np.linspace equals np.interp between segment boundaries; the
    fill_zeropadding call there is a behavioural no-op on 1-D boundary
    vectors, see the golden test). frame_ids must be strictly
    increasing."""
    frame_ids = np.asarray(frame_ids, np.int64)
    assert (np.diff(frame_ids) > 0).all(), "frame ids must be sorted/unique"
    vectors = np.asarray(vectors)
    dense_ids = np.arange(int(frame_ids[0]), int(frame_ids[-1]) + 1)
    out = np.empty((len(dense_ids), vectors.shape[1]), vectors.dtype)
    for d in range(vectors.shape[1]):
        out[:, d] = np.interp(dense_ids, frame_ids, vectors[:, d])
    return out


def parse_raw_track_file(track_res, dim_boxfeature: int = 1024) -> dict:
    """Group raw per-frame tracker rows by tid (reference
    prepare_vidvrd_proposal.py:80-134).

    Rows are length 6 ([frame_id, tid, tracker xywh]) or
    12+dim_boxfeature ([frame_id, tid, tracker xywh, confidence, cat_id,
    detector xywh, roi_feature]). Long rows contribute the elementwise
    mean of the tracker and detector boxes (xyxy) plus the detection
    confidence and a category vote; short rows contribute the tracker
    box with confidence 0 and a zero feature. Returns {tid: {frame_ids,
    bboxes (n,5 with score col), roi_features (n,D), category_votes}}
    in first-seen tid order."""
    trajs: dict = {}
    for row in track_res:
        row = row.tolist() if not isinstance(row, list) else row
        assert len(row) in (6, 12 + dim_boxfeature), len(row)
        tid = row[1]
        t = trajs.setdefault(tid, {"frame_ids": [], "bboxes": [],
                                   "roi_features": [],
                                   "category_votes": []})
        x_t, y_t, w_t, h_t = row[2:6]
        box_t = [x_t, y_t, x_t + w_t, y_t + h_t]
        if len(row) == 6:
            t["bboxes"].append(box_t + [0.0])
            t["roi_features"].append([0.0] * dim_boxfeature)
        else:
            conf, cat_id = row[6], row[7]
            x, y, w, h = row[8:12]
            box_d = [x, y, x + w, y + h]
            t["bboxes"].append([(a + b) / 2 for a, b in zip(box_d, box_t)]
                               + [conf])
            t["roi_features"].append(row[12:])
            t["category_votes"].append(int(cat_id))
        t["frame_ids"].append(int(row[0]))
    return trajs


def rebuild_raw_proposal(video_name: str, track_res, *,
                         dim_boxfeature: int = 1024,
                         min_frames_th: int = 5,
                         max_proposal: int = 50) -> dict:
    """Rebuild a TrajProposal dict from raw per-frame tracker output
    (reference prepare_vidvrd_proposal.py _get_proposal :79-190 +
    TrajProposal.__init__, dataloader_vidvrd.py:14-52).

    Per tid: majority-vote category (np.bincount argmax; no votes or
    fewer than min_frames_th frames -> background, dropped), gaps
    densified by linear interpolation of the score-carrying boxes AND
    the roi features, durations closed [min_fid, max_fid], per-proposal
    score = mean of the (interpolated) per-frame confidences, proposals
    sorted by score descending and clipped to max_proposal."""
    trajs = parse_raw_track_file(track_res, dim_boxfeature)

    cat_ids, scores, bboxes_list, durations, features_list = \
        [], [], [], [], []
    for tid, t in trajs.items():
        votes = t["category_votes"]
        cat = int(np.argmax(np.bincount(votes))) if votes else 0
        if len(t["frame_ids"]) < min_frames_th:
            cat = 0
        if cat == 0:
            continue
        fids = np.asarray(t["frame_ids"], np.int64)
        boxes5 = linear_interpolate_columns(
            fids, np.asarray(t["bboxes"], np.float64))
        feats = linear_interpolate_columns(
            fids, np.asarray(t["roi_features"], np.float64))
        cat_ids.append(cat)
        scores.append(float(boxes5[:, 4].mean()))
        bboxes_list.append(boxes5[:, :4].astype(np.float32))
        durations.append([int(fids[0]), int(fids[-1])])  # closed
        features_list.append(feats.astype(np.float32))

    if not cat_ids:
        return {"MAX_PROPOSAL": max_proposal, "video_name": video_name,
                "num_proposals": 0}

    order = np.argsort(-np.asarray(scores), kind="stable")[:max_proposal]
    return {
        "MAX_PROPOSAL": max_proposal,
        "video_name": video_name,
        "cat_ids": np.asarray(cat_ids, np.int64)[order],
        "scores": np.asarray(scores, np.float32)[order],
        "bboxes_list": [bboxes_list[i] for i in order],
        "traj_durations": np.asarray(durations, np.int64)[order],
        "features_list": [features_list[i] for i in order],
        "num_proposals": int(len(order)),
        "dim_feat": dim_boxfeature,
    }


def rebuild_vidvrd_proposals(proposal_dir: str, ann_dir: str,
                             save_dir: str, *, split: str = "test",
                             dim_boxfeature: int = 1024,
                             min_frames_th: int = 5,
                             max_proposal: int = 50,
                             max_preds: int = 100) -> int:
    """Rebuild the per-video {"traj_proposal", "gt_graph"} pickles from
    raw per-frame tracker .npy files + annotation JSONs (reference
    prepare_vidvrd_proposal.py VidVRD.__init__/get_data :12-77). The
    gt_graph entry holds our VideoGraph fields (data/graph.py — same
    information as the reference's VideoGraph.__dict__; our eval builds
    GT from the annotation JSONs directly, so it is stored for contract
    completeness). video_len/video_wh come from the annotation, as in
    the reference (:66-70)."""
    import json

    from .category import (vidvrd_category_name_to_id,
                           vidvrd_pred_name_to_id)
    from .graph import build_video_graph

    os.makedirs(save_dir, exist_ok=True)
    video_ann_dir = os.path.join(ann_dir, split)
    names = sorted(v.split(".")[0] for v in os.listdir(video_ann_dir))
    n = 0
    for name in names:
        dst = os.path.join(save_dir, name + ".pkl")
        if os.path.exists(dst):
            continue
        track_res = np.load(os.path.join(proposal_dir, name + ".npy"),
                            allow_pickle=True)
        proposal = rebuild_raw_proposal(
            name, track_res, dim_boxfeature=dim_boxfeature,
            min_frames_th=min_frames_th, max_proposal=max_proposal)
        with open(os.path.join(video_ann_dir, name + ".json")) as f:
            anno = json.load(f)
        graph = build_video_graph(anno, name, vidvrd_category_name_to_id,
                                  vidvrd_pred_name_to_id, split=split,
                                  max_preds=max_preds)
        proposal["video_len"] = graph.video_len
        proposal["video_wh"] = graph.video_wh
        with open(dst, "wb") as f:
            pickle.dump({"traj_proposal": proposal,
                         "gt_graph": dict(graph.__dict__)}, f)
        n += 1
    return n


def repackage_monolithic_pickle(src_path: str, out_dir: str) -> int:
    """Split a monolithic {video_name: TrajProposal-like} pickle into the
    per-video files the eval dataloader reads
    (reference prepare_vidor_proposal.py:16-27)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(src_path, "rb") as f:
        blob = pickle.load(f)
    n = 0
    for video_name, proposal in blob.items():
        if hasattr(proposal, "__dict__"):
            proposal = dict(proposal.__dict__)
        with open(os.path.join(out_dir, f"{video_name}.pkl"), "wb") as f:
            pickle.dump({"traj_proposal": proposal}, f)
        n += 1
    return n
