# Copy of vrdone_tpu/eval/metrics.py, kept so that the port imports nothing of
# vrdone_tpu; tests/test_torch_copies.py pins it to the original.
"""Relation-detection scoring (fresh reimplementation of the external
VidVRD-helper protocol the reference depends on).

The reference clones github.com/xdshang/VidVRD-helper at runtime and calls
its eval_detection_scores / eval_tagging_scores / voc_ap (reference
utils/evaluate.py:7-8). That helper is not part of the reference snapshot,
so the protocol is reimplemented here from its published definition:

  * vIoU: voluminal IoU of two boxed trajectories over their temporal
    union, with the legacy +1 box extent convention,
  * detection: score-descending greedy matching of predicted triplets to
    unmatched GT of the same (subject, predicate, object) with
    min(subject vIoU, object vIoU) >= threshold,
  * tagging: triplet-level (localization-free) precision at k,
  * voc_ap: continuous (non-07) VOC average precision.

Prediction / GT record format (same JSON schema as the helper):
  {"triplet": [s_name, p_name, o_name], "duration": [fstart, fend),
   "score": float, "sub_traj": [[x1,y1,x2,y2], ...], "obj_traj": [...]}
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def traj_iou_volume(traj: np.ndarray) -> np.ndarray:
    """Per-frame (x2-x1+1)*(y2-y1+1) volumes."""
    traj = np.asarray(traj, dtype=np.float64)
    return (traj[:, 2] - traj[:, 0] + 1) * (traj[:, 3] - traj[:, 1] + 1)


def viou(traj_1, duration_1, traj_2, duration_2) -> float:
    """Voluminal IoU of two trajectories.

    Each trajectory is a per-frame box list covering [fstart, fend). The
    denominator uses the *volumes of both full trajectories* (not only the
    temporal overlap), so temporally-disjoint predictions score 0 and
    partial overlaps are penalised by the non-overlapping volume.
    """
    if duration_1[0] >= duration_2[1] or duration_1[1] <= duration_2[0]:
        return 0.0
    t1 = np.asarray(traj_1, dtype=np.float64)
    t2 = np.asarray(traj_2, dtype=np.float64)
    start = max(duration_1[0], duration_2[0])
    end = min(duration_1[1], duration_2[1])
    o1 = t1[start - duration_1[0]:end - duration_1[0]]
    o2 = t2[start - duration_2[0]:end - duration_2[0]]
    lt = np.maximum(o1[:, :2], o2[:, :2])
    rb = np.minimum(o1[:, 2:], o2[:, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    v_overlap = float((wh[:, 0] * wh[:, 1]).sum())
    v1 = float(traj_iou_volume(t1).sum())
    v2 = float(traj_iou_volume(t2).sum())
    return v_overlap / (v1 + v2 - v_overlap)


def eval_detection_scores(gt_relations, pred_relations, viou_threshold):
    """Greedy detection matching; returns (precision, recall, hit_scores)
    over score-descending predictions (hit_scores is -inf for FPs)."""
    pred_relations = sorted(pred_relations, key=lambda x: x["score"],
                            reverse=True)
    gt_detected = np.zeros(len(gt_relations), dtype=bool)
    hit_scores = np.full(len(pred_relations), -np.inf)
    for pred_idx, pred in enumerate(pred_relations):
        ov_max = -np.inf
        k_max = -1
        pt = tuple(pred["triplet"])
        for gt_idx, gt in enumerate(gt_relations):
            if gt_detected[gt_idx] or pt != tuple(gt["triplet"]):
                continue
            s_iou = viou(pred["sub_traj"], pred["duration"],
                         gt["sub_traj"], gt["duration"])
            o_iou = viou(pred["obj_traj"], pred["duration"],
                         gt["obj_traj"], gt["duration"])
            ov = min(s_iou, o_iou)
            if ov >= viou_threshold and ov > ov_max:
                ov_max = ov
                k_max = gt_idx
        if k_max >= 0:
            hit_scores[pred_idx] = pred["score"]
            gt_detected[k_max] = True
    tp = np.isfinite(hit_scores)
    cum_tp = np.cumsum(tp).astype(np.float64)
    cum_fp = np.cumsum(~tp).astype(np.float64)
    eps = np.finfo(np.float32).eps
    rec = cum_tp / max(len(gt_relations), eps)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, eps)
    return prec, rec, hit_scores


def eval_tagging_scores(gt_relations, pred_relations):
    """Triplet-tagging precision/recall (localization ignored, first
    occurrence of each predicted triplet kept)."""
    pred_relations = sorted(pred_relations, key=lambda x: x["score"],
                            reverse=True)
    gt_triplets = {tuple(r["triplet"]) for r in gt_relations}
    pred_triplets, hit_scores = [], []
    for r in pred_relations:
        t = tuple(r["triplet"])
        if t not in pred_triplets:
            pred_triplets.append(t)
            hit_scores.append(r["score"])
    hit_scores = np.asarray(hit_scores, dtype=np.float64)
    for i, t in enumerate(pred_triplets):
        if t not in gt_triplets:
            hit_scores[i] = -np.inf
    tp = np.isfinite(hit_scores)
    cum_tp = np.cumsum(tp).astype(np.float64)
    cum_fp = np.cumsum(~tp).astype(np.float64)
    eps = np.finfo(np.float32).eps
    rec = cum_tp / max(len(gt_triplets), eps)
    prec = cum_tp / np.maximum(cum_tp + cum_fp, eps)
    return prec, rec, hit_scores


def voc_ap(rec: np.ndarray, prec: np.ndarray) -> float:
    """Continuous VOC average precision."""
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def eval_visual_relation(groundtruth: dict, prediction: dict,
                         viou_threshold: float = 0.5,
                         det_nreturns=(50, 100), tag_nreturns=(1, 5, 10)):
    """Corpus-level scoring (mirrors reference utils/evaluate.py:77-126):
    per-video detection AP (voc_ap), corpus recall@{50,100} from the
    concatenated score-sorted hits, tagging precision@{1,5,10}."""
    video_ap = {}
    tot_scores = defaultdict(list)
    tot_tp = defaultdict(list)
    prec_at_n = defaultdict(list)
    tot_gt_relations = 0
    for vid, gt_relations in groundtruth.items():
        if len(gt_relations) == 0:
            continue
        tot_gt_relations += len(gt_relations)
        predict_relations = prediction.get(vid, [])
        det_prec, det_rec, det_scores = eval_detection_scores(
            gt_relations, predict_relations, viou_threshold)
        video_ap[vid] = voc_ap(det_rec, det_prec)
        tp = np.isfinite(det_scores)
        for nre in det_nreturns:
            cut_off = min(nre, det_scores.size)
            tot_scores[nre].append(det_scores[:cut_off])
            tot_tp[nre].append(tp[:cut_off])
        tag_prec, _, _ = eval_tagging_scores(gt_relations, predict_relations)
        for nre in tag_nreturns:
            cut_off = min(nre, tag_prec.size)
            prec_at_n[nre].append(tag_prec[cut_off - 1] if cut_off > 0
                                  else 0.0)
    mean_ap = float(np.mean(list(video_ap.values())))
    rec_at_n = {}
    for nre in det_nreturns:
        scores = np.concatenate(tot_scores[nre])
        tps = np.concatenate(tot_tp[nre])
        order = np.argsort(scores)[::-1]
        tps = tps[order]
        cum_tp = np.cumsum(tps).astype(np.float64)
        rec = cum_tp / max(tot_gt_relations, np.finfo(np.float32).eps)
        rec_at_n[nre] = float(rec[-1]) if rec.size else 0.0
    mprec_at_n = {nre: float(np.mean(prec_at_n[nre]))
                  for nre in tag_nreturns}
    return mean_ap, rec_at_n, mprec_at_n


def relation_metrics(groundtruth: dict, prediction: dict,
                     viou_threshold: float = 0.5) -> dict:
    """Metric dict with the reference's logged keys (eval.py:106-109)."""
    mean_ap, rec_at_n, mprec_at_n = eval_visual_relation(
        groundtruth, prediction, viou_threshold)
    out = {"RelDet_mAP": mean_ap}
    out.update({f"RelDet_AR@{k}": v for k, v in rec_at_n.items()})
    out.update({f"RelTag_AP@{k}": v for k, v in mprec_at_n.items()})
    return out
