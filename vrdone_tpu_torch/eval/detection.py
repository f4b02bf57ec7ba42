"""Detector evaluation: VID-protocol per-class AP with motion-IoU buckets,
proposal recall, and COCO-style AP@[.5:.95] (counterpart of
``vrdone_tpu/eval/detection.py``).

Copy of the numpy metrics of ``vrdone_tpu/eval/detection.py``
(``iou_matrix``, ``compute_motion_ious``, ``MOTION_RANGES``,
``calc_vid_prec_rec``, ``calc_vid_ap``, ``eval_detection_vid``,
``eval_proposal_recall`` and ``eval_detection_coco``), kept so that the port
imports nothing of the JAX package; ``tests/test_torch_copies.py`` holds
each function's source to the original's and their outputs to its outputs.
``evaluate_video_detections`` runs the port's ``detect_video`` and
``postprocess_frame``.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, maskrcnn-benchmark +1 convention. a: (N,4), b: (M,4)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter)


def compute_motion_ious(trajectories: list, window: int = 10) -> list:
    """Per-frame, per-GT-box motion IoU from annotation trajectories.

    trajectories: the per-frame annotation lists ({"tid", "bbox"} dicts,
    the VidVRD/VidOR JSON schema). Motion IoU of a box = mean IoU between
    it and the same tid's boxes within +-window frames (the FGFA/VID
    "motion speed" statistic the reference ships as a .mat). Returns
    list (per frame) of float arrays aligned with the frame's boxes.
    """
    by_tid: dict[int, dict[int, np.ndarray]] = defaultdict(dict)
    for fid, frame in enumerate(trajectories):
        for box in frame:
            bb = box["bbox"]
            by_tid[box["tid"]][fid] = np.asarray(
                [bb["xmin"], bb["ymin"], bb["xmax"], bb["ymax"]],
                np.float64)
    out = []
    for fid, frame in enumerate(trajectories):
        vals = []
        for box in frame:
            track = by_tid[box["tid"]]
            cur = track[fid]
            ious = []
            for off in range(-window, window + 1):
                if off == 0 or (fid + off) not in track:
                    continue
                ious.append(iou_matrix(cur[None], track[fid + off][None])
                            [0, 0])
            vals.append(float(np.mean(ious)) if ious else 1.0)
        out.append(np.asarray(vals, np.float64))
    return out


MOTION_RANGES = {"all": (0.0, 1.0), "fast": (0.0, 0.7),
                 "medium": (0.7, 0.9), "slow": (0.9, 1.0)}


def calc_vid_prec_rec(gts: list[dict], preds: list[dict], *,
                      iou_thresh: float = 0.5,
                      motion_ious: list | None = None,
                      motion_range=(0.0, 1.0)):
    """Per-class precision/recall curves (vid_eval.py:158-286).

    gts[i]: {"boxes": (G,4), "labels": (G,)}; preds[i]: {"boxes",
    "labels", "scores"}. motion_ious[i]: (G,) float per GT box or None.
    Returns ({label: prec array}, {label: rec array or None}).
    """
    n_pos: dict[int, float] = defaultdict(float)
    score: dict[int, list] = defaultdict(list)
    match: dict[int, list] = defaultdict(list)
    pred_ignore: dict[int, list] = defaultdict(list)

    if motion_ious is None:
        empty_weight = 0.0
        motion_list = [None] * len(gts)
    else:
        all_m = np.concatenate([m for m in motion_ious]) if motion_ious \
            else np.zeros(0)
        if len(all_m):
            inside = (all_m >= motion_range[0]) & (all_m <= motion_range[1])
            empty_weight = float(inside.sum()) / float(len(all_m))
        else:
            empty_weight = 0.0
        if empty_weight == 1.0:
            empty_weight = 0.0
        motion_list = motion_ious

    for gt, pred, miou in zip(gts, preds, motion_list):
        gt_bbox = np.asarray(gt["boxes"], np.float64)
        gt_label = np.asarray(gt["labels"], int)
        pred_bbox = np.asarray(pred["boxes"], np.float64)
        pred_label = np.asarray(pred["labels"], int)
        pred_score = np.asarray(pred["scores"], np.float64)

        gt_ignore = np.zeros(len(gt_bbox))
        if miou is not None and len(miou):
            gt_ignore = ((miou < motion_range[0])
                         | (miou > motion_range[1])).astype(float)

        for lbl in np.unique(np.concatenate((pred_label, gt_label))
                             .astype(int)):
            pm = pred_label == lbl
            pb, ps = pred_bbox[pm], pred_score[pm]
            order = ps.argsort()[::-1]
            pb, ps = pb[order], ps[order]

            gm = gt_label == lbl
            gb, gi = gt_bbox[gm], gt_ignore[gm]

            n_pos[lbl] += gb.shape[0] - gi.sum()
            score[lbl].extend(ps)
            if len(pb) == 0:
                continue
            if len(gb) == 0:
                match[lbl].extend((0,) * pb.shape[0])
                pred_ignore[lbl].extend((empty_weight,) * pb.shape[0])
                continue

            # VID evaluation follows integer typed bounding boxes
            pbi = pb.copy()
            pbi[:, 2:] += 1
            gbi = gb.copy()
            gbi[:, 2:] += 1
            iou = iou_matrix(pbi, gbi)

            selec = np.zeros(gb.shape[0], bool)
            for j in range(iou.shape[0]):
                iou_match = iou_thresh
                iou_match_ig = -1.0
                iou_match_nig = -1.0
                arg_match = -1
                for k in range(iou.shape[1]):
                    if gi[k] == 1 and iou[j, k] > iou_match_ig:
                        iou_match_ig = iou[j, k]
                    if gi[k] == 0 and iou[j, k] > iou_match_nig:
                        iou_match_nig = iou[j, k]
                    if selec[k] or iou[j, k] < iou_match:
                        continue
                    if iou[j, k] == iou_match:
                        # at a tie prefer a non-ignored GT
                        if arg_match < 0 or gi[arg_match]:
                            arg_match = k
                    else:
                        arg_match = k
                    iou_match = iou[j, k]
                if arg_match >= 0:
                    match[lbl].append(1)
                    pred_ignore[lbl].append(gi[arg_match])
                    selec[arg_match] = True
                else:
                    if iou_match_nig > iou_match_ig:
                        pred_ignore[lbl].append(0)
                    elif iou_match_ig > iou_match_nig:
                        pred_ignore[lbl].append(1)
                    else:
                        pred_ignore[lbl].append(gi.sum() / float(len(gi)))
                    match[lbl].append(0)

    prec: dict[int, np.ndarray] = {}
    rec: dict[int, np.ndarray | None] = {}
    for lbl in n_pos.keys():
        score_l = np.asarray(score[lbl])
        match_l = np.asarray(match[lbl], np.int8)
        ig_l = np.asarray(pred_ignore[lbl], np.float64)
        order = score_l.argsort()[::-1]
        match_l, ig_l = match_l[order], ig_l[order]

        tps = np.logical_and(match_l == 1, ig_l != 1)
        fps = np.logical_and(match_l == 0, ig_l != 1).astype(np.float64)
        # partial-ignore reweighting of false positives (vid_eval.py:272)
        ig_l = ig_l.copy()
        ig_l[ig_l == 0] = 1
        fps = fps * ig_l

        tp = np.cumsum(tps)
        fp = np.cumsum(fps)
        prec[lbl] = tp / (fp + tp + np.spacing(1))
        rec[lbl] = tp / n_pos[lbl] if n_pos[lbl] > 0 else None
    return prec, rec


def calc_vid_ap(prec: dict, rec: dict, use_07_metric: bool = False) -> dict:
    """Per-class AP from precision/recall (vid_eval.py:288-343)."""
    ap = {}
    for lbl in prec:
        if rec.get(lbl) is None:
            ap[lbl] = np.nan
            continue
        if use_07_metric:
            val = 0.0
            for t in np.arange(0.0, 1.1, 0.1):
                if np.sum(rec[lbl] >= t) == 0:
                    p = 0.0
                else:
                    p = np.max(np.nan_to_num(prec[lbl])[rec[lbl] >= t])
                val += p / 11
            ap[lbl] = val
        else:
            mpre = np.concatenate(([0], np.nan_to_num(prec[lbl]), [0]))
            mrec = np.concatenate(([0], rec[lbl], [1]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            idx = np.where(mrec[1:] != mrec[:-1])[0]
            ap[lbl] = float(np.sum((mrec[idx + 1] - mrec[idx])
                                   * mpre[idx + 1]))
    return ap


def eval_detection_vid(gts: list[dict], preds: list[dict], *,
                       iou_thresh: float = 0.5,
                       motion_ious: list | None = None,
                       use_07_metric: bool = False) -> dict:
    """Full VID evaluation. Returns {bucket: {"ap": {label: ap},
    "map": float}}; buckets are motion ranges when motion_ious given,
    else only "all"."""
    buckets = MOTION_RANGES if motion_ious is not None else \
        {"all": (0.0, 1.0)}
    out = {}
    for name, rng in buckets.items():
        prec, rec = calc_vid_prec_rec(
            gts, preds, iou_thresh=iou_thresh, motion_ious=motion_ious,
            motion_range=rng)
        ap = calc_vid_ap(prec, rec, use_07_metric=use_07_metric)
        vals = [v for v in ap.values()]
        out[name] = {"ap": ap,
                     "map": float(np.nanmean(vals)) if vals else np.nan}
    return out


def eval_proposal_recall(gts: list[dict], preds: list[dict], *,
                         iou_thresh: float = 0.5, limit: int = 300
                         ) -> float:
    """Class-agnostic proposal recall (vid_eval.py:72-119): greedy
    best-first matching of proposals to GT, recall = matched GT /
    total GT. preds[i]["scores"] orders the proposals."""
    overlaps_all = []
    num_pos = 0
    for gt, pred in zip(gts, preds):
        gb = np.asarray(gt["boxes"], np.float64)
        pb = np.asarray(pred["boxes"], np.float64)
        ps = np.asarray(pred["scores"], np.float64)
        order = ps.argsort()[::-1][:limit]
        pb = pb[order]
        num_pos += len(gb)
        if len(gb) == 0 or len(pb) == 0:
            continue
        overlaps = iou_matrix(pb, gb)
        got = np.zeros(len(gb))
        for j in range(min(len(pb), len(gb))):
            best_per_gt = overlaps.max(axis=0)
            gt_ind = best_per_gt.argmax()
            box_ind = overlaps[:, gt_ind].argmax()
            got[j] = overlaps[box_ind, gt_ind]
            overlaps[box_ind, :] = -1
            overlaps[:, gt_ind] = -1
        overlaps_all.append(got)
    if num_pos == 0:
        return 0.0
    all_ov = np.concatenate(overlaps_all) if overlaps_all else np.zeros(0)
    return float((all_ov >= iou_thresh).sum() / num_pos)


def eval_detection_coco(gts: list[dict], preds: list[dict], *,
                        iou_thresholds=None) -> dict:
    """COCO-style AP averaged over IoU 0.5:0.95 (the reference wraps
    pycocotools for its COCO pre-train eval, coco_eval.py; same protocol
    reimplemented: per-class, score-ordered greedy matching at each IoU
    threshold, 101-point interpolated AP)."""
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)
    labels = sorted({int(l) for g in gts
                     for l in np.asarray(g["labels"]).tolist()})
    recall_pts = np.linspace(0, 1, 101)
    ap_per_thresh = {}
    for thr in iou_thresholds:
        aps = []
        for lbl in labels:
            scores, matches = [], []
            npos = 0
            for gt, pred in zip(gts, preds):
                gb = np.asarray(gt["boxes"], np.float64)
                gl = np.asarray(gt["labels"], int)
                gb = gb[gl == lbl]
                npos += len(gb)
                pb = np.asarray(pred["boxes"], np.float64)
                pl = np.asarray(pred["labels"], int)
                ps = np.asarray(pred["scores"], np.float64)
                sel = pl == lbl
                pb, ps = pb[sel], ps[sel]
                order = ps.argsort()[::-1]
                pb, ps = pb[order], ps[order]
                # COCO IoU has no +1 convention
                if len(pb) and len(gb):
                    a2 = (pb[:, 2] - pb[:, 0]) * (pb[:, 3] - pb[:, 1])
                    b2 = (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
                    lt = np.maximum(pb[:, None, :2], gb[None, :, :2])
                    rb = np.minimum(pb[:, None, 2:], gb[None, :, 2:])
                    wh = np.clip(rb - lt, 0, None)
                    inter = wh[..., 0] * wh[..., 1]
                    iou = inter / (a2[:, None] + b2[None, :] - inter)
                else:
                    iou = np.zeros((len(pb), len(gb)))
                used = np.zeros(len(gb), bool)
                for j in range(len(pb)):
                    scores.append(ps[j])
                    best, bk = thr, -1
                    for k in range(len(gb)):
                        if used[k] or iou[j, k] < best:
                            continue
                        best, bk = iou[j, k], k
                    if bk >= 0:
                        used[bk] = True
                        matches.append(1)
                    else:
                        matches.append(0)
            if npos == 0:
                continue
            scores = np.asarray(scores)
            matches = np.asarray(matches)
            order = scores.argsort()[::-1]
            tp = np.cumsum(matches[order] == 1)
            fp = np.cumsum(matches[order] == 0)
            prec = tp / np.maximum(tp + fp, 1)
            rec = tp / npos
            # 101-point interpolation
            mpre = np.concatenate(([0], prec, [0]))
            mpre = np.maximum.accumulate(mpre[::-1])[::-1]
            mrec = np.concatenate(([0], rec))
            interp = np.zeros_like(recall_pts)
            for i, r in enumerate(recall_pts):
                idx = np.searchsorted(mrec, r, side="left")
                interp[i] = mpre[idx] if idx < len(mpre) else 0.0
            aps.append(float(interp.mean()))
        ap_per_thresh[round(float(thr), 2)] = (
            float(np.mean(aps)) if aps else np.nan)
    vals = [v for v in ap_per_thresh.values() if not np.isnan(v)]
    return {"AP": float(np.mean(vals)) if vals else np.nan,
            "AP50": ap_per_thresh.get(0.5, np.nan),
            "AP75": ap_per_thresh.get(0.75, np.nan),
            "per_thresh": ap_per_thresh}


def evaluate_video_detections(det, anno_dir: str, frames_dir: str, *,
                              name_to_id: dict, min_size: int = 600,
                              canvas=(608, 1088), max_videos: int = 5,
                              score_thresh: float = 0.05,
                              motion_specific: bool = True,
                              detect_fn=None) -> dict:
    """Run the detector over validation videos and compute VID mAP, the
    JAX package's periodic validation of detector training: each video's
    annotated frames, resized so the short side is ``min_size`` and pasted
    on a ``canvas`` of zeros, through ``detect_fn(det, images, image_hw)``
    (the port's ``detect_video`` by default) and ``postprocess_frame``.
    Returns {"mAP": ...} and, when motion_specific, "mAP_fast",
    "mAP_medium" and "mAP_slow"."""
    import json
    import os

    from ..models.detector import detect_video, postprocess_frame

    if detect_fn is None:
        detect_fn = detect_video

    gts, preds, motion = [], [], []
    videos = sorted(v[:-5] for v in os.listdir(anno_dir)
                    if v.endswith(".json"))[:max_videos]
    ch, cw = canvas
    for video in videos:
        with open(os.path.join(anno_dir, video + ".json")) as f:
            anno = json.load(f)
        tid_to_cat = {so["tid"]: so["category"]
                      for so in anno["subject/objects"]}
        trajectories = anno["trajectories"]
        fids = [f for f in range(len(trajectories)) if trajectories[f]]
        if not fids:
            continue
        mious = compute_motion_ious(trajectories)

        from PIL import Image
        imgs, scales = [], []
        for fid in fids:
            path = os.path.join(frames_dir, video, f"{fid + 1:06d}.jpg")
            img = np.asarray(Image.open(path), np.float32)[..., ::-1]
            h, w = img.shape[:2]
            s = min_size / min(h, w)
            nh, nw = int(round(h * s)), int(round(w * s))
            im = Image.fromarray(img.astype(np.uint8)[..., ::-1]).resize(
                (nw, nh))
            img_r = np.asarray(im, np.float32)[..., ::-1]
            cv = np.zeros((ch, cw, 3), np.float32)
            cv[:min(nh, ch), :min(nw, cw)] = img_r[:ch, :cw]
            imgs.append(cv)
            scales.append(s)
        out = detect_fn(det, np.stack(imgs), np.asarray(canvas, np.float32))
        for i, fid in enumerate(fids):
            res = postprocess_frame(
                out["proposals"][i], out["cls_logits"][i],
                out["bbox_deltas"][i], out["valid"][i], canvas,
                score_thresh=score_thresh)
            preds.append({"boxes": res["boxes"] / scales[i],
                          "scores": res["scores"],
                          "labels": res["labels"]})
            frame = trajectories[fid]
            boxes = np.asarray([[b["bbox"]["xmin"], b["bbox"]["ymin"],
                                 b["bbox"]["xmax"], b["bbox"]["ymax"]]
                                for b in frame], np.float64)
            labels = np.asarray([name_to_id[tid_to_cat[b["tid"]]]
                                 for b in frame], int)
            gts.append({"boxes": boxes, "labels": labels})
            motion.append(mious[fid])

    result = eval_detection_vid(
        gts, preds, motion_ious=motion if motion_specific else None)
    stats = {"mAP": result["all"]["map"]}
    if motion_specific:
        for k in ("fast", "medium", "slow"):
            stats[f"mAP_{k}"] = result[k]["map"]
    return stats
