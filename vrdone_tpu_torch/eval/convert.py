# Copy of vrdone_tpu/eval/convert.py, kept so that the port imports nothing of
# vrdone_tpu; tests/test_torch_copies.py pins it to the original.
"""Prediction/GT format conversion to the helper-compatible JSON schema."""

from __future__ import annotations

import json
import os

from ..data.category import get_vocab


def reset_video_name(dataset: str, video_name: str) -> str:
    """VidOR video names are '<group>_<id>'; scoring uses the bare id
    (reference utils/evaluate.py:25-36)."""
    if dataset.lower() == "vidor":
        parts = video_name.split("_")
        assert len(parts) == 2
        return parts[1]
    return video_name


def to_eval_format(dataset: str, video_name: str,
                   pr_triplet: dict | None) -> dict:
    """Decoded triplets -> helper-format records
    (reference utils/evaluate.py:38-73)."""
    entity_id_to_name, pred_id_to_name = get_vocab(dataset)
    video_name = reset_video_name(dataset, video_name)
    if pr_triplet is None:
        return {video_name: []}
    results = []
    for p_id in range(len(pr_triplet["triplets"])):
        s_id, p_id_cat, o_id = pr_triplet["triplets"][p_id]
        dura = (int(pr_triplet["pred_durations"][p_id][0]),
                int(pr_triplet["pred_durations"][p_id][1]))
        sub_traj = pr_triplet["so_trajs"][p_id][0]
        obj_traj = pr_triplet["so_trajs"][p_id][1]
        assert len(sub_traj) == len(obj_traj) == dura[1] - dura[0]
        results.append({
            "triplet": [entity_id_to_name[s_id], pred_id_to_name[p_id_cat],
                        entity_id_to_name[o_id]],
            "duration": dura,
            "score": float(pr_triplet["triple_scores_avg"][p_id]),
            "sub_traj": sub_traj,
            "obj_traj": obj_traj,
        })
    return {video_name: results}


def _traj_for_tid(trajectories, tid: int, begin: int, end: int) -> list:
    boxes = []
    for frame in trajectories[begin:end]:
        for t in frame:
            if t["tid"] == tid:
                bb = t["bbox"]
                boxes.append([bb["xmin"], bb["ymin"], bb["xmax"], bb["ymax"]])
    assert len(boxes) == end - begin
    return boxes


def build_groundtruth(ann_dir: str, split: str, dataset: str,
                      video_names=None) -> dict:
    """Ground-truth JSON in helper format, straight from annotation files
    (replaces the reference's VidVRD_helper get_relation_insts round trip,
    utils/prepare_eval_labels.py)."""
    split_dir = os.path.join(ann_dir, split)
    gts = {}
    if dataset.lower() == "vidor":
        files = []
        for group in sorted(os.listdir(split_dir)):
            for v in sorted(os.listdir(os.path.join(split_dir, group))):
                files.append((group + "_" + v.split(".")[0],
                              os.path.join(split_dir, group, v)))
    else:
        files = [(v.split(".")[0], os.path.join(split_dir, v))
                 for v in sorted(os.listdir(split_dir))]
    names = set(video_names) if video_names is not None else None
    for video_name, path in files:
        if names is not None and video_name not in names:
            continue
        with open(path) as f:
            anno = json.load(f)
        tid_to_cat = {so["tid"]: so["category"]
                      for so in anno["subject/objects"]}
        insts = []
        for rel in anno["relation_instances"]:
            b, e = rel["begin_fid"], rel["end_fid"]
            insts.append({
                "triplet": [tid_to_cat[rel["subject_tid"]],
                            rel["predicate"],
                            tid_to_cat[rel["object_tid"]]],
                "subject_tid": rel["subject_tid"],
                "object_tid": rel["object_tid"],
                "duration": [b, e],
                "sub_traj": _traj_for_tid(anno["trajectories"],
                                          rel["subject_tid"], b, e),
                "obj_traj": _traj_for_tid(anno["trajectories"],
                                          rel["object_tid"], b, e),
            })
        gts[reset_video_name(dataset, video_name)] = insts
    return gts
