"""Per-frame proposal-box RoI features for relation-model evaluation, with
the PyTorch port (the counterpart of ``tools/extract_proposal_features.py``).

For each video's proposal pickle under ``--proposal_dir`` (the
``{"traj_proposal": {cat_ids, bboxes_list, traj_durations, ...}}`` layout of
BIG's repackaged files and of ``detect_torch.py``): the live proposal boxes
of each frame come from the trajectory durations, go through the MEGA
feature extractor (backbone and RoI head in batches, then the MEGA head frame
by frame) and the per-video pickle the eval loader reads is written to
``--out_dir``:

    {frame_id: {"frame_id": int, "tids": int64[n],
                "visual_features": float32[n, 1024]}}

Frame ids are the proposal file's own duration coordinates (closed
[start, end]; a proposal is live at fid iff start <= fid <= end, box index
fid - start). The eval loader asserts each trajectory's frame count, so the
box slots are sized to the video's largest live count and nothing is cut.
Boxes are clipped to [0, w-1] x [0, h-1] as the reference does. Frame fid is
read from ``<frames_dir>/<video>/%06d.jpg`` numbered fid + 1.

    python extract_proposal_features_torch.py --proposal_dir <dir of .pkl> \\
        --frames_dir <dir> --out_dir <dir> [--ckpt_path params.npz] \\
        [--device cuda|cpu]

``--ckpt_path`` takes the same ``.npz`` files as
``extract_gt_features_torch.py``.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from extract_gt_features_torch import (add_common_args, add_stream_args,
                                       build_extractor, load_frame)
from vrdone_tpu_torch.models.detector import (MegaDetector,
                                              extract_video_features)


def _np(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


def frame_table(proposal: dict):
    """Per-frame (rois, tids) from trajectory durations.

    Returns (fids, rois (F, S, 4), valid (F, S), tids list[int64 array])
    with S = max live proposals over the video rounded up to a multiple
    of 8 (static shape -> one compiled program per bucket)."""
    durations = _np(proposal["traj_durations"]).astype(np.int64)
    bboxes_list = [_np(b).astype(np.float32)
                   for b in proposal["bboxes_list"]]
    w, h = proposal["video_wh"]
    lo = int(durations[:, 0].min())
    hi = int(durations[:, 1].max())
    fids = list(range(lo, hi + 1))

    live = [[] for _ in fids]
    for e, (s, t) in enumerate(durations):
        for fid in range(int(s), int(t) + 1):
            live[fid - lo].append(e)
    max_live = max((len(l) for l in live), default=0)
    slots = max(8, int(np.ceil(max_live / 8)) * 8)

    rois = np.zeros((len(fids), slots, 4), np.float32)
    valid = np.zeros((len(fids), slots), bool)
    tids = []
    for i, fid in enumerate(fids):
        ent = live[i]
        tids.append(np.asarray(ent, np.int64))
        for j, e in enumerate(ent):
            b = bboxes_list[e][fid - int(durations[e, 0])]
            rois[i, j] = [max(b[0], 0.0), max(b[1], 0.0),
                          min(b[2], w - 1.0), min(b[3], h - 1.0)]
            valid[i, j] = True
    return fids, rois, valid, tids


def extract_video(det: MegaDetector, proposal: dict, frames_dir: str,
                  video: str, *, seed: int = 0,
                  compute_dtype: str = "float32") -> dict:
    fids, rois, valid, tids = frame_table(proposal)
    if not fids:
        return {}

    def load(lo, hi):
        return np.stack([load_frame(frames_dir, video, fid)
                         for fid in fids[lo:hi]])

    feats = extract_video_features(det, load, rois, valid, seed=seed,
                                   compute_dtype=compute_dtype)
    out = {}
    for i, fid in enumerate(fids):
        if len(tids[i]) == 0:
            continue
        out[fid] = {
            "frame_id": fid,
            "tids": tids[i],
            "visual_features": np.asarray(feats[i][:len(tids[i])]),
        }
    return out


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--proposal_dir", required=True,
                   help="per-video BIG proposal pickles "
                        "(features/per_video_val layout)")
    add_common_args(p)
    add_stream_args(p)
    return p.parse_args(argv)


def main(argv: list[str] | None = None):
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    videos = sorted(v[:-4] for v in os.listdir(args.proposal_dir)
                    if v.endswith(".pkl"))
    videos = videos[args.part::args.num_parts]

    det = None
    for video in videos:
        dst = os.path.join(args.out_dir, video + ".pkl")
        if os.path.exists(dst):
            continue
        with open(os.path.join(args.proposal_dir, video + ".pkl"),
                  "rb") as f:
            proposal = pickle.load(f)["traj_proposal"]
        if det is None:
            # box slots vary per video; the detector itself is
            # slot-agnostic (advanced_num must just not exceed slots)
            det = build_extractor(args, 8, 8)
        data = extract_video(det, proposal, args.frames_dir, video,
                             seed=args.seed,
                             compute_dtype=args.compute_dtype)
        with open(dst, "wb") as f:
            pickle.dump(data, f)
        print(f"{video}: {len(data)} frames")


if __name__ == "__main__":
    main()
