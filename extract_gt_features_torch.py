"""Per-frame GT-box RoI features for relation-model training, with the
PyTorch port (the counterpart of ``tools/extract_gt_features.py``).

For each annotated video under ``--anno_dir``: the annotated GT boxes of
each annotated frame go through the backbone and the RoI head in batches
(fc0), then through the MEGA head frame by frame (the 25-frame window, the
per-stage memory and the shuffled global set), and the per-video pickle the
train loader reads is written to ``--out_dir``:

    {frame_id (1-based): {"frame_id": int, "tids": int64[n],
                          "visual_features": float32[n, 1024]}}

Only annotated frames enter the stream, as in the reference. Frames are read
from ``<frames_dir>/<video>/%06d.jpg``, numbered from 1 as
``tools/video_to_frames.py`` writes them.

    python extract_gt_features_torch.py --anno_dir <dir of .json> \\
        --frames_dir <dir> --out_dir <dir> [--ckpt_path params.npz] \\
        [--device cuda|cpu]

``--ckpt_path`` takes an ``.npz``: the extraction path's parameters
(``backbone``, ``box_head/c5``, ``mega``) as ``tools/export_params_npz.py``
writes them from a JAX extractor checkpoint, or a whole detector's from
``convert_mega_checkpoint_torch.py``. Without it the weights are drawn from
a generator seeded with ``--seed``. The extraction runs the MEGA head's
dense attention route, on the card too.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np
import torch

from vrdone_tpu_torch.convert import load_extractor_params, load_npz
from vrdone_tpu_torch.models.detector import (MegaDetector,
                                              extract_video_features)


def load_frame(frames_dir: str, video: str, idx: int) -> np.ndarray:
    from PIL import Image
    path = os.path.join(frames_dir, video, f"{idx + 1:06d}.jpg")
    img = np.asarray(Image.open(path), dtype=np.float32)
    return img[..., ::-1]  # RGB -> BGR (Caffe2-lineage preprocessing)


def _frame_rois(frame_anno, box_slots):
    boxes = np.zeros((box_slots, 4), np.float32)
    valid = np.zeros((box_slots,), bool)
    for i, b in enumerate(frame_anno[:box_slots]):
        bb = b["bbox"]
        boxes[i] = [bb["xmin"], bb["ymin"], bb["xmax"], bb["ymax"]]
        valid[i] = True
    return boxes, valid


def extract_video(det: MegaDetector, anno: dict, frames_dir: str,
                  video: str, *, box_slots: int = 16, seed: int = 0,
                  compute_dtype: str = "float32") -> dict:
    """Stream one video's annotated frames through the MEGA extractor."""
    trajectories = anno["trajectories"]
    fids = [f for f in range(len(trajectories)) if trajectories[f]]
    if not fids:
        return {}

    rois = np.zeros((len(fids), box_slots, 4), np.float32)
    valid = np.zeros((len(fids), box_slots), bool)
    tids = []
    for i, fid in enumerate(fids):
        rois[i], valid[i] = _frame_rois(trajectories[fid], box_slots)
        tids.append(np.asarray([b["tid"] for b in trajectories[fid]],
                               np.int64))

    def load(lo, hi):
        return np.stack([load_frame(frames_dir, video, fid)
                         for fid in fids[lo:hi]])

    feats = extract_video_features(det, load, rois, valid, seed=seed,
                                   compute_dtype=compute_dtype)

    out = {}
    for i, fid in enumerate(fids):
        n = min(len(tids[i]), box_slots)
        out[fid + 1] = {
            "frame_id": fid + 1,
            "tids": tids[i][:n],
            "visual_features": np.asarray(feats[i][:n]),
        }
    return out


def build_extractor(args, base_num: int, advanced_num: int) -> MegaDetector:
    """The detector with the CLI's knobs, on ``--device``: random weights
    drawn on the CPU from ``--seed``, then ``--ckpt_path``'s if given."""
    layers = tuple(int(x) for x in args.resnet_layers.split(","))
    det = MegaDetector(num_classes=args.num_classes, resnet_layers=layers,
                       base_num=base_num, advanced_num_override=advanced_num,
                       window=args.window, key_loc=args.window // 2,
                       global_size=args.global_size,
                       global_enable=args.global_size > 0,
                       device=torch.device("cpu"),
                       generator=torch.Generator().manual_seed(args.seed))
    if args.ckpt_path:
        load_extractor_params(det, load_npz(args.ckpt_path))
    return det.to(torch.device(args.device))


def add_common_args(p: argparse.ArgumentParser) -> None:
    """The flags both extractors share after their own input directory."""
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ckpt_path", default=None,
                   help="an .npz of the extraction path's parameters "
                        "(tools/export_params_npz.py) or of a whole "
                        "detector (convert_mega_checkpoint_torch.py); "
                        "random weights if omitted")
    p.add_argument("--num_classes", type=int, default=35)
    p.add_argument("--resnet_layers", type=str, default="3,4,23")
    p.add_argument("--part", type=int, default=0)
    p.add_argument("--num_parts", type=int, default=1)


def add_stream_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--window", type=int, default=25)
    p.add_argument("--global_size", type=int, default=10,
                   help="0 disables the MEGA global stage")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compute_dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="backbone/RoI and MEGA pass dtype (features always "
                        "written fp32)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the detector, e.g. cuda or cpu")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--anno_dir", required=True)
    add_common_args(p)
    p.add_argument("--box_slots", type=int, default=16)
    add_stream_args(p)
    return p.parse_args(argv)


def main(argv: list[str] | None = None):
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    videos = sorted(v[:-5] for v in os.listdir(args.anno_dir)
                    if v.endswith(".json"))
    videos = videos[args.part::args.num_parts]

    det = None
    for video in videos:
        dst = os.path.join(args.out_dir, video + ".pkl")
        if os.path.exists(dst):
            continue
        with open(os.path.join(args.anno_dir, video + ".json")) as f:
            anno = json.load(f)
        if det is None:
            det = build_extractor(args, args.box_slots,
                                  min(15, args.box_slots))
        data = extract_video(det, anno, args.frames_dir, video,
                             box_slots=args.box_slots, seed=args.seed,
                             compute_dtype=args.compute_dtype)
        with open(dst, "wb") as f:
            pickle.dump(data, f)
        print(f"{video}: {len(data)} frames")


if __name__ == "__main__":
    main()
