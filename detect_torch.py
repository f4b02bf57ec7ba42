"""Raw frames -> detections -> tracklets -> eval proposal pickles, with the
PyTorch port (the counterpart of ``tools/detect_and_track.py``).

For each video directory of frames under ``--frames_dir``: the MEGA
detector (``vrdone_tpu_torch.models.detector.detect_video``: sliding
window, per-stage memory, global set) detects every frame, the IoU tracker
links the per-class detections into tracklets, and the per-video
``{"traj_proposal": ...}`` pickle the relation model's eval loader reads is
written to ``--out_dir``.

    python detect_torch.py --frames_dir <dir> --out_dir <dir> \
        [--ckpt_path params.npz] [--device cuda|cpu]

``--ckpt_path`` takes the ``.npz`` that ``tools/export_params_npz.py``
writes from a JAX checkpoint; without it the weights are drawn from a
seeded generator with the JAX initialisers' distributions. The detector
runs in bfloat16 unless ``--compute_dtype float32`` is given, as
``tools/detect_and_track.py`` does.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from vrdone_tpu_torch.convert import load_npz, load_params
from vrdone_tpu_torch.data.proposals import build_traj_proposal
from vrdone_tpu_torch.data.tracking import IoUTracker, iou_matrix
from vrdone_tpu_torch.models.detector import (MegaDetector, detect_video,
                                              postprocess_frame)


class FrameLoader:
    """Lazy per-frame canvas loader for detect_video: BGR float frames
    pasted at the top left of a zero canvas."""

    def __init__(self, frames_dir, video, frames, canvas_hw):
        self.frames_dir = frames_dir
        self.video = video
        self.frames = frames
        self.canvas_hw = canvas_hw
        self.image_wh = None

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        from PIL import Image
        img = np.asarray(Image.open(
            os.path.join(self.frames_dir, self.video, self.frames[i])),
            np.float32)[..., ::-1]
        h, w = img.shape[:2]
        self.image_wh = (w, h)
        ch, cw = self.canvas_hw
        canvas = np.zeros((ch, cw, 3), np.float32)
        canvas[:min(h, ch), :min(w, cw)] = img[:ch, :cw]
        return canvas


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ckpt_path", default=None,
                   help="an .npz written by tools/export_params_npz.py")
    p.add_argument("--num_classes", type=int, default=35)
    p.add_argument("--resnet_layers", type=str, default="3,4,23")
    p.add_argument("--canvas", type=int, nargs=2, default=(608, 1088))
    p.add_argument("--score_thresh", type=float, default=0.4)
    p.add_argument("--max_proposal", type=int, default=180)
    p.add_argument("--post_nms_top_n", type=int, default=64,
                   help="key-frame proposals per frame")
    p.add_argument("--base_num", type=int, default=16,
                   help="window/global ref proposals per frame")
    p.add_argument("--window", type=int, default=25)
    p.add_argument("--global_size", type=int, default=10)
    p.add_argument("--part", type=int, default=0)
    p.add_argument("--num_parts", type=int, default=1)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=("float32", "bfloat16"),
                   help="backbone/RoI precompute dtype (bf16 = serving "
                        "fast path; box decode/NMS stay fp32 either way)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights without --ckpt_path")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the detector, e.g. cuda or cpu")
    return p.parse_args()


def build_detector(args) -> MegaDetector:
    layers = tuple(int(x) for x in args.resnet_layers.split(","))
    det = MegaDetector(num_classes=args.num_classes, resnet_layers=layers,
                       base_num=args.base_num, window=args.window,
                       key_loc=args.window // 2,
                       global_size=args.global_size,
                       global_enable=args.global_size > 0,
                       device=torch.device("cpu"),
                       generator=torch.Generator().manual_seed(args.seed))
    if args.ckpt_path:
        load_params(det, load_npz(args.ckpt_path))
    return det.to(torch.device(args.device))


def main():
    args = parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    det = build_detector(args)
    canvas = np.asarray(args.canvas)
    videos = sorted(os.listdir(args.frames_dir))[args.part::args.num_parts]
    for video in videos:
        dst = os.path.join(args.out_dir, video + ".pkl")
        if os.path.exists(dst):
            continue
        frames = sorted(os.listdir(os.path.join(args.frames_dir, video)))
        loader = FrameLoader(args.frames_dir, video, frames, tuple(canvas))
        out = detect_video(det, loader, canvas,
                           key_post_nms=args.post_nms_top_n,
                           compute_dtype=args.compute_dtype)
        tracker = IoUTracker()
        for fid in range(len(frames)):
            res = postprocess_frame(
                out["proposals"][fid], out["cls_logits"][fid],
                out["bbox_deltas"][fid], out["valid"][fid],
                tuple(args.canvas), score_thresh=args.score_thresh)
            visual = out["visual"][fid]
            feats = np.zeros((len(res["boxes"]), 1024), np.float32)
            if len(res["boxes"]):
                nn = np.argmax(iou_matrix(res["boxes"],
                                          out["proposals"][fid]), axis=1)
                feats = visual[nn]
            tracker.update(fid, res["boxes"], res["labels"], res["scores"],
                           feats)
        w, h = loader.image_wh
        prop = build_traj_proposal(video, tracker.finish(), (w, h),
                                   len(frames),
                                   max_proposal=args.max_proposal)
        with open(dst, "wb") as f:
            pickle.dump({"traj_proposal": prop}, f)
        print(f"{video}: {prop['num_proposals']} tracklets")


if __name__ == "__main__":
    main()
