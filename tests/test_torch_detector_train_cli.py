"""``train_detector_torch.py`` end to end on the CPU with the tiny flags of
``tests/test_detector_cli.py`` (R (1, 1, 1), a 64 x 96 canvas, one local,
memory and global frame) on its synthetic corpus of two videos, one
landscape and one portrait: two iterations with a validation sweep,
``--resume`` to four (equal to an unbroken run of four), then
``detect_torch.py --ckpt_path`` on the ``.npz`` the trainer wrote; a COCO
image-mode run; and ``--method rdn`` (train, validate, resume) with the
other methods getting past ``--method``."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_detect_cli import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--resnet_layers", "1,1,1", "--min_size", "64", "--canvas", "64",
         "96", "--max_gt", "4", "--log_interval", "1", "--n_local", "1",
         "--n_mem", "1", "--n_glob", "1", "--base_num", "4",
         "--post_nms_top_n", "8", "--device", "cpu"]


def write_corpus(root):
    """tests/test_detector_cli.py's corpus: vid0 80 x 120 (landscape) and
    vid1 120 x 80 (portrait), three annotated frames each; and the
    reference-layout config, with MEGA's three stages, which detect_torch.py
    builds."""
    rng = np.random.default_rng(0)
    anno_dir = os.path.join(root, "annotations")
    frames_dir = os.path.join(root, "frames")
    os.makedirs(anno_dir)
    for v in range(2):
        name = f"vid{v}"
        h, w = (80, 120) if v == 0 else (120, 80)
        os.makedirs(os.path.join(frames_dir, name))
        trajectories = []
        for f in range(3):
            img = rng.integers(0, 255, (h, w, 3), np.uint8)
            Image.fromarray(img).save(
                os.path.join(frames_dir, name, f"{f + 1:06d}.jpg"))
            trajectories.append([
                {"tid": 0, "bbox": {"xmin": 10, "ymin": 10,
                                    "xmax": 60, "ymax": 50}},
                {"tid": 1, "bbox": {"xmin": 30, "ymin": 20,
                                    "xmax": 75, "ymax": 70}},
            ])
        anno = {"video_id": name, "height": h, "width": w, "frame_count": 3,
                "subject/objects": [{"tid": 0, "category": "dog"},
                                    {"tid": 1, "category": "person"}],
                "trajectories": trajectories, "relation_instances": []}
        with open(os.path.join(anno_dir, name + ".json"), "w") as f:
            json.dump(anno, f)
    cfg = os.path.join(root, "det.yaml")
    with open(cfg, "w") as f:
        f.write("MODEL:\n  VID:\n    METHOD: mega\n"
                "    ROI_BOX_HEAD:\n      ATTENTION:\n        STAGE: 3\n"
                "SOLVER:\n  BASE_LR: 0.001\n  WARMUP_ITERS: 1\n"
                "  STEPS: [2]\n  IMS_PER_BATCH: 1\n")
    return anno_dir, frames_dir, cfg


def run(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout + r.stderr


def test_train_resume_then_detect(tmp_path):
    anno_dir, frames_dir, cfg = write_corpus(str(tmp_path))
    exp = str(tmp_path / "exp")

    def train(exp_dir, *extra):
        return run("train_detector_torch.py", "--anno_dir", anno_dir,
                   "--frames_dir", frames_dir, "--exp_dir", exp_dir,
                   "--dataset", "vidvrd", "--cfg", cfg, *FLAGS, *extra)

    log = train(exp, "--iters", "2", "--save_interval", "2",
                "--eval_interval", "2", "--val_anno_dir", anno_dir,
                "--val_videos", "1")
    assert "[2] detector eval: mAP=" in log
    assert os.path.exists(os.path.join(exp, "detector_2.npz"))
    assert os.path.exists(os.path.join(exp, "detector_2.state.pt"))
    assert "loss_rpn_cls" in log and "total_loss" in log
    assert "aspect groups: portrait=3, landscape=3" in log

    log2 = train(exp, "--iters", "4", "--save_interval", "4", "--resume")
    assert "resumed from" in log2 and "at iteration 2" in log2
    assert "[2/4]" in log2 and "[0/4]" not in log2
    assert os.path.exists(os.path.join(exp, "detector_4.npz"))
    state = torch.load(os.path.join(exp, "detector_4.state.pt"),
                       weights_only=True)
    assert state["it"] == 4 and state["optimizer"]["count"] == 4
    # the resumed run is the unbroken run: weights, momentum, data draws
    whole = str(tmp_path / "whole")
    train(whole, "--iters", "4", "--save_interval", "4")
    with np.load(os.path.join(exp, "detector_4.npz")) as a, \
            np.load(os.path.join(whole, "detector_4.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    out = tmp_path / "det"
    log3 = run("detect_torch.py", "--frames_dir", frames_dir, "--out_dir",
               str(out), "--ckpt_path", os.path.join(exp, "detector_4.npz"),
               *TINY)
    assert "vid0:" in log3
    for v in ("vid0", "vid1"):
        with open(out / f"{v}.pkl", "rb") as f:
            prop = pickle.load(f)["traj_proposal"]
        assert prop["video_len"] == 3


def test_coco_image_mode(tmp_path):
    """One iteration on a COCO-format source: the reference frames are
    copies of the key image."""
    rng = np.random.default_rng(1)
    images = tmp_path / "images"
    images.mkdir()
    coco = {"images": [], "annotations": []}
    for i, (h, w) in enumerate(((70, 100), (90, 60))):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
            images / f"{i}.jpg")
        coco["images"].append({"id": i, "file_name": f"{i}.jpg",
                               "height": h, "width": w})
        coco["annotations"].append({"image_id": i, "category_id": 3,
                                    "bbox": [5, 8, 30, 40]})
    ann = tmp_path / "coco.json"
    ann.write_text(json.dumps(coco))
    exp = str(tmp_path / "exp")
    log = run("train_detector_torch.py", "--coco_ann", str(ann),
              "--images_dir", str(images), "--exp_dir", exp, "--iters", "1",
              *FLAGS)
    assert "COCO source: 2 images" in log and "loss_box_cls" in log
    assert os.path.exists(os.path.join(exp, "detector_1.npz"))


@pytest.mark.parametrize("method", ["rdn", "base", "fgfa", "dff"])
def test_other_methods_refuse(tmp_path, method):
    """Every method is ported: a run without data gets past ``--method`` and
    is refused for its missing data, as a MEGA run is."""
    sys.path.insert(0, REPO)
    try:
        import train_detector_torch
    finally:
        sys.path.remove(REPO)
    with pytest.raises(SystemExit, match="need --coco_ann and/or --anno_dir"):
        train_detector_torch.main(["--exp_dir", str(tmp_path), "--method",
                                   method, "--device", "cpu"])


def test_rdn_train_resume_and_validate(tmp_path):
    """``--method rdn`` from a reference-layout config with the advanced
    stage (two sampled reference frames a sample, RDN's 37-frame window
    clamped to the 3-frame videos): two iterations with a validation sweep
    through rdn_detect_video, then ``--resume`` to three, equal to an
    unbroken run of three."""
    anno_dir, frames_dir, _ = write_corpus(str(tmp_path))
    cfg = tmp_path / "rdn.yaml"
    cfg.write_text("MODEL:\n  VID:\n    METHOD: rdn\n"
                   "    ROI_BOX_HEAD:\n      ATTENTION:\n"
                   "        ADVANCED_STAGE: 1\n"
                   "SOLVER:\n  BASE_LR: 0.001\n  WARMUP_ITERS: 1\n"
                   "  STEPS: [2]\n  IMS_PER_BATCH: 1\n")

    def train(exp_dir, *extra):
        return run("train_detector_torch.py", "--anno_dir", anno_dir,
                   "--frames_dir", frames_dir, "--exp_dir", exp_dir,
                   "--dataset", "vidvrd", "--cfg", str(cfg), *FLAGS, *extra)

    exp = str(tmp_path / "exp")
    log = train(exp, "--iters", "2", "--save_interval", "2",
                "--eval_interval", "2", "--val_anno_dir", anno_dir,
                "--val_videos", "1")
    assert "method=rdn" in log and "[2] detector eval: mAP=" in log
    with np.load(os.path.join(exp, "detector_2.npz")) as z:
        assert "rdn/Wv2/kernel" in z.files and "rdn/fc2/kernel" in z.files
    log2 = train(exp, "--iters", "3", "--save_interval", "3", "--resume")
    assert "at iteration 2" in log2
    whole = str(tmp_path / "whole")
    train(whole, "--iters", "3", "--save_interval", "3")
    with np.load(os.path.join(exp, "detector_3.npz")) as a, \
            np.load(os.path.join(whole, "detector_3.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
