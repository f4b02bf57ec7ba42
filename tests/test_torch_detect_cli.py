"""``detect_torch.py`` end to end on the CPU: a tiny detector (R (1, 1, 1),
a 64 x 96 canvas) over a synthetic frames directory of JPEGs, written as
``tools/detect_and_track.py`` writes them: one ``{"traj_proposal": ...}``
pickle per video with the keys of the JAX package's build_traj_proposal.
Without ``--compute_dtype`` the detector runs in bfloat16, the JAX CLI's
default; ``--compute_dtype float32`` gives the fp32 path."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from vrdone_tpu.data.proposals import build_traj_proposal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--resnet_layers", "1,1,1", "--canvas", "64", "96",
        "--post_nms_top_n", "8", "--base_num", "4", "--window", "3",
        "--global_size", "2", "--score_thresh", "0.02", "--device", "cpu"]


def write_frames(tmp_path):
    """A 5-frame video of 60 x 90 JPEGs with a bright block that stays
    put; returns the frames directory."""
    rng = np.random.default_rng(0)
    frames = tmp_path / "frames" / "vid0"
    frames.mkdir(parents=True)
    for i in range(5):
        img = rng.integers(0, 256, (60, 90, 3), dtype=np.uint8)
        img[10:40, 20:60] = 200   # a bright block that stays put
        Image.fromarray(img).save(frames / f"{i:06d}.jpg")
    return tmp_path / "frames"


def check_pickle(path):
    with open(path, "rb") as f:
        prop = pickle.load(f)["traj_proposal"]
    want = build_traj_proposal("vid0", [], (90, 60), 5)
    assert set(prop) == set(want)
    assert prop["video_wh"] == (90, 60) and prop["video_len"] == 5
    assert prop["num_proposals"] == len(prop["bboxes_list"])
    for boxes, feats in zip(prop["bboxes_list"], prop["features_list"]):
        assert boxes.shape[1] == 4 and feats.shape == (len(boxes), 1024)
        assert np.isfinite(feats).all()


def test_detect_torch_cli_on_cpu(tmp_path):
    frames = write_frames(tmp_path)
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "detect_torch.py"),
         "--frames_dir", str(frames), "--out_dir", str(out), *TINY],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "vid0:" in r.stdout
    check_pickle(out / "vid0.pkl")


@pytest.mark.parametrize("flag,want", [(None, "bfloat16"),
                                       ("float32", "float32"),
                                       ("bfloat16", "bfloat16")])
def test_detect_torch_cli_compute_dtype(tmp_path, monkeypatch, flag, want):
    """The dtype that reaches detect_video: JAX's default (bfloat16)
    without the flag, else the flag's."""
    sys.path.insert(0, REPO)
    try:
        import detect_torch
    finally:
        sys.path.remove(REPO)
    seen = []
    real = detect_torch.detect_video

    def spy(*args, **kwargs):
        seen.append(kwargs["compute_dtype"])
        return real(*args, **kwargs)

    frames = write_frames(tmp_path)
    monkeypatch.setattr(detect_torch, "detect_video", spy)
    monkeypatch.setattr(sys, "argv", [
        "detect_torch.py", "--frames_dir", str(frames), "--out_dir",
        str(tmp_path / "out"), *TINY,
        *(["--compute_dtype", flag] if flag else [])])
    detect_torch.main()
    assert seen == [want]
    check_pickle(tmp_path / "out" / "vid0.pkl")
