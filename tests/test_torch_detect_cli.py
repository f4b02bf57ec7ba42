"""``detect_torch.py`` end to end on the CPU: a tiny detector (R (1, 1, 1),
a 64 x 96 canvas) over a synthetic frames directory of JPEGs, written as
``tools/detect_and_track.py`` writes them: one ``{"traj_proposal": ...}``
pickle per video with the keys of the JAX package's build_traj_proposal."""

import os
import pickle
import subprocess
import sys

import numpy as np
from PIL import Image

from vrdone_tpu.data.proposals import build_traj_proposal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_detect_torch_cli_on_cpu(tmp_path):
    rng = np.random.default_rng(0)
    frames = tmp_path / "frames" / "vid0"
    frames.mkdir(parents=True)
    for i in range(5):
        img = rng.integers(0, 256, (60, 90, 3), dtype=np.uint8)
        img[10:40, 20:60] = 200   # a bright block that stays put
        Image.fromarray(img).save(frames / f"{i:06d}.jpg")
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "detect_torch.py"),
         "--frames_dir", str(tmp_path / "frames"), "--out_dir", str(out),
         "--resnet_layers", "1,1,1", "--canvas", "64", "96",
         "--post_nms_top_n", "8", "--base_num", "4", "--window", "3",
         "--global_size", "2", "--score_thresh", "0.02",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "vid0:" in r.stdout
    with open(out / "vid0.pkl", "rb") as f:
        prop = pickle.load(f)["traj_proposal"]
    want = build_traj_proposal("vid0", [], (90, 60), 5)
    assert set(prop) == set(want)
    assert prop["video_wh"] == (90, 60) and prop["video_len"] == 5
    assert prop["num_proposals"] == len(prop["bboxes_list"])
    for boxes, feats in zip(prop["bboxes_list"], prop["features_list"]):
        assert boxes.shape[1] == 4 and feats.shape == (len(boxes), 1024)
        assert np.isfinite(feats).all()
