"""``train_torch.py`` end to end on the CPU: two epochs on the synthetic
VidVRD corpus, a third after ``--auto_resume``, then ``eval_torch.py`` on
its checkpoint, whose metric dict has ``eval.py``'s keys and finite
values; and one epoch each in bf16, in bf16 with remat and in fp32 with
remat, each checkpoint evaluated; and VrdONE-X (``with_clip_feature``)
trained and evaluated on a VidOR corpus with CLIP features, whose items
both packages' datasets give alike."""

import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from tests.synth_corpus import make_vidvrd_corpus, make_vidvrd_test_corpus
from tests.test_cli_e2e import tiny_yaml
from tests.test_torch_eval import METRICS
from tests.test_torch_model import REPO
from tests.test_vidor_dataset import CLIP, VIS, make_vidor_corpus


def run(script, *args, timeout=600):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, script, *args], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def test_train_resume_then_eval(tmp_path):
    root = str(tmp_path)
    dirs = make_vidvrd_corpus(root, n_videos=4, n_frames=40, seed=0)
    dirs.update(make_vidvrd_test_corpus(root, n_videos=2, seed=1))
    cfg = tiny_yaml(root, dirs)
    paths = []
    for epochs in (2, 3):
        cfg["training_config"]["training_epoch"] = epochs
        paths.append(os.path.join(root, f"cfg{epochs}.yaml"))
        with open(paths[-1], "w") as f:
            yaml.safe_dump(cfg, f)
    exp = os.path.join(root, "exp")
    common = ["--data_name", "vidvrd", "--exp_dir", exp, "--device", "cpu"]

    out = run("train_torch.py", "--cfg_path", paths[0], *common)
    steps = int(re.search(r"steps/epoch: (\d+)", out).group(1))
    assert steps > 0 and "Training Over..." in out
    for name in ("model_epoch_1_vidvrd.ckpt", "model_epoch_2_vidvrd.ckpt",
                 "model_last.ckpt"):
        assert os.path.exists(os.path.join(exp, name)), name
    losses = [float(x) for x in re.findall(r"Total loss=([0-9.]+)", out)]
    assert len(losses) == 2 * steps and all(map(math.isfinite, losses))

    out = run("train_torch.py", "--cfg_path", paths[1], *common,
              "--auto_resume")
    assert "model_last.ckpt at epoch 2" in out
    assert "Epoch 2 started" in out and "Epoch 1 started" not in out
    ckpt = torch.load(os.path.join(exp, "model_last.ckpt"),
                      weights_only=True)
    assert ckpt["step"] == ckpt["opt_state"]["count"] == 3 * steps
    assert ckpt["meta"] == {"crt_epoch": 3,
                            "batch_size": cfg["training_config"]["batch_size"]}

    out = run("eval_torch.py", "--cfg_path", paths[1], *common,
              "--ckpt_path", os.path.join(exp, "model_last.ckpt"),
              "--topk", "3")
    metrics = {k: float(v) for k, v in METRICS.findall(out)}
    assert set(metrics) == {"RelDet_mAP", "RelDet_AR@50", "RelDet_AR@100",
                            "RelTag_AP@1", "RelTag_AP@5", "RelTag_AP@10"}
    assert all(map(math.isfinite, metrics.values()))
    assert "Eval done." in out


@pytest.mark.parametrize("flags", [
    ["--compute_dtype", "bfloat16"],
    ["--compute_dtype", "bfloat16", "--remat", "--remat_policy", "dots"],
    ["--remat"]])
def test_train_bf16_or_remat_epoch_then_eval(tmp_path, flags):
    """One epoch of ``train_torch.py`` in bf16, in bf16 with remat, and in
    fp32 with remat: finite losses, a checkpoint of fp32 masters (EMA and
    optimizer moments included), which ``eval_torch.py`` evaluates as it
    is."""
    root = str(tmp_path)
    dirs = make_vidvrd_corpus(root, n_videos=4, n_frames=40, seed=0)
    dirs.update(make_vidvrd_test_corpus(root, n_videos=2, seed=1))
    cfg = tiny_yaml(root, dirs)
    cfg["training_config"]["training_epoch"] = 1
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    exp = os.path.join(root, "exp")
    common = ["--data_name", "vidvrd", "--cfg_path", path, "--exp_dir", exp,
              "--device", "cpu"]
    out = run("train_torch.py", *common, *flags)
    assert "Training Over..." in out
    losses = [float(x) for x in re.findall(r"Total loss=([0-9.]+)", out)]
    assert losses and all(map(math.isfinite, losses))
    with open(os.path.join(exp, "config.yaml")) as f:
        model_cfg = yaml.safe_load(f)["model_config"]
    assert model_cfg.get("compute_dtype", "float32") == (
        "bfloat16" if "bfloat16" in flags else "float32")
    assert model_cfg.get("remat", False) == ("--remat" in flags)
    ckpt = torch.load(os.path.join(exp, "model_last.ckpt"),
                      weights_only=True)
    floats = [*ckpt["params"].values(), *ckpt["ema_params"].values(),
              *(t for ts in ckpt["opt_state"]["moments"].values()
                for t in ts)]
    assert all(t.dtype == torch.float32 for t in floats
               if t.is_floating_point())
    out = run("eval_torch.py", *common, "--ckpt_path",
              os.path.join(exp, "model_last.ckpt"), "--topk", "3")
    assert "Eval done." in out


# ---------------------------------------------------------------------------
# VrdONE-X: a with_clip_feature corpus
# ---------------------------------------------------------------------------
#
# VidVRD's eval loader reads no CLIP stream (in the JAX package too: only
# VidOR's validation items carry ``clip_features_list``), so the CLIP
# corpus is VidOR's: the training split of
# ``tests/test_vidor_dataset.py::make_vidor_corpus``, whose CLIP pickles
# hold one (frames, CLIP) array a track, and a validation split written
# below in the layout ``data/datasets.py``'s VidOR loader reads (proposal
# pickles with their features inside, one CLIP array a proposal).

def write_vidor_validation(root, dirs, clip_dim, seed=2):
    """Validation annotations (the training ones), proposal pickles (one
    proposal a track, durations stored as VidOR stores them: start + 1,
    end exclusive) and the proposals' CLIP pickles; returns their dirs."""
    rng = np.random.default_rng(seed)
    train_dir = os.path.join(dirs["ann_dir"], "training")
    info_dir = os.path.join(root, "features", "vidor_per_video_val")
    clip_dir = os.path.join(root, "features", "clip_val_proposal")
    os.makedirs(info_dir)
    os.makedirs(clip_dir)
    cats = {"dog": 1, "adult": 2, "car": 3}
    for group in sorted(os.listdir(train_dir)):
        os.makedirs(os.path.join(dirs["ann_dir"], "validation", group))
        for file in sorted(os.listdir(os.path.join(train_dir, group))):
            shutil.copy(os.path.join(train_dir, group, file),
                        os.path.join(dirs["ann_dir"], "validation", group))
            with open(os.path.join(train_dir, group, file)) as f:
                anno = json.load(f)
            n_frames = anno["frame_count"]
            durations, boxes = [], []
            for so in anno["subject/objects"]:
                frames = [(i, b["bbox"]) for i, fr in
                          enumerate(anno["trajectories"]) for b in fr
                          if b["tid"] == so["tid"]]
                durations.append([frames[0][0] + 1, frames[-1][0] + 1])
                boxes.append(np.asarray(
                    [[b["xmin"], b["ymin"], b["xmax"], b["ymax"]]
                     for _, b in frames], np.float32))
            name = f"{group}_{file.split('.')[0]}"
            prop = {"video_name": name, "num_proposals": len(boxes),
                    "cat_ids": np.asarray([cats[so["category"]] for so in
                                           anno["subject/objects"]]),
                    "scores": rng.uniform(0.5, 1, len(boxes)),
                    "bboxes_list": boxes,
                    "traj_durations": np.asarray(durations),
                    "features_list": [rng.standard_normal(
                        (len(b), VIS)).astype(np.float32) for b in boxes],
                    "video_wh": (anno["width"], anno["height"])}
            with open(os.path.join(info_dir, name + ".pkl"), "wb") as f:
                pickle.dump({"traj_proposal": prop}, f)
            with open(os.path.join(clip_dir, name + ".pkl"), "wb") as f:
                pickle.dump([rng.standard_normal((n_frames, clip_dim))
                             .astype(np.float32) + 0.1 for _ in boxes], f)
    return {"info_dir": info_dir, "clip_val_proposal_features_dir": clip_dir}


def vrdone_x_yaml(root):
    """A tiny VrdONE-X config (``configs/vidor_x.yaml``'s switches at the
    CLI tests' widths) over the VidOR CLIP corpus."""
    dirs = make_vidor_corpus(root, n_videos=4, n_frames=40)
    dirs.update(write_vidor_validation(root, dirs, CLIP))
    cfg = tiny_yaml(root, {**dirs, "test_boxfeatures_dir": None})
    mc = cfg["model_config"]
    mc.update(clip_dim=CLIP, num_classes=50)
    mc["predictor"]["num_classes"] = 50
    cfg["dataset_config"].update(
        with_clip_feature=True, cache_tag="E2E_clip",
        clip_training_features_dir=dirs["clip_training_features_dir"],
        clip_val_proposal_features_dir=dirs[
            "clip_val_proposal_features_dir"])
    cfg["training_dataset_config"]["split"] = "training"
    cfg["test_dataset_config"]["split"] = "validation"
    return cfg


def test_vrdone_x_train_then_eval_on_clip_features(tmp_path):
    """One epoch of ``train_torch.py`` on the CLIP corpus, then
    ``eval_torch.py`` on its checkpoint: finite losses, CLIP parameters in
    the checkpoint, and ``eval.py``'s metric keys with finite values."""
    root = str(tmp_path)
    cfg = vrdone_x_yaml(root)
    cfg["training_config"]["training_epoch"] = 1
    path = os.path.join(root, "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    exp = os.path.join(root, "exp")
    common = ["--data_name", "vidor", "--cfg_path", path, "--exp_dir", exp,
              "--device", "cpu"]
    out = run("train_torch.py", *common)
    assert "Training Over..." in out
    losses = [float(x) for x in re.findall(r"Total loss=([0-9.]+)", out)]
    assert losses and all(map(math.isfinite, losses))
    ckpt = torch.load(os.path.join(exp, "model_last.ckpt"),
                      weights_only=True)
    assert ckpt["params"]["backbone.clip_embd_0.weight"].shape[1] == CLIP
    assert "backbone.visual_clip_fuse.layers_1.weight" in ckpt["ema_params"]
    out = run("eval_torch.py", *common, "--ckpt_path",
              os.path.join(exp, "model_last.ckpt"), "--topk", "3")
    metrics = {k: float(v) for k, v in METRICS.findall(out)}
    assert set(metrics) == {"RelDet_mAP", "RelDet_AR@50", "RelDet_AR@100",
                            "RelTag_AP@1", "RelTag_AP@5", "RelTag_AP@10"}
    assert all(map(math.isfinite, metrics.values()))
    assert "Eval done." in out


def test_clip_corpus_items_match_jax(tmp_path):
    """What both CLIs read from the CLIP corpus: the JAX package's and the
    port's VidOR datasets give the same training pairs and validation
    items, the CLIP channels packed between the visual and the box ones."""
    from vrdone_tpu.data.datasets import VidORDataset as JVidOR
    from vrdone_tpu_torch.data.datasets import VidORDataset as TVidOR
    root = str(tmp_path)
    cfg = vrdone_x_yaml(root)
    width = 2 * VIS + 2 * CLIP + 5 + 16
    for split in ("training", "validation"):
        dc = {**cfg["dataset_config"],
              **cfg["training_dataset_config" if split == "training"
                    else "test_dataset_config"]}
        j = JVidOR({**dc, "cache_tag": "J"})
        t = TVidOR({**dc, "cache_tag": "T"})
        assert t.video_name_list == j.video_name_list
        for i, name in enumerate(t.video_name_list):
            if split == "training":
                a = j.train_pairs(j._load_video(name), None,
                                  np.random.default_rng(i))
                b = t.train_pairs(t._load_video(name), None,
                                  np.random.default_rng(i))
                feats = [(p["so_feat"], q["so_feat"]) for p, q in zip(a, b)]
            else:
                a, b = j.get_test_item(i), t.get_test_item(i)
                feats = list(zip(a["so_features_list"],
                                 b["so_features_list"]))
            assert len(a) == len(b) and feats
            for fa, fb in feats:
                assert fa.shape[-1] == fb.shape[-1] == width
                np.testing.assert_array_equal(fb, fa)
