"""``train_torch.py`` end to end on the CPU: two epochs on the synthetic
VidVRD corpus, a third after ``--auto_resume``, then ``eval_torch.py`` on
its checkpoint, whose metric dict has ``eval.py``'s keys and finite
values; and one epoch each in bf16, in bf16 with remat and in fp32 with
remat, each checkpoint evaluated."""

import math
import os
import re
import subprocess
import sys

import pytest
import torch
import yaml

from tests.synth_corpus import make_vidvrd_corpus, make_vidvrd_test_corpus
from tests.test_cli_e2e import tiny_yaml
from tests.test_torch_eval import METRICS
from tests.test_torch_model import REPO


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
