"""The port's eval path against the JAX package's: the mirrored config,
batching and decode helpers (pinned field for field and output for output
so the copies cannot drift), the bucketed InferenceRunner, and
``eval_torch.py`` end to end on an npz exported from an orbax checkpoint.

Model outputs agree to the whole-model tolerance of 5e-4
(tests/test_torch_model.py); the decoded triplets are compared exactly:
a mask logit within that tolerance of 0 could flip a frame across the 0.5
sigmoid threshold, and these seeded inputs have none.
"""

import dataclasses
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml


from tests.synth_corpus import make_vidvrd_test_corpus
from tests.test_cli_e2e import tiny_yaml
from tests.test_model_parity import small_cfg
from tests.test_torch_model import (REPO, jax_model_and_params,
                                    port_config)
from tools.export_params_npz import export, flatten_params
from vrdone_tpu import config as jconfig
from vrdone_tpu.data import batching as jbatching
from vrdone_tpu.eval import decode as jdecode
from vrdone_tpu_torch import config as tconfig
from vrdone_tpu_torch.convert import load_params
from vrdone_tpu_torch.data import batching as tbatching
from vrdone_tpu_torch.eval import decode as tdecode
from vrdone_tpu_torch.models.maskvrd import MaskVRD

torch.set_num_threads(1)

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# mirrored helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["PredictorConfig", "ModelConfig",
                                  "InferenceConfig"])
def test_config_fields_match(name):
    ours = [(f.name, str(f.type), f.default, f.default_factory)
            for f in dataclasses.fields(getattr(tconfig, name))]
    theirs = [(f.name, str(f.type), f.default, f.default_factory)
              for f in dataclasses.fields(getattr(jconfig, name))]
    assert [o[:3] for o in ours] == [t[:3] for t in theirs]
    assert ([o[3] is dataclasses.MISSING for o in ours]
            == [t[3] is dataclasses.MISSING for t in theirs])


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(REPO, "configs", "*.yaml"))))
def test_config_loading_matches(path):
    raw_t = tconfig.load_yaml_config(path)
    raw_j = jconfig.load_yaml_config(path)
    assert raw_t == raw_j
    ct = tconfig.model_config_from_yaml(raw_t)
    cj = jconfig.model_config_from_yaml(raw_j)
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    for prop in ("mha_win_size", "fpn_strides", "max_div_factor"):
        assert getattr(ct, prop) == getattr(cj, prop), prop


def test_batching_matches():
    rng = np.random.default_rng(0)
    lengths = rng.integers(2, 800, size=200)
    for max_len, div in [(96, 48), (512, 256), (48, 48)]:
        np.testing.assert_array_equal(
            tbatching.eval_bucket_lengths(lengths, max_len, div),
            jbatching.eval_bucket_lengths(lengths, max_len, div))
    seqs = [rng.standard_normal((n, 5)).astype(np.float32)
            for n in (3, 17, 30)]
    bt, nt = tbatching.pack_eval_bucket(seqs, 32, 8, 5)
    bj, nj = jbatching.pack_eval_bucket(seqs, 32, 8, 5)
    assert nt == nj
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k])
    for n in range(1, 300, 7):
        assert tdecode._pack_size(n, 200) == jdecode._pack_size(n, 200)


def synthetic_item(rng, lengths, feat_dim):
    """One video: a trajectory per pair end, both spanning the pair."""
    n = len(lengths)
    sids, oids, durations, boxes = [], [], [], []
    for i, t in enumerate(lengths):
        start = int(rng.integers(0, 5))
        for _ in range(2):
            durations.append([start, start + t])
            boxes.append(rng.uniform(0, 100, (t, 4)).astype(np.float32))
        sids.append(2 * i)
        oids.append(2 * i + 1)
    return {
        "sids": np.asarray(sids), "oids": np.asarray(oids),
        "cat_ids": rng.integers(1, 30, 2 * n),
        "cat_scores": rng.uniform(0.1, 1.0, 2 * n).astype(np.float32),
        "traj_durations": np.asarray(durations),
        "bboxes_list": boxes,
        "so_features_list": [rng.standard_normal((t, feat_dim))
                              .astype(np.float32) for t in lengths],
        "so_offset": np.zeros(n, np.int64),
    }


def test_decode_video_matches():
    rng = np.random.default_rng(1)
    lengths = [20, 7, 33]
    item = synthetic_item(rng, lengths, 4)
    q, k = 5, 3
    scores = [rng.uniform(size=(q, k)).astype(np.float32) for _ in lengths]
    catids = [rng.integers(1, 50, (q, k)) for _ in lengths]
    masks = [rng.uniform(size=(q, t)) > 0.6 for t in lengths]
    for infer in (jconfig.InferenceConfig(topk=k, n_max_pair=10000),
                  jconfig.InferenceConfig(topk=k, pred_min_frames=4,
                                          n_max_pair=7)):
        infer_t = tconfig.InferenceConfig(**dataclasses.asdict(infer))
        assert (tdecode.decode_video(item, scores, catids, masks, infer_t)
                == jdecode.decode_video(item, scores, catids, masks, infer))


# ---------------------------------------------------------------------------
# the runner, port against JAX
# ---------------------------------------------------------------------------

def runner_pair(cfg, infer, feat_dim, seed=0):
    _, params = jax_model_and_params(cfg, seed=seed)
    jr = jdecode.InferenceRunner(cfg, params, infer, feat_dim)
    tcfg = port_config(cfg)
    model = MaskVRD(tcfg, device=CPU)
    load_params(model, flatten_params(params))
    tr = tdecode.InferenceRunner(
        tcfg, model, tconfig.InferenceConfig(**dataclasses.asdict(infer)),
        feat_dim, device=CPU)
    return jr, tr


def test_inference_runner_matches_jax():
    cfg = small_cfg(max_so_pair=8)
    feat_dim = 2 * cfg.visual_dim + 5 + 16
    infer = jconfig.InferenceConfig(topk=3, n_max_pair=10000, max_so_pair=8)
    jr, tr = runner_pair(cfg, infer, feat_dim)
    rng = np.random.default_rng(2)
    # 48-frame bucket and, past max_seq_len, the 96-frame one
    lengths = [30, 48, 9, 70, 61]
    item = synthetic_item(rng, lengths, feat_dim)
    assert len(set(jbatching.eval_bucket_lengths(
        np.asarray(lengths), cfg.max_seq_len, cfg.max_div_factor))) == 2

    st, ct, mt = tr.run_pairs(item["so_features_list"])
    sj, cj, mj = jr.run_pairs(item["so_features_list"])
    for i in range(len(lengths)):
        np.testing.assert_allclose(st[i], sj[i], atol=5e-4, rtol=5e-4)
        np.testing.assert_array_equal(ct[i], cj[i])
        np.testing.assert_array_equal(mt[i], mj[i])
    ours = tdecode.decode_video(item, st, ct, mt, tr.infer)
    theirs = jdecode.decode_video(item, sj, cj, mj, jr.infer)
    assert ours is not None and theirs is not None
    assert ours["triplets"] == theirs["triplets"]
    assert ours["pred_durations"] == theirs["pred_durations"]
    np.testing.assert_allclose(ours["triple_scores_avg"],
                               theirs["triple_scores_avg"], atol=5e-4)


# ---------------------------------------------------------------------------
# eval_torch.py end to end
# ---------------------------------------------------------------------------

METRICS = re.compile(r"(RelDet_mAP|RelDet_AR@50|RelDet_AR@100|RelTag_AP@1|"
                     r"RelTag_AP@5|RelTag_AP@10): ([0-9.]+)")


def test_eval_torch_cli_matches_jax_runner(tmp_path):
    """JAX init -> orbax checkpoint -> tools/export_params_npz.py ->
    eval_torch.py on the synthetic test corpus: the metric dict equals the
    JAX runner's on the same items."""
    import orbax.checkpoint as ocp
    from vrdone_tpu.data.datasets import VidVRDDataset
    from vrdone_tpu.eval.convert import build_groundtruth, to_eval_format
    from vrdone_tpu.eval.metrics import relation_metrics

    root = str(tmp_path)
    dirs = make_vidvrd_test_corpus(root, n_videos=3, seed=5)
    dirs.update({"ann_dir": os.path.join(root, "annotations"),
                 "gt_boxfeatures_dir": dirs["test_boxfeatures_dir"]})
    raw = tiny_yaml(root, dirs)
    cfg_path = os.path.join(root, "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(raw, f)

    config = jconfig.load_yaml_config(cfg_path)
    config["dataset_config"].update(config["test_dataset_config"])
    cfg = jconfig.model_config_from_yaml(config)
    _, params = jax_model_and_params(cfg, seed=4)
    ckpt = os.path.join(root, "ckpt")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(ckpt, {"params": params, "ema_params": params})
    ckptr.wait_until_finished()
    npz = os.path.join(root, "params.npz")
    flat = export(ckpt, npz)
    assert flat.keys() == flatten_params(params).keys()

    # the JAX runner on the same items
    ic = config["inference_config"]
    infer = jconfig.InferenceConfig(
        topk=3, feat_stride=ic["feat_stride"],
        pred_min_frames=ic["pred_min_frames"], n_max_pair=ic["n_max_pair"],
        viou_th=ic["viou_th"], max_so_pair=cfg.max_so_pair)
    feat_dim = 2 * cfg.visual_dim + cfg.bbox_so_dim + 2 * cfg.bbox_entity_dim
    runner = jdecode.InferenceRunner(cfg, params, infer, feat_dim)
    dataset = VidVRDDataset(config["dataset_config"])
    preds = {}
    for idx in range(dataset.num_test_items()):
        item = dataset.get_test_item(idx)
        if item is None:
            continue
        triplets = jdecode.infer_video(runner, item)
        if triplets is not None:
            preds.update(to_eval_format("vidvrd", item["video_name"],
                                        triplets))
    assert preds, "the corpus decoded no triplets"
    gts = build_groundtruth(config["dataset_config"]["ann_dir"], "test",
                            "vidvrd")
    theirs = relation_metrics(gts, preds, viou_threshold=infer.viou_th)

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, "eval_torch.py", "--data_name", "vidvrd",
         "--cfg_path", cfg_path, "--exp_dir", os.path.join(root, "exp"),
         "--ckpt_path", npz, "--topk", "3", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    ours = {k: float(v) for k, v in METRICS.findall(r.stdout)}
    assert set(ours) == set(theirs), r.stdout[-2000:]
    for k, v in theirs.items():
        assert ours[k] == pytest.approx(v, abs=1e-6), k
    assert "Eval done." in r.stdout
