"""The port's feature extractors (``extract_gt_features_torch.py``,
``extract_proposal_features_torch.py``) and their checkpoint loader
(``vrdone_tpu_torch.convert.load_extractor_params``) against the JAX tools
(``tools/extract_gt_features.py``, ``tools/extract_proposal_features.py``)
on the JAX tools' test configuration (``tests/test_detector_cli.py``: R
(1, 1, 1), 4 box slots, window 3, global 2, 5 classes, 64 x 96 JPEGs).

The JAX extractor's parameters come from its own
``init_extractor_params`` and cross as the ``.npz`` that
``tools/export_params_npz.py`` writes; both port CLIs read it with
``--ckpt_path`` on the CPU. Limits: keys, frame ids and tids exactly;
fp32 features within 5e-4 of max |ref| (the limit of
``tests/test_torch_detector.py::test_extract_video_features_matches_jax``:
a dozen chained convolutions, fc0 and the MEGA stream summed in other
orders); bf16 features within the larger of 5e-2 and twice JAX's own
bf16-to-fp32 gap (the MEGA scan over random weights turns rounding into
near-ties in both frameworks).
"""

import ast
import inspect
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import extract_gt_features_torch as tgt
import extract_proposal_features_torch as tprop
from tools import extract_gt_features as jgt
from tools import extract_proposal_features as jprop
from tools.export_params_npz import flatten_params
from vrdone_tpu.models.detector import MegaDetector as JDetector
from vrdone_tpu_torch.convert import (load_extractor_params, load_npz,
                                      params_to_jax)
from vrdone_tpu_torch.models.detector import MegaDetector

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO, T, H, W, SLOTS = "vidB", 6, 64, 96, 4
TINY = ["--num_classes", "5", "--resnet_layers", "1,1,1", "--window", "3",
        "--global_size", "2", "--device", "cpu"]
FP32_TOL = 5e-4
BF16_TOL = 5e-2


def box(x0, y0, x1, y1):
    return {"xmin": x0, "ymin": y0, "xmax": x1, "ymax": y1}


def annotation():
    """tid 0 drifts over every annotated frame, tid 1 joins at frame 1,
    frame 3 carries no box (it stays out of the stream) and frame 4 holds
    five boxes, more than the slots (the last is cut)."""
    traj = []
    for f in range(T):
        frame = [{"tid": 0, "bbox": box(5 + 2 * f, 6, 40 + 2 * f, 44)}]
        if f >= 1:
            frame.append({"tid": 1, "bbox": box(50, 10 + f, 90, 60)})
        if f == 4:
            frame += [{"tid": k, "bbox": box(3 * k, 3 * k, 20 + 3 * k, 30)}
                      for k in (2, 3, 4)]
        traj.append([] if f == 3 else frame)
    return {"video_id": VIDEO, "height": H, "width": W, "frame_count": T,
            "subject/objects": [{"tid": k, "category": "dog"}
                                for k in range(5)],
            "trajectories": traj, "relation_instances": []}


def proposal():
    """Three tracklets in the proposal file's layout with torch tensors,
    as BIG's pickles hold them; boxes reach past the frame (clipped)."""
    durations = [[0, 5], [1, 3], [2, 5]]
    rng = np.random.default_rng(3)
    boxes = []
    for s, e in durations:
        xy = rng.uniform(-8, 60, (e - s + 1, 2))
        wh = rng.uniform(10, 50, (e - s + 1, 2))
        boxes.append(torch.tensor(np.concatenate([xy, xy + wh], 1),
                                  dtype=torch.float32))
    return {"MAX_PROPOSAL": 50, "video_name": VIDEO,
            "cat_ids": torch.tensor([1, 2, 3]),
            "scores": torch.tensor([0.9, 0.8, 0.7]),
            "bboxes_list": boxes,
            "traj_durations": torch.tensor(durations, dtype=torch.int64),
            "features_list": [torch.zeros(len(b), 8) for b in boxes],
            "num_proposals": 3, "dim_feat": 8, "video_len": T,
            "video_wh": (W, H)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Frames, the annotation and proposal directories, the JAX
    extractor's parameters and their ``.npz``."""
    root = tmp_path_factory.mktemp("extract")
    rng = np.random.default_rng(2)
    frames = root / "frames" / VIDEO
    frames.mkdir(parents=True)
    for f in range(T):
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        img[10:40, 20:60] = 200
        Image.fromarray(img).save(frames / f"{f + 1:06d}.jpg")
    (root / "anno").mkdir()
    (root / "anno" / f"{VIDEO}.json").write_text(json.dumps(annotation()))
    (root / "proposals").mkdir()
    with open(root / "proposals" / f"{VIDEO}.pkl", "wb") as f:
        pickle.dump({"traj_proposal": proposal()}, f)
    det = jdetector(SLOTS, SLOTS)
    params = jgt.init_extractor_params(det, str(root / "frames"), VIDEO,
                                       SLOTS, seed=0)
    np.savez(root / "extractor.npz", **flatten_params(params["params"]))
    return root, params


def jdetector(base_num, advanced):
    return JDetector(num_classes=5, resnet_layers=(1, 1, 1),
                     base_num=base_num, advanced_num_override=advanced,
                     window=3, key_loc=1, global_size=2, global_enable=True)


def close(got, want, tol):
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def same_frames(got, want, tol):
    """Keys, frame ids and tids exactly, features within tol of max |ref|
    over the whole video."""
    assert list(got) == list(want) and len(want) > 0
    for fid in want:
        assert got[fid]["frame_id"] == want[fid]["frame_id"] == fid
        assert got[fid]["tids"].dtype == np.int64
        np.testing.assert_array_equal(got[fid]["tids"], want[fid]["tids"])
        assert got[fid]["visual_features"].dtype == np.float32
        assert (got[fid]["visual_features"].shape
                == want[fid]["visual_features"].shape
                == (len(want[fid]["tids"]), 1024))
    close(np.concatenate([got[f]["visual_features"] for f in got]),
          np.concatenate([np.asarray(want[f]["visual_features"])
                          for f in want]), tol)


# -- the copies ---------------------------------------------------------------

@pytest.mark.parametrize("ours,theirs,name", [
    (tgt, jgt, "load_frame"), (tgt, jgt, "_frame_rois"),
    (tprop, jprop, "_np"), (tprop, jprop, "frame_table")])
def test_copied_functions_are_the_originals(ours, theirs, name):
    assert (inspect.getsource(getattr(ours, name))
            == inspect.getsource(getattr(theirs, name)))


def test_frame_table_and_frame_inputs_match(corpus):
    root, _ = corpus
    want, got = jprop.frame_table(proposal()), tprop.frame_table(proposal())
    assert got[0] == want[0] == list(range(T))
    for a, b in zip(got[1:3], want[1:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1].shape == (T, 8, 4)          # 3 live at most -> 8 slots
    assert got[1][..., 2].max() <= W - 1 and got[1].min() >= 0
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(a, b)
    frame = annotation()["trajectories"][4]
    for a, b in zip(tgt._frame_rois(frame, SLOTS),
                    jgt._frame_rois(frame, SLOTS)):
        np.testing.assert_array_equal(a, b)
    for f in (0, T - 1):
        np.testing.assert_array_equal(
            tgt.load_frame(str(root / "frames"), VIDEO, f),
            jgt.load_frame(str(root / "frames"), VIDEO, f))


def test_cli_flags_match_the_jax_tools():
    """Every flag of each JAX tool, with its default, plus --device."""
    for script, ours, required in (
            ("tools/extract_gt_features.py", tgt, ["--anno_dir", "a"]),
            ("tools/extract_proposal_features.py", tprop,
             ["--proposal_dir", "p"])):
        tree = ast.parse(open(os.path.join(REPO, script)).read())
        want = {}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", "") == "add_argument"):
                kw = {k.arg: k.value for k in node.keywords}
                flag = node.args[0].value.lstrip("-")
                want[flag] = (ast.literal_eval(kw["default"])
                              if "default" in kw else None)
        args = vars(ours.parse_args([*required, "--frames_dir", "f",
                                     "--out_dir", "o"]))
        assert set(args) == set(want) | {"device"}
        assert args.pop("device") == "cuda"
        for flag in ("anno_dir", "proposal_dir", "frames_dir", "out_dir"):
            want.pop(flag, None)
            args.pop(flag, None)
        assert args == want


# -- the CLIs against the JAX tools --------------------------------------------

def test_gt_cli_matches_jax(corpus, tmp_path):
    root, params = corpus
    out = tmp_path / "gt"
    tgt.main(["--anno_dir", str(root / "anno"), "--frames_dir",
              str(root / "frames"), "--out_dir", str(out), "--ckpt_path",
              str(root / "extractor.npz"), "--box_slots", str(SLOTS), *TINY])
    with open(out / f"{VIDEO}.pkl", "rb") as f:
        got = pickle.load(f)
    want = jgt.extract_video(jdetector(SLOTS, SLOTS), params, annotation(),
                             str(root / "frames"), VIDEO, box_slots=SLOTS)
    assert list(want) == [1, 2, 3, 5, 6]       # 1-based, frame 4 unannotated
    assert want[5]["tids"].tolist() == [0, 1, 2, 3]
    same_frames(got, want, FP32_TOL)


def test_proposal_cli_matches_jax(corpus, tmp_path):
    """A subprocess: the script finds its sibling's ``load_frame``."""
    root, params = corpus
    out = tmp_path / "prop"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(
        [sys.executable, os.path.join(REPO,
                                      "extract_proposal_features_torch.py"),
         "--proposal_dir", str(root / "proposals"), "--frames_dir",
         str(root / "frames"), "--out_dir", str(out), "--ckpt_path",
         str(root / "extractor.npz"), *TINY],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"{VIDEO}: {T} frames" in r.stdout
    with open(out / f"{VIDEO}.pkl", "rb") as f:
        got = pickle.load(f)
    want = jprop.extract_video(jdetector(8, 8), params, proposal(),
                               str(root / "frames"), VIDEO)
    same_frames(got, want, FP32_TOL)


def test_gt_extraction_bf16_matches_jax(corpus):
    root, params = corpus
    jdet = jdetector(SLOTS, SLOTS)
    det = MegaDetector(num_classes=5, resnet_layers=(1, 1, 1),
                       base_num=SLOTS, advanced_num_override=SLOTS, window=3,
                       key_loc=1, global_size=2, device=torch.device("cpu"))
    load_extractor_params(det, load_npz(str(root / "extractor.npz")))
    run = dict(frames_dir=str(root / "frames"), video=VIDEO,
               box_slots=SLOTS)
    ref32 = jgt.extract_video(jdet, params, annotation(), **run)
    want = jgt.extract_video(jdet, params, annotation(),
                             compute_dtype="bfloat16", **run)
    got = tgt.extract_video(det, annotation(), compute_dtype="bfloat16",
                            **run)

    def stack(d):
        return np.concatenate([np.asarray(d[f]["visual_features"])
                               for f in d])
    own = np.abs(stack(want) - stack(ref32)).max() / np.abs(stack(ref32)).max()
    same_frames(got, want, max(BF16_TOL, 2 * own))


# -- the loader ---------------------------------------------------------------

def port_extractor(seed=5):
    return MegaDetector(num_classes=5, resnet_layers=(1, 1, 1), base_num=SLOTS,
                        advanced_num_override=SLOTS, window=3, key_loc=1,
                        global_size=2, device=torch.device("cpu"),
                        generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def whole():
    """A whole detector's parameters (what convert_mega_checkpoint_torch.py
    writes), and a detector that the refused loads leave untouched."""
    det = port_extractor()
    return params_to_jax(det.state_dict()), det


@pytest.mark.parametrize("kind", ["extractor", "whole detector"])
def test_loader_accepts_both_checkpoints(corpus, whole, kind):
    root, _ = corpus
    flat = load_npz(str(root / "extractor.npz"))
    assert not any(k.startswith(("rpn/", "box_head/cls_score",
                                 "box_head/bbox_pred")) for k in flat)
    if kind == "whole detector":
        flat = whole[0]
    det = port_extractor(seed=6)
    rpn = det.rpn.conv.weight.clone()
    load_extractor_params(det, flat)
    mine = params_to_jax(det.state_dict())
    for k, v in flat.items():
        np.testing.assert_array_equal(mine[k], v)
    if kind == "extractor":     # absent parts keep their values
        assert torch.equal(det.rpn.conv.weight, rpn)


@pytest.mark.parametrize("fault", ["missing mega key", "extra key",
                                   "rpn without predictor", "shape"])
def test_loader_refuses(corpus, whole, fault):
    root, _ = corpus
    flat = load_npz(str(root / "extractor.npz"))
    if fault == "missing mega key":
        del flat[next(k for k in flat if k.startswith("mega/"))]
    elif fault == "extra key":
        flat["mega/extra/kernel"] = np.zeros((2, 2), np.float32)
    elif fault == "rpn without predictor":
        flat.update({k: v for k, v in whole[0].items()
                     if k.startswith("rpn/")})
    else:
        k = next(k for k in flat if k.startswith("box_head/c5"))
        flat[k] = np.zeros((1,) + flat[k].shape, flat[k].dtype)
    det = whole[1]
    before = {k: v.clone() for k, v in det.state_dict().items()}
    with pytest.raises(RuntimeError):
        load_extractor_params(det, flat)
    assert all(torch.equal(v, before[k])
               for k, v in det.state_dict().items())
