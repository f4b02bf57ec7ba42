"""The port's own copies of the JAX package's host-side data, eval and
logging modules, pinned to their originals: each copy's source is the
original's under a two-line header, and the dataset items, ground truth,
eval records and metric dict come out identical from both packages on the
synthetic corpora."""

import dataclasses
import importlib
import inspect
import os
import pickle

import numpy as np
import pytest

from tests.synth_corpus import make_vidvrd_corpus, make_vidvrd_test_corpus
from vrdone_tpu.data.datasets import VidVRDDataset as JDataset
from vrdone_tpu.eval import convert as jconvert
from vrdone_tpu.eval.metrics import relation_metrics as jmetrics
from vrdone_tpu_torch.data.datasets import VidVRDDataset as TDataset
from vrdone_tpu_torch.eval import convert as tconvert
from vrdone_tpu_torch.eval.metrics import relation_metrics as tmetrics

COPIES = ["data.datasets", "data.features", "data.category",
          "data.memmap_cache", "data.native", "data.graph", "eval.metrics",
          "eval.convert", "utils.logging"]


@pytest.mark.parametrize("name", COPIES)
def test_copy_is_the_original(name):
    ours = inspect.getsource(importlib.import_module(f"vrdone_tpu_torch.{name}"))
    theirs = inspect.getsource(importlib.import_module(f"vrdone_tpu.{name}"))
    header, body = ours.split("\n", 2)[:2], ours.split("\n", 2)[2]
    assert header[0] == (f"# Copy of vrdone_tpu/{name.replace('.', '/')}.py, "
                         "kept so that the port imports nothing of")
    assert body == theirs


def equal(a, b, path="item"):
    """Deep equality of nested dicts, lists and arrays, types included."""
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    dirs = make_vidvrd_corpus(root, n_videos=4, n_frames=40, seed=0)
    dirs.update(make_vidvrd_test_corpus(root, n_videos=3, seed=1))
    return root, dirs


def _config(root, dirs, split):
    return {"ann_dir": dirs["ann_dir"], "info_dir": dirs["info_dir"],
            "gt_boxfeatures_dir": dirs["gt_boxfeatures_dir"],
            "test_boxfeatures_dir": dirs["test_boxfeatures_dir"],
            "cache_dir": os.path.join(root, f"cache_{split}"),
            "cache_tag": "C", "feat_stride": 1, "max_seq_len": 48,
            "split": split, "cut_max_preds": True, "proposal_max_preds": 9,
            "num_pairs": 2, "proposal_min_frames": 2, "random_stride": False,
            "stride_offset": 0}


def test_dataset_items_match(corpus):
    root, dirs = corpus
    for split in ("train", "test"):
        j = JDataset(_config(root, dirs, split))
        t = TDataset(_config(root, dirs, split))
        if split == "train":
            assert t.num_train_items() == j.num_train_items() > 0
            for i in range(j.num_train_items()):
                equal(t.get_train_item(i, np.random.default_rng(i)),
                      j.get_train_item(i, np.random.default_rng(i)))
        else:
            assert t.num_test_items() == j.num_test_items() > 0
            for i in range(j.num_test_items()):
                equal(t.get_test_item(i, np.random.default_rng(i)),
                      j.get_test_item(i, np.random.default_rng(i)))


def test_groundtruth_records_and_metrics_match(corpus):
    root, dirs = corpus
    gts = jconvert.build_groundtruth(dirs["ann_dir"], "train", "vidvrd")
    equal(tconvert.build_groundtruth(dirs["ann_dir"], "train", "vidvrd"), gts)
    assert sum(map(len, gts.values())) > 0
    # predictions: every ground-truth relation with a score, some with a
    # shortened span or another predicate
    rng = np.random.default_rng(3)
    preds = {}
    for video, insts in gts.items():
        recs = []
        for inst in insts:
            b, e = inst["duration"]
            cut = int(rng.integers(0, max(1, (e - b) // 2)))
            rec = {"triplet": list(inst["triplet"]), "duration": (b, e - cut),
                   "score": float(rng.uniform()),
                   "sub_traj": inst["sub_traj"][:e - cut - b],
                   "obj_traj": inst["obj_traj"][:e - cut - b]}
            if rng.uniform() < 0.3:
                rec["triplet"][1] = "chase"
            recs.append(rec)
        preds[video] = recs
    for th in (0.5, 0.7):
        want = jmetrics(gts, preds, viou_threshold=th)
        equal(tmetrics(gts, preds, viou_threshold=th), want)
    triplets = {"triplets": [(1, 2, 3)], "pred_durations": [(2, 5)],
                "so_trajs": [([[0, 0, 1, 1]] * 3, [[1, 1, 2, 2]] * 3)],
                "triple_scores_avg": [0.5]}
    equal(tconvert.to_eval_format("vidvrd", "v_1", triplets),
          jconvert.to_eval_format("vidvrd", "v_1", triplets))


# -- the detection path's host-side copies ------------------------------------

@pytest.mark.parametrize("name", [
    "linear_interpolate_boxes", "merge_durations", "build_traj_proposal",
    "linear_interpolate_columns", "parse_raw_track_file",
    "rebuild_raw_proposal", "rebuild_vidvrd_proposals",
    "repackage_monolithic_pickle"])
def test_proposal_functions_are_the_originals(name):
    from vrdone_tpu.data import proposals as jprop
    from vrdone_tpu_torch.data import proposals as tprop
    assert (inspect.getsource(getattr(tprop, name))
            == inspect.getsource(getattr(jprop, name)))


def _detections(rng, n_frames=14):
    """Three boxes drifting across frames with two categories, jitter, a
    frame where one is missed, and a spurious box now and then."""
    starts = np.array([[10, 10, 60, 50], [100, 40, 160, 120],
                       [30, 90, 80, 150]], np.float32)
    labels = np.array([1, 2, 1])
    out = []
    for f in range(n_frames):
        keep = np.ones(3, bool)
        if f == 6:
            keep[1] = False
        boxes = starts[keep] + 2.0 * f + rng.normal(0, 1.0, (keep.sum(), 4))
        labs = labels[keep]
        if f % 4 == 1:
            boxes = np.concatenate([boxes, rand_box(rng)])
            labs = np.concatenate([labs, [3]])
        order = rng.permutation(len(boxes))
        scores = rng.uniform(0.5, 1.0, len(boxes)).astype(np.float32)
        feats = rng.standard_normal((len(boxes), 8)).astype(np.float32)
        out.append((boxes[order].astype(np.float32), labs[order],
                    scores[order], feats[order]))
    return out


def rand_box(rng):
    xy = rng.uniform(0, 200, 2)
    return np.concatenate([xy, xy + rng.uniform(5, 40, 2)])[None]


def test_tracker_and_proposals_match_the_originals():
    """On identical detections the port's IoUTracker (on the port's
    matcher) gives the JAX tracker's tracks, and the proposal dicts built
    from them are equal."""
    from vrdone_tpu.data.proposals import build_traj_proposal as jbuild
    from vrdone_tpu.data.tracking import IoUTracker as JTracker
    from vrdone_tpu.data.tracking import iou_matrix as jiou
    from vrdone_tpu_torch.data.proposals import build_traj_proposal as tbuild
    from vrdone_tpu_torch.data.tracking import IoUTracker as TTracker
    from vrdone_tpu_torch.data.tracking import iou_matrix as tiou
    assert inspect.getsource(tiou) == inspect.getsource(jiou)
    dets = _detections(np.random.default_rng(7))
    jt, tt = JTracker(min_length=3), TTracker(min_length=3)
    for f, (boxes, labels, scores, feats) in enumerate(dets):
        jt.update(f, boxes, labels, scores, feats)
        tt.update(f, boxes, labels, scores, feats)
    want, got = jt.finish(), tt.finish()
    assert len(want) >= 3
    equal(got, want, "tracks")
    equal(tbuild("v", got, (320, 240), len(dets)),
          jbuild("v", want, (320, 240), len(dets)))


def test_rebuilt_and_repackaged_proposals_match(tmp_path):
    """Both packages' rebuild_vidvrd_proposals on the raw tracker rows of
    tests/test_proposals.py (long and short rows, a gap, a category vote,
    dropped and clipped tracklets) and an annotation with a relation, then
    repackage_monolithic_pickle on a pickle of the rebuilt proposals: the
    files are equal, dtypes included."""
    import json

    from tests.test_proposals import DIM, _raw_rows
    from vrdone_tpu.data import proposals as jprop
    from vrdone_tpu_torch.data import proposals as tprop
    raw = tmp_path / "raw"
    ann = tmp_path / "annotations" / "test"
    raw.mkdir()
    ann.mkdir(parents=True)
    for v, seed in (("v1", 5), ("v2", 6)):
        rows = _raw_rows(np.random.default_rng(seed))
        arr = np.empty(len(rows), dtype=object)
        arr[:] = [list(r) for r in rows]
        np.save(raw / f"{v}.npy", arr, allow_pickle=True)
        traj = [[{"tid": t, "bbox": {"xmin": 1.0 + f, "ymin": 2.0,
                                     "xmax": 30.0 + f, "ymax": 40.0 + t}}
                 for t in (0, 1)] for f in range(10)]
        anno = {"video_id": v, "width": 320, "height": 240,
                "frame_count": 10,
                "subject/objects": [{"tid": 0, "category": "dog"},
                                    {"tid": 1, "category": "person"}],
                "trajectories": traj,
                "relation_instances": [{"subject_tid": 0, "object_tid": 1,
                                        "predicate": "chase",
                                        "begin_fid": 2, "end_fid": 7}]}
        (ann / f"{v}.json").write_text(json.dumps(anno))
    blobs = {}
    for name, mod in (("jax", jprop), ("port", tprop)):
        out = tmp_path / name
        assert mod.rebuild_vidvrd_proposals(
            str(raw), str(tmp_path / "annotations"), str(out / "rebuilt"),
            split="test", dim_boxfeature=DIM, min_frames_th=3,
            max_proposal=2) == 2
        rebuilt = {}
        for v in ("v1", "v2"):
            with open(out / "rebuilt" / f"{v}.pkl", "rb") as f:
                rebuilt[v] = pickle.load(f)
        with open(out / "mono.pkl", "wb") as f:
            pickle.dump({v: b["traj_proposal"] for v, b in rebuilt.items()},
                        f)
        assert mod.repackage_monolithic_pickle(str(out / "mono.pkl"),
                                               str(out / "split")) == 2
        split = {}
        for v in ("v1", "v2"):
            with open(out / "split" / f"{v}.pkl", "rb") as f:
                split[v] = pickle.load(f)
        blobs[name] = (rebuilt, split)
    assert blobs["jax"][0]["v1"]["traj_proposal"]["num_proposals"] == 2
    assert len(blobs["jax"][0]["v1"]["gt_graph"]["pred_cat_ids"]) == 1
    equal(blobs["port"], blobs["jax"], "blobs")


# -- the detector-training path's copies ----------------------------------------

def test_detector_config_is_the_original():
    """The copy is the original with ``import yaml`` moved into the loader;
    both parse every detector config the same."""
    from vrdone_tpu import detector_config as jcfg
    from vrdone_tpu_torch import detector_config as tcfg
    ours = inspect.getsource(tcfg).split("\n", 3)
    assert ours[0] == ("# Copy of vrdone_tpu/detector_config.py with "
                       "``import yaml`` moved into")
    theirs = inspect.getsource(jcfg).replace(
        "from dataclasses import dataclass, replace\n\nimport yaml\n",
        "from dataclasses import dataclass, replace\n").replace(
        '(the CLI hook)."""\n    with open(path)',
        '(the CLI hook)."""\n    import yaml\n    with open(path)')
    assert ours[3] == theirs
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "detector")
    for name in sorted(os.listdir(root)):
        j = jcfg.load_detector_config(os.path.join(root, name))
        t = tcfg.load_detector_config(os.path.join(root, name))
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        if j.method == "mega":
            assert tcfg.mega_detector_kwargs(t) == jcfg.mega_detector_kwargs(j)


def test_metric_logger_is_the_original():
    from vrdone_tpu.utils import metric_logger as jml
    from vrdone_tpu_torch.utils import metric_logger as tml
    test_copy_is_the_original("utils.metric_logger")
    logs = []
    for mod in (jml, tml):
        m = mod.MetricLogger()
        for i in range(30):
            m.update(loss=float(i % 7), lr=0.1 * i)
        logs.append(str(m))
    assert logs[0] == logs[1]


DETECTION_FUNCTIONS = ["iou_matrix", "compute_motion_ious",
                       "calc_vid_prec_rec", "calc_vid_ap",
                       "eval_detection_vid", "eval_proposal_recall",
                       "eval_detection_coco"]


@pytest.mark.parametrize("name", DETECTION_FUNCTIONS)
def test_detection_metric_is_the_original(name):
    from vrdone_tpu.eval import detection as jdet
    from vrdone_tpu_torch.eval import detection as tdet
    assert (inspect.getsource(getattr(tdet, name))
            == inspect.getsource(getattr(jdet, name)))
    assert tdet.MOTION_RANGES == jdet.MOTION_RANGES


def _test_functions(module):
    return sorted(n for n in dir(module) if n.startswith("test_"))


@pytest.mark.parametrize("test_name",
                         _test_functions(importlib.import_module(
                             "tests.test_detection_eval")))
def test_detection_metrics_match_on_the_eval_tests(test_name, monkeypatch):
    """Each test of tests/test_detection_eval.py with every metric it calls
    run by both packages: the port's output equals the original's on each
    call."""
    from tests import test_detection_eval as tests_mod
    from vrdone_tpu.eval import detection as jdet
    from vrdone_tpu_torch.eval import detection as tdet
    calls = []

    def both(name):
        def run(*args, **kw):
            want = getattr(jdet, name)(*args, **kw)
            np.testing.assert_equal(getattr(tdet, name)(*args, **kw), want)
            calls.append(name)
            return want
        return run

    for name in DETECTION_FUNCTIONS:
        if hasattr(tests_mod, name):
            monkeypatch.setattr(tests_mod, name, both(name))
    getattr(tests_mod, test_name)()
    assert calls


@pytest.mark.parametrize("name", ["conv_w", "bn_params", "bottleneck_params",
                                  "stage_params", "convert"])
def test_resnet_conversion_is_the_original(name):
    from tools import convert_torch_resnet as jconv
    from vrdone_tpu_torch import convert_resnet as tconv
    assert (inspect.getsource(getattr(tconv, name))
            == inspect.getsource(getattr(jconv, name)))


def test_sample_ref_indices_is_the_original():
    from vrdone_tpu.models.detector_train import sample_ref_indices as jref
    from vrdone_tpu_torch.models.detector_train import (
        sample_ref_indices as tref)
    assert inspect.getsource(tref) == inspect.getsource(jref)
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    for fid, seg in [(0, 30), (15, 30), (29, 30), (5, 6), (1, 1)]:
        equal(tref(b, fid, seg), jref(a, fid, seg))


@pytest.mark.parametrize("name", ["load_frame", "resize_and_pad",
                                  "coco_index", "sample_frames"])
def test_train_detector_host_functions_are_the_originals(name):
    import train_detector_torch as tcli
    from tools import train_detector as jcli
    assert (inspect.getsource(getattr(tcli, name))
            == inspect.getsource(getattr(jcli, name)))


def test_method_ref_offsets_are_the_original():
    from vrdone_tpu.models.detector_train import METHOD_REF_OFFSETS as joff
    from vrdone_tpu_torch.models.detector_train import (
        METHOD_REF_OFFSETS as toff)
    assert toff == joff


@pytest.mark.parametrize("method", ["rdn", "fgfa", "dff", "base"])
def test_sample_method_refs_is_the_original(method):
    from vrdone_tpu.models.detector_train import sample_method_refs as jref
    from vrdone_tpu_torch.models.detector_train import (
        sample_method_refs as tref)
    assert inspect.getsource(tref) == inspect.getsource(jref)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for fid, seg, n in [(0, 40, None), (20, 40, None), (39, 40, 3),
                        (3, 5, 1), (0, 1, None)]:
        if method == "base" and n:
            continue              # one offset: no second ref to draw
        equal(tref(b, method, fid, seg, ref_num=n),
              jref(a, method, fid, seg, ref_num=n))


def test_fgfa_stream_indices_is_the_original():
    """The port's fgfa_stream_indices over its window_indices gives the JAX
    package's windows (the prefill and the clamp at both ends)."""
    from vrdone_tpu.models.flownet import fgfa_stream_indices as jidx
    from vrdone_tpu_torch.models.flownet import fgfa_stream_indices as tidx
    for seg in (1, 5, 19, 40):
        for t in range(seg):
            for kw in ({}, {"window": 3, "key_loc": 1}):
                np.testing.assert_array_equal(
                    tidx(t, seg, **kw).numpy(), np.asarray(jidx(t, seg, **kw)))
