"""The port's streaming runner (``vrdone_tpu_torch/eval/streaming.py``)
against the JAX package's (``vrdone_tpu/eval/streaming.py``): the pure
Python helpers output for output, and ``run_pair`` over a multi-chunk
sequence on converted weights with ``use_rel_pe`` on (the slice's path),
plus a single-chunk sequence against the port's own batch decode.

Random weights put some mask logits within the two frameworks' 1e-5 of
each other near the 0.5 sigmoid threshold, so the chunk groups' logits and
probabilities are compared first (5e-4 and 1e-5), and span records only
for the queries whose spans no logit within ``MARGIN`` of the threshold
can move. Scores of matched records agree within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_streaming import local_cfg
from tests.test_torch_model import jax_model_and_params, port_config
from tools.export_params_npz import flatten_params
from vrdone_tpu import config as jconfig
from vrdone_tpu.eval import streaming as jstream
from vrdone_tpu_torch import config as tconfig
from vrdone_tpu_torch.convert import load_params
from vrdone_tpu_torch.eval import streaming as tstream
from vrdone_tpu_torch.eval.decode import InferenceRunner
from vrdone_tpu_torch.models.maskvrd import MaskVRD

torch.set_num_threads(1)

CPU = torch.device("cpu")
MARGIN = 1e-3
INFER = jconfig.InferenceConfig(topk=2, feat_stride=1, pred_min_frames=1,
                                n_max_pair=100, viou_th=0.5, max_so_pair=8)


def feat_dim(cfg):
    return 2 * cfg.visual_dim + cfg.bbox_so_dim + 2 * cfg.bbox_entity_dim


def port_runner(cfg, params, chunk_len=576, chunk_batch=2):
    model = MaskVRD(port_config(cfg), device=CPU)
    load_params(model, flatten_params(params))
    return tstream.StreamingRunner(
        port_config(cfg), model,
        tconfig.InferenceConfig(**dataclasses.asdict(INFER)), feat_dim(cfg),
        chunk_len=chunk_len, chunk_batch=chunk_batch, device=CPU)


def rel_pe_cfg():
    return dataclasses.replace(local_cfg(), use_rel_pe=True)


@pytest.mark.parametrize("over", [{}, {"use_rel_pe": True},
                                  {"n_mha_win_size": 7, "max_seq_len": 96}])
def test_receptive_halo_matches_jax(over):
    cfg = dataclasses.replace(local_cfg(), **over)
    assert tstream.receptive_halo(port_config(cfg)) == \
        jstream.receptive_halo(cfg)
    with pytest.raises(ValueError, match="use_local"):
        tstream.receptive_halo(port_config(
            dataclasses.replace(cfg, use_local=False)))


@pytest.mark.parametrize("chunk_len", [None, 576])
def test_chunk_starts_match_jax(chunk_len):
    cfg = local_cfg()
    jr = jstream.StreamingRunner(cfg, None, INFER, feat_dim(cfg),
                                 chunk_len=chunk_len)
    tr = tstream.StreamingRunner(
        port_config(cfg), None, INFER, feat_dim(cfg), chunk_len=chunk_len,
        device=CPU)
    assert (tr.halo, tr.chunk_len, tr.interior) == (jr.halo, jr.chunk_len,
                                                    jr.interior)
    for t in (10, 576, 577, 1000, 5000):
        assert tr.chunk_starts(t) == jr.chunk_starts(t), t


def test_merge_spans_matches_jax():
    rng = np.random.default_rng(0)
    recs = [{"query": int(rng.integers(0, 3)),
             "pred_cat": int(rng.integers(1, 4)),
             "score": float(rng.uniform()),
             "start": int(s), "end": int(s + rng.integers(1, 30))}
            for s in rng.integers(0, 200, 60)]
    recs.append({"pred_cat": 2, "score": 0.5, "start": 3, "end": 9})

    def key(r):
        return (r.get("query", -1), r["pred_cat"], r["start"], r["end"],
                r["score"])

    ours = tstream.merge_spans([dict(r) for r in recs])
    theirs = jstream.merge_spans([dict(r) for r in recs])
    assert sorted(map(key, ours)) == sorted(map(key, theirs))
    assert len(ours) < len(recs)


def robust_queries(runner, so_feat):
    """The queries whose spans no mask logit within MARGIN of the sigmoid
    threshold can move: in every chunk, the interior's first and last
    position above +MARGIN equal those above -MARGIN."""
    t = so_feat.shape[0]
    robust = None
    for group, feats, mask in runner.chunk_groups(so_feat):
        with torch.inference_mode():
            logits = runner.model(torch.from_numpy(feats),
                                  torch.from_numpy(mask))["pred_masks"]
        for gi, (start, keep_lo, keep_hi) in enumerate(group):
            end = min(start + runner.chunk_len, t)
            lg = logits[gi, :, :end - start].numpy()
            ok = set()
            for qi in range(lg.shape[0]):
                spans = []
                for thr in (MARGIN, -MARGIN):
                    on = np.nonzero(lg[qi, keep_lo:keep_hi] > thr)[0]
                    spans.append((on[0], on[-1]) if len(on) else None)
                if spans[0] == spans[1]:
                    ok.add(qi)
            robust = ok if robust is None else robust & ok
    return robust


def records_by_key(records, queries):
    return {(r["query"], r["pred_cat"], r["start"], r["end"]): r["score"]
            for r in records if r["query"] in queries}


def test_run_pair_matches_jax_runner():
    """Four chunks in two groups of two, the last chunk's start pulled
    back to fit, at the test size with ``use_rel_pe``: chunk-group outputs,
    then the span records."""
    cfg = rel_pe_cfg()
    _, params = jax_model_and_params(cfg)
    params = jax.tree.map(jnp.asarray, params)
    jr = jstream.StreamingRunner(cfg, params, INFER, feat_dim(cfg),
                                 chunk_len=576, chunk_batch=2)
    tr = port_runner(cfg, params)
    so_feat = np.random.default_rng(4).standard_normal(
        (1000, feat_dim(cfg))).astype(np.float32)
    assert len(tr.chunk_starts(1000)) == 4

    fwd = jax.jit(lambda p, f, m: jr.model.apply({"params": p}, f, m))
    for _, feats, mask in tr.chunk_groups(so_feat):
        with torch.inference_mode():
            pt = tr.model(torch.from_numpy(feats), torch.from_numpy(mask))
        pj = fwd(params, jnp.asarray(feats), jnp.asarray(mask))
        for key in ("pred_logits", "pred_masks"):
            np.testing.assert_allclose(pt[key].numpy(), np.asarray(pj[key]),
                                       atol=5e-4, rtol=5e-4)
        np.testing.assert_allclose(
            torch.softmax(pt["pred_logits"], -1).numpy(),
            np.asarray(jax.nn.softmax(pj["pred_logits"], -1)), atol=1e-5)

    queries = robust_queries(tr, so_feat)
    assert len(queries) >= cfg.predictor.num_queries // 2
    ours = records_by_key(tr.run_pair(so_feat), queries)
    theirs = records_by_key(jr.run_pair(so_feat), queries)
    assert ours.keys() == theirs.keys() and len(ours) > 0
    for k, score in ours.items():
        np.testing.assert_allclose(score, theirs[k], atol=1e-5)


def test_single_chunk_matches_batch_decode():
    """A sequence that fits in one chunk (padded to 576 frames, with one
    padded chunk slot) gives the spans of the port's ``InferenceRunner``
    (the 192-frame bucket) for each (query, class). Biases are zero, as the
    reference initialises them: convolutions read the padded positions
    unmasked, so a nonzero LayerNorm bias there would make the output at
    the sequence's end depend on the padded length."""
    cfg = rel_pe_cfg()
    _, params = jax_model_and_params(cfg, seed=2)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.zeros_like(x) if path[-1].key == "bias" else x,
        params)
    tr = port_runner(cfg, params)
    so_feat = np.random.default_rng(3).standard_normal(
        (192, feat_dim(cfg))).astype(np.float32)
    assert tr.chunk_starts(192) == [(0, 0, 192)]
    batch = InferenceRunner(tr.cfg, tr.model, tr.infer, feat_dim(cfg),
                            device=CPU)
    scores, catids, masks = batch.run_pairs([so_feat])
    queries = robust_queries(tr, so_feat)
    assert len(queries) >= cfg.predictor.num_queries // 2
    expected = {}
    for qi in sorted(queries):
        idx = np.nonzero(masks[0][qi])[0]
        if len(idx) == 0:
            continue
        for k in range(scores[0].shape[1]):
            expected[(qi, int(catids[0][qi, k]), int(idx[0]),
                      int(idx[-1]) + 1)] = float(scores[0][qi, k])
    got = records_by_key(tr.run_pair(so_feat), queries)
    assert got.keys() == expected.keys() and len(got) > 0
    for k, score in got.items():
        np.testing.assert_allclose(score, expected[k], rtol=1e-5, atol=1e-6)
