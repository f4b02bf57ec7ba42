"""Eval forward over bucketed SO-pair batches + triplet decoding
(counterpart of ``vrdone_tpu/eval/decode.py``).

The SO pairs of a video are packed into a small family of (pack, length)
bucket shapes, run through the model, and decoded on the host into scored
(subject, predicate, object, span) triplets. Bucketed padding does not
change the outputs at valid positions: every masked op gives padded keys
zero weight. ``decode_video`` is a copy of the JAX package's (pure numpy),
pinned to it output for output by ``tests/test_torch_eval.py``.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import InferenceConfig, ModelConfig
from ..data import batching
from ..models.maskvrd import MaskVRD

PACK_LADDER = (8, 32, 128, 256)


def _pack_size(n: int, max_so_pair: int) -> int:
    for p in PACK_LADDER:
        if n <= p:
            return min(p, max(max_so_pair, 8))
    return PACK_LADDER[-1]


def _indexed(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class InferenceRunner:
    """Runs the eval forward of ``model`` (a MaskVRD already on ``device``)
    over the SO pairs of one video at a time.

    With ``devices`` (data-parallel eval, ``eval_torch.py --eval_dp``) each
    device holds a replica of ``model``, each bucketed pack is rounded up
    to a multiple of their number, and each replica runs its contiguous
    rows, as the JAX runner shards the pack axis over its dp mesh; the
    outputs are joined in row order."""

    def __init__(self, cfg: ModelConfig, model: MaskVRD,
                 infer: InferenceConfig, feat_dim: int, *,
                 device: Optional[torch.device] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        if (device is None) == (devices is None):
            raise ValueError("give exactly one of device and devices")
        self.cfg = cfg
        self.model = model
        self.infer = infer
        self.feat_dim = feat_dim
        self.devices = [_indexed(d) for d in (devices or [device])]
        self.device = self.devices[0]
        home = next(model.parameters()).device
        self.replicas = [model if d == home else copy.deepcopy(model).to(d)
                         for d in self.devices]

    @torch.inference_mode()
    def _forward(self, feats: np.ndarray, mask: np.ndarray):
        n = len(self.replicas)
        rows = feats.shape[0] // n
        outs = []
        for i, (model, dev) in enumerate(zip(self.replicas, self.devices)):
            # every replica's work is queued before any result is read
            sl = slice(i * rows, (i + 1) * rows)
            preds = model(torch.from_numpy(feats[sl]).to(dev),
                          torch.from_numpy(mask[sl]).to(dev))
            probs = torch.softmax(preds["pred_logits"], dim=-1)
            scores, catids = probs[..., 1:].topk(self.infer.topk, dim=-1)
            outs.append((scores, catids + 1,
                         torch.sigmoid(preds["pred_masks"]) > 0.5))
        return tuple(np.concatenate([o[j].cpu().numpy() for o in outs])
                     for j in range(3))

    def run_pairs(self, so_features: list[np.ndarray]):
        """Forward all SO-pair sequences of one video.

        Returns (scores (N, Q, topk), catids (N, Q, topk),
        masks_bin (list of (Q, T_i) bool)) in input order.
        """
        n = len(so_features)
        lengths = np.asarray([s.shape[0] for s in so_features])
        pad_lens = batching.eval_bucket_lengths(
            lengths, self.cfg.max_seq_len, self.cfg.max_div_factor)

        scores = [None] * n
        catids = [None] * n
        masks = [None] * n
        max_pack = min(self.infer.max_so_pair, PACK_LADDER[-1])
        for pad_len in np.unique(pad_lens):
            idxs = np.nonzero(pad_lens == pad_len)[0]
            for chunk_start in range(0, len(idxs), max_pack):
                chunk = idxs[chunk_start:chunk_start + max_pack]
                pack = _pack_size(len(chunk), self.infer.max_so_pair)
                # the pack splits evenly over the replicas
                pack = -(-pack // len(self.devices)) * len(self.devices)
                batch, _ = batching.pack_eval_bucket(
                    [so_features[i] for i in chunk], int(pad_len), pack,
                    self.feat_dim)
                s, c, m = self._forward(batch["feats"], batch["seq_mask"])
                for j, i in enumerate(chunk):
                    scores[i] = s[j]
                    catids[i] = c[j]
                    masks[i] = m[j][:, :lengths[i]]
        return scores, catids, masks


def decode_video(item: dict, scores, catids, masks_bin,
                 infer: InferenceConfig) -> dict | None:
    """Binary temporal masks -> scored triplets with frame spans and
    trajectories (reference maskvrd.py:241-337)."""
    sids = np.asarray(item["sids"])
    oids = np.asarray(item["oids"])
    cat_ids = np.asarray(item["cat_ids"])
    cat_scores = np.asarray(item["cat_scores"])
    traj_durations = np.asarray(item["traj_durations"])
    bboxes_list = item["bboxes_list"]
    so_offset = np.asarray(item["so_offset"])

    triplets, triple_scores, so_trajs, pred_durations, so_tids = \
        [], [], [], [], []

    for so_idx, (s_id, o_id) in enumerate(zip(sids, oids)):
        q_scores = scores[so_idx].reshape(-1)      # (Q*topk,)
        q_catids = catids[so_idx].reshape(-1)
        q_masks = np.repeat(masks_bin[so_idx], scores[so_idx].shape[-1],
                            axis=0)                # (Q*topk, T)
        s_dur = traj_durations[s_id]
        o_dur = traj_durations[o_id]
        so_start = max(s_dur[0], o_dur[0])
        so_end = min(s_dur[1], o_dur[1])
        s_diff = so_start - s_dur[0]
        o_diff = so_start - o_dur[0]
        raw_len = so_end - so_start
        offset = int(so_offset[so_idx])

        for uid in range(len(q_scores)):
            true_idx = np.nonzero(q_masks[uid])[0]
            if len(true_idx) == 0:
                continue
            start = int(true_idx[0]) * infer.feat_stride + offset
            end = int(true_idx[-1]) * infer.feat_stride + offset + 1
            if not (0 <= start and end <= raw_len):
                raise ValueError(f"span [{start}, {end}) outside the pair's "
                                 f"{raw_len} frames")
            if end - start < infer.pred_min_frames:
                continue
            s_traj = bboxes_list[s_id][s_diff + start:s_diff + end]
            o_traj = bboxes_list[o_id][o_diff + start:o_diff + end]
            if len(s_traj) != len(o_traj):
                raise ValueError(f"pair ({s_id}, {o_id}): trajectories of "
                                 f"{len(s_traj)} and {len(o_traj)} boxes")
            pred_durations.append([int(so_start + start),
                                   int(so_start + end)])
            so_trajs.append([np.asarray(s_traj).tolist(),
                             np.asarray(o_traj).tolist()])
            triplets.append([int(cat_ids[s_id]), int(q_catids[uid]),
                             int(cat_ids[o_id])])
            triple_scores.append([float(cat_scores[s_id]),
                                  float(q_scores[uid]),
                                  float(cat_scores[o_id])])
            so_tids.append([int(s_id), int(o_id)])

    if len(triplets) == 0:
        return None

    triple_scores = np.asarray(triple_scores)
    avg = triple_scores.mean(axis=-1)
    order = np.argsort(-avg, kind="stable")[:infer.n_max_pair]
    return {
        "triplets": [triplets[i] for i in order],
        "triple_scores": triple_scores[order].tolist(),
        "triple_scores_avg": avg[order].tolist(),
        "so_trajs": [so_trajs[i] for i in order],
        "pred_durations": [pred_durations[i] for i in order],
        "so_tids": [so_tids[i] for i in order],
    }


def infer_video(runner: InferenceRunner, item: dict) -> dict | None:
    scores, catids, masks = runner.run_pairs(item["so_features_list"])
    return decode_video(item, scores, catids, masks, runner.infer)
