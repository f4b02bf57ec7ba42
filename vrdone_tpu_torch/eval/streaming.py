"""Streaming long-video relation detection (counterpart of
``vrdone_tpu/eval/streaming.py``).

An unbounded SO-pair sequence is cut into fixed-size chunks with an
overlap-save halo. In the local-attention configuration (``use_local``)
every temporal operator has a finite receptive field (band attention
+-w, depthwise convs +-1, the strided pyramid), so features at positions at
least ``halo`` frames from a chunk edge equal the full-sequence run's. Each
chunk therefore runs at one fixed shape with ``halo`` frames of context on
each side and keeps only its interior. Per-chunk query decoding emits
spans in global coordinates, and spans of the same (query, predicate)
that meet across a chunk boundary are stitched. Memory is O(chunk) at any
video length.

``receptive_halo``, ``merge_spans`` and ``StreamingRunner.chunk_starts``
are copies of the JAX package's (pure Python), pinned to them by
``tests/test_torch_streaming.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import InferenceConfig, ModelConfig
from ..models.maskvrd import MaskVRD


def receptive_halo(cfg: ModelConfig) -> int:
    """Upper bound on the one-sided temporal receptive field of
    backbone+FPN features, in full-resolution frames, rounded up to
    ``max_div_factor``.

    Per stem iteration: encoder block (qkv conv +-1, band +-w) plus two
    mutual cross-attention layers (each qkv conv +-1, band +-w). Branch
    level l runs at stride 2^l; its +-(w+2) support costs 2^l full-res
    frames per step, plus the FPN top-down 3-convs. Requires use_local=True
    (dense cross attention would make the field global).
    """
    if not cfg.use_local:
        raise ValueError("streaming requires the local-attention config "
                         "(use_local=True)")
    w = cfg.n_mha_win_size // 2
    halo = 2 * (cfg.embd_kernel_size // 2) * 2   # embed convs (both streams)
    halo += cfg.backbone_arch[1] * 3 * (w + 2)   # stem + s/o mutual attn
    halo += 4                                     # bbox/fuse convs
    for lvl in range(1, cfg.backbone_arch[2] + 1):
        halo += (w + 3) * (2 ** lvl)              # branch block at stride 2^l
        halo += 2 * (2 ** lvl)                    # FPN lateral/fpn convs
    q = cfg.max_div_factor
    return ((halo + q - 1) // q) * q


def merge_spans(records: list[dict]) -> list[dict]:
    """Stitch spans of the same (query, predicate) that overlap or abut
    across chunk boundaries; score = max of the parts. Records missing a
    "query" field merge query-agnostically."""
    by_key: dict[tuple, list[dict]] = {}
    for r in records:
        by_key.setdefault((r.get("query", -1), r["pred_cat"]), []).append(r)
    out = []
    for recs in by_key.values():
        recs.sort(key=lambda r: r["start"])
        cur = dict(recs[0])
        for r in recs[1:]:
            if r["start"] <= cur["end"]:          # overlap or abut
                cur["end"] = max(cur["end"], r["end"])
                cur["score"] = max(cur["score"], r["score"])
            else:
                out.append(cur)
                cur = dict(r)
        out.append(cur)
    return out


class StreamingRunner:
    """Chunked inference of ``model`` (a MaskVRD already on ``device``) over
    arbitrarily long SO-pair sequences, ``chunk_batch`` chunks a forward."""

    def __init__(self, cfg: ModelConfig, model: MaskVRD,
                 infer: InferenceConfig, feat_dim: int,
                 chunk_len: int | None = None, chunk_batch: int = 8, *,
                 device: torch.device):
        self.cfg = cfg
        self.model = model
        self.infer = infer
        self.feat_dim = feat_dim
        self.device = torch.device(device)
        self.halo = receptive_halo(cfg)
        q = cfg.max_div_factor
        chunk_len = chunk_len or max(cfg.max_seq_len, 4 * self.halo)
        self.chunk_len = ((chunk_len + q - 1) // q) * q
        self.interior = self.chunk_len - 2 * self.halo
        if self.interior <= 0:
            raise ValueError(f"chunk_len {self.chunk_len} leaves no interior "
                             f"inside a halo of {self.halo} frames")
        self.chunk_batch = chunk_batch

    @torch.inference_mode()
    def _forward(self, feats: np.ndarray, mask: np.ndarray):
        """One chunk group: (scores (cb, Q, topk), catids 1-based, binary
        masks (cb, Q, chunk_len)) as numpy."""
        preds = self.model(torch.from_numpy(feats).to(self.device),
                           torch.from_numpy(mask).to(self.device))
        probs = torch.softmax(preds["pred_logits"], dim=-1)
        scores, catids = probs[..., 1:].topk(self.infer.topk, dim=-1)
        masks_bin = torch.sigmoid(preds["pred_masks"]) > 0.5
        return (scores.cpu().numpy(), (catids + 1).cpu().numpy(),
                masks_bin.cpu().numpy())

    def chunk_starts(self, t: int) -> list[tuple[int, int, int]]:
        """(chunk_start, keep_lo, keep_hi) triples covering [0, t)."""
        if t <= self.chunk_len:
            return [(0, 0, t)]
        out = []
        pos = 0
        while pos < t:
            start = max(0, min(pos - self.halo, t - self.chunk_len))
            keep_lo = pos - start
            keep_hi = min(keep_lo + self.interior + (self.halo if pos == 0
                                                     else 0), t - start)
            # last chunk keeps through the end
            if start + self.chunk_len >= t:
                keep_hi = t - start
            out.append((start, keep_lo, keep_hi))
            pos = start + keep_hi
        return out

    def chunk_groups(self, so_feat: np.ndarray):
        """Yield (group, feats (cb, chunk_len, C), mask (cb, chunk_len)) for
        each group of ``chunk_batch`` chunks of ``so_feat`` (T, C); padded
        chunk slots hold one valid zero frame so they stay finite."""
        t = so_feat.shape[0]
        chunks = self.chunk_starts(t)
        cb = self.chunk_batch
        for group_start in range(0, len(chunks), cb):
            group = chunks[group_start:group_start + cb]
            feats = np.zeros((cb, self.chunk_len, self.feat_dim), np.float32)
            mask = np.zeros((cb, self.chunk_len), bool)
            for gi, (start, _, _) in enumerate(group):
                end = min(start + self.chunk_len, t)
                feats[gi, :end - start] = so_feat[start:end]
                mask[gi, :end - start] = True
            mask[len(group):, 0] = True  # padded chunk slots stay finite
            yield group, feats, mask

    def run_pair(self, so_feat: np.ndarray) -> list[dict]:
        """Span records of one SO-pair sequence (T, C): dicts with query,
        pred_cat (1-based), score, start, end in feature-grid coords; one
        record per (query, top-k class), the batch decode's granularity."""
        t = so_feat.shape[0]
        records = []
        for group, feats, mask in self.chunk_groups(so_feat):
            b_scores, b_catids, b_masks = self._forward(feats, mask)
            for gi, (start, keep_lo, keep_hi) in enumerate(group):
                end = min(start + self.chunk_len, t)
                scores, catids = b_scores[gi], b_catids[gi]   # (Q, topk)
                nq, topk = scores.shape
                for qi in range(nq):
                    on = b_masks[gi, qi, :end - start].copy()
                    # restrict to the interior this chunk owns
                    on[:keep_lo] = False
                    on[keep_hi:] = False
                    idx = np.nonzero(on)[0]
                    if len(idx) == 0:
                        continue
                    # one span per (query, class): first..last True index,
                    # gaps included; merge_spans stitches across chunks
                    lo = int(idx[0]) + start
                    hi = int(idx[-1]) + start + 1
                    for k in range(topk):
                        records.append({
                            "query": qi,
                            "pred_cat": int(catids[qi, k]),
                            "score": float(scores[qi, k]),
                            "start": lo, "end": hi,
                        })
        return merge_spans(records)
