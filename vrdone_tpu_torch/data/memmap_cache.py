# Copy of vrdone_tpu/data/memmap_cache.py, kept so that the port imports nothing of
# vrdone_tpu; tests/test_torch_copies.py pins it to the original.
"""Memory-mapped packed cache for train-side video features.

The reference's VidOR dataset re-unpickles a whole video's feature cache
for every train item (reference dataloaders/vidor.py:745-747) — each
policy group deserializes megabytes of float32 to use a few pair spans.
This module packs a video's per-interval feature arrays into one
contiguous .npy per stream plus a small metadata pickle; loading opens
the arrays with np.load(mmap_mode="r"), so a train item only pages in
the rows its pairs actually slice (SURVEY.md §7 hard part 7: replace
per-item pickle reload with a sharded array format).

On-disk layout per video:
  <video>.feats.npy   float32 (sum_rows, visual_dim)
  <video>.clip.npy    float32 (sum_rows, clip_dim)     [only with CLIP]
  <video>.meta.pkl    everything else + (offset, length) per interval
"""

from __future__ import annotations

import os
import pickle

import numpy as np

_META_SUFFIX = ".meta.pkl"
_FEAT_SUFFIX = ".feats.npy"
_CLIP_SUFFIX = ".clip.npy"


def has_packed(cache_path: str, video_name: str) -> bool:
    return os.path.exists(os.path.join(cache_path,
                                       video_name + _META_SUFFIX))


def write_packed(cache_path: str, video_name: str, data: dict) -> None:
    """Convert a _prepare_train dict into the packed memmap layout."""
    base = os.path.join(cache_path, video_name)
    if not data:
        with open(base + _META_SUFFIX, "wb") as f:
            pickle.dump({}, f)
        return

    def pack(stream_key):
        chunks, spans = [], {}
        total = 0
        for idx, intervals in data[stream_key].items():
            spans[idx] = []
            for arr in intervals:
                arr = np.asarray(arr, np.float32)
                chunks.append(arr)
                spans[idx].append((total, arr.shape[0]))
                total += arr.shape[0]
        flat = (np.concatenate(chunks, axis=0) if chunks
                else np.zeros((0, 1), np.float32))
        return flat, spans

    feats, feat_spans = pack("visual_features")
    np.save(base + _FEAT_SUFFIX, feats)
    meta = {k: v for k, v in data.items()
            if k not in ("visual_features", "clip_features")}
    meta["feat_spans"] = feat_spans
    meta["feat_dim"] = feats.shape[1]
    if data.get("clip_features") is not None:
        clip, clip_spans = pack("clip_features")
        np.save(base + _CLIP_SUFFIX, clip)
        meta["clip_spans"] = clip_spans
        meta["clip_dim"] = clip.shape[1]
    with open(base + _META_SUFFIX, "wb") as f:
        pickle.dump(meta, f)


class _SpanView:
    """Lazy list-of-intervals view into a memmapped stream."""

    def __init__(self, mm: np.memmap, spans: list[tuple[int, int]]):
        self._mm = mm
        self._spans = spans

    def __len__(self):
        return len(self._spans)

    def __getitem__(self, k: int) -> np.ndarray:
        off, n = self._spans[k]
        return self._mm[off:off + n]


def load_packed(cache_path: str, video_name: str) -> dict:
    """Open a packed video; feature intervals are memmap-backed views."""
    base = os.path.join(cache_path, video_name)
    with open(base + _META_SUFFIX, "rb") as f:
        meta = pickle.load(f)
    if not meta:
        return {}
    out = {k: v for k, v in meta.items()
           if k not in ("feat_spans", "feat_dim", "clip_spans",
                        "clip_dim")}
    mm = np.load(base + _FEAT_SUFFIX, mmap_mode="r")
    out["visual_features"] = {idx: _SpanView(mm, spans)
                              for idx, spans in meta["feat_spans"].items()}
    if "clip_spans" in meta:
        cm = np.load(base + _CLIP_SUFFIX, mmap_mode="r")
        out["clip_features"] = {idx: _SpanView(cm, spans)
                                for idx, spans in
                                meta["clip_spans"].items()}
    return out
