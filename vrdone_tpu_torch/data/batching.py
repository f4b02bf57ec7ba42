"""Eval batch packing (mirror of ``eval_bucket_lengths`` and
``pack_eval_bucket`` in ``vrdone_tpu/data/batching.py``).

Kept as a copy so that the GPU path does not import ``vrdone_tpu``;
``tests/test_torch_eval.py`` pins both functions, output for output, to the
originals. Short sequences pad to ``max_seq_len``; long ones to
``max_seq_len * 2**k`` rounded up to the model's ``max_div_factor``, so the
forward sees a handful of shapes.
"""

from __future__ import annotations

import numpy as np


def eval_bucket_lengths(lengths: np.ndarray, max_seq_len: int,
                        max_div_factor: int) -> np.ndarray:
    """Padded length per sequence: max_seq_len for short ones; for long
    ones, max_seq_len * 2**k rounded up to max_div_factor."""
    out = np.full(lengths.shape, max_seq_len, np.int64)
    long = lengths > max_seq_len
    if long.any():
        k = np.ceil(np.log2(lengths[long] / max_seq_len)).astype(np.int64)
        padded = max_seq_len * (2 ** k)
        padded = ((padded + max_div_factor - 1)
                  // max_div_factor) * max_div_factor
        out[long] = padded
    return out


def pack_eval_bucket(seqs: list[np.ndarray], pad_len: int,
                     pack_size: int, feat_dim: int) -> tuple[dict, int]:
    """Pack <= pack_size sequences of length <= pad_len into one batch.

    Returns (batch, n_real). Slots beyond n_real are padding with one valid
    frame (finite softmax) and must be dropped by the caller.
    """
    n = len(seqs)
    if n > pack_size:
        raise ValueError(f"{n} sequences do not fit a pack of {pack_size}")
    feats = np.zeros((pack_size, pad_len, feat_dim), np.float32)
    mask = np.zeros((pack_size, pad_len), bool)
    for i, s in enumerate(seqs):
        t = s.shape[0]
        if t > pad_len:
            raise ValueError(f"sequence of {t} frames exceeds {pad_len}")
        feats[i, :t] = s
        mask[i, :t] = True
    mask[n:, 0] = True
    return {"feats": feats, "seq_mask": mask}, n
