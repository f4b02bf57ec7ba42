"""Cross-process helpers of the eval merge (counterpart of
``vrdone_tpu/parallel/comm.py``).

``all_gather_objects`` gathers one picklable object a rank,
``reduce_dict`` averages or sums a {name: scalar} dict, and
``accumulate_predictions`` merges the ranks' prediction dicts. They run on
the gloo group of ``mesh.host_group`` (pickled byte tensors on the host,
as ``torch.distributed.all_gather_object`` sends them), whatever the
default backend is. Every rank gets the result. With no process group each
gives the one-process answer.
"""

from __future__ import annotations

import logging

import numpy as np
import torch.distributed as dist

from . import mesh


def all_gather_objects(obj) -> list:
    """One object from each process, in process order, on every process."""
    n = mesh.process_count()
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=mesh.host_group())
    return out


def reduce_dict(d: dict, average: bool = True) -> dict:
    """Average (or sum) a {name: scalar} dict over the processes, in fp32
    as the JAX package reduces it; every process gets the result."""
    if mesh.process_count() == 1:
        return {k: float(v) for k, v in d.items()}
    keys = sorted(d)
    vals = np.asarray([float(d[k]) for k in keys], np.float32)
    allv = np.stack(all_gather_objects(vals))
    red = allv.mean(axis=0) if average else allv.sum(axis=0)
    return dict(zip(keys, red.astype(float)))


def accumulate_predictions(local_preds: dict) -> dict:
    """Merge the processes' {id: prediction} dicts into one. Integer ids
    that are not contiguous get a warning (images may be missing from the
    evaluation); the relation eval's video-name keys are merged as they
    are."""
    merged: dict = {}
    for part in all_gather_objects(local_preds):
        merged.update(part)
    ids = sorted(merged)
    if (ids and all(isinstance(i, (int, np.integer)) for i in ids)
            and list(ids) != list(range(int(ids[0]),
                                        int(ids[0]) + len(ids)))):
        logging.getLogger("vrdone_tpu_torch").warning(
            "accumulate_predictions: image ids are not contiguous — "
            "some images may be missing from the evaluation")
    return merged
