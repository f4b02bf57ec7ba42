"""Checkpoint save and restore (counterpart of
``vrdone_tpu/train/checkpoint.py``).

The payload has the JAX checkpoint's fields (reference
utils/train_utils.py:167-179): params, EMA params, optimizer state, step,
and ``meta`` with ``crt_epoch`` and ``batch_size``. Parameters are keyed by
the model's ``state_dict`` names and stored on the CPU. A save writes
``torch.save`` output to a temporary file beside the target and renames it
into place, so a reader never sees a half-written checkpoint.

Under data parallelism every rank holds the same state: rank 0 writes, and
then all ranks meet at a barrier, so none reads or overwrites a checkpoint
before it is whole. Every rank restores. Under tensor parallelism the
checkpoint holds the whole fp32 masters, EMA and moments: every rank takes
part in gathering the tp shards, rank 0 writes them, and every rank
restores its shard of each, so ``eval_torch.py --ckpt_path`` reads a tp
run's checkpoint as any other.
"""

from __future__ import annotations

import os
import tempfile

import torch

from ..parallel import collectives, mesh
from .loop import TrainState


def save_checkpoint(path: str, state: TrainState, *, epoch: int,
                    batch_size: int) -> None:
    payload = None
    if state.tp_dims or mesh.process_index() == 0:
        payload = state_payload(state, epoch=epoch, batch_size=batch_size)
    if mesh.process_index() == 0:
        write_atomically(path, lambda tmp: torch.save(payload, tmp))
    mesh.barrier()


@torch.no_grad()
def state_payload(state: TrainState, *, epoch: int, batch_size: int) -> dict:
    """What a checkpoint holds, on the CPU, tp shards gathered whole (a
    collective on every rank)."""
    names = [n for n, _ in state.model.named_parameters()]
    dims = [state.tp_dims.get(n) for n in names]

    def whole(tensors):
        return [(t if d is None else collectives.gather_features(
            t, d, state.layout)).detach().cpu()
            for t, d in zip(tensors, dims)]

    opt = state.optimizer.state_dict()
    opt["moments"] = {k: whole(v) for k, v in
                      state.optimizer.moments.items()}
    return {
        "params": {**{k: v.detach().cpu() for k, v in
                      state.model.state_dict().items()},
                   **dict(zip(names, whole(state.params())))},
        "ema_params": dict(zip(names, whole(state.ema_params))),
        "opt_state": opt,
        "step": state.step,
        "meta": {"crt_epoch": epoch + 1, "batch_size": batch_size},
    }


def write_atomically(path: str, write) -> None:
    """``write(tmp)`` to a temporary file beside ``path``, then rename it
    into place: a reader never sees a half-written file."""
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               dir=os.path.dirname(path))
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def restore_checkpoint(path: str, state: TrainState
                       ) -> tuple[TrainState, int, int]:
    """Load a checkpoint into ``state`` (in place). Returns
    (state, crt_epoch, batch_size)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model = state.model
    device = next(model.parameters()).device
    names = [n for n, _ in model.named_parameters()]
    dims = [state.tp_dims.get(n) for n in names]

    def mine(tensors):
        """This rank's shard of each whole tensor."""
        return [t if d is None else mesh.take_shard(t, d, state.layout)
                for t, d in zip(tensors, dims)]

    params = payload["params"]
    params.update(zip(names, mine([params[n] for n in names])))
    model.load_state_dict(params, strict=True)
    ema = payload["ema_params"]
    if sorted(ema) != sorted(names):
        raise ValueError(f"{path}: EMA parameters do not match the model")
    state.ema_params = [t.to(device) for t in mine([ema[n] for n in names])]
    opt = payload["opt_state"]
    opt["moments"] = {k: mine(v) for k, v in opt["moments"].items()}
    state.optimizer.load_state_dict(opt, device)
    state.step = int(payload["step"])
    meta = payload["meta"]
    return state, int(meta["crt_epoch"]), int(meta["batch_size"])


def restore_params_for_eval(path: str) -> dict[str, torch.Tensor]:
    """The ``state_dict`` to evaluate: EMA parameters when the checkpoint
    has them (reference eval.py:119-122), else the raw ones."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload.get("ema_params") or payload["params"]
