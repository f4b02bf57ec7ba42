"""Checkpoint save and restore (counterpart of
``vrdone_tpu/train/checkpoint.py``).

The payload has the JAX checkpoint's fields (reference
utils/train_utils.py:167-179): params, EMA params, optimizer state, step,
and ``meta`` with ``crt_epoch`` and ``batch_size``. Parameters are keyed by
the model's ``state_dict`` names and stored on the CPU. A save writes
``torch.save`` output to a temporary file beside the target and renames it
into place, so a reader never sees a half-written checkpoint.
"""

from __future__ import annotations

import os
import tempfile

import torch

from .loop import TrainState


def save_checkpoint(path: str, state: TrainState, *, epoch: int,
                    batch_size: int) -> None:
    model = state.model
    payload = {
        "params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "ema_params": {k: v.detach().cpu()
                       for k, v in state.ema_state_dict().items()},
        "opt_state": state.optimizer.state_dict(),
        "step": state.step,
        "meta": {"crt_epoch": epoch + 1, "batch_size": batch_size},
    }
    path = os.path.abspath(path)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               dir=os.path.dirname(path))
    os.close(fd)
    try:
        torch.save(payload, tmp)
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
    model.load_state_dict(payload["params"], strict=True)
    names = [n for n, _ in model.named_parameters()]
    ema = payload["ema_params"]
    if sorted(ema) != sorted(names):
        raise ValueError(f"{path}: EMA parameters do not match the model")
    state.ema_params = [ema[n].to(device) for n in names]
    state.optimizer.load_state_dict(payload["opt_state"], device)
    state.step = int(payload["step"])
    meta = payload["meta"]
    return state, int(meta["crt_epoch"]), int(meta["batch_size"])


def restore_params_for_eval(path: str) -> dict[str, torch.Tensor]:
    """The ``state_dict`` to evaluate: EMA parameters when the checkpoint
    has them (reference eval.py:119-122), else the raw ones."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return payload.get("ema_params") or payload["params"]
