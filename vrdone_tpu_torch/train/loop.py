"""Training state and the train step (counterpart of
``vrdone_tpu/train/loop.py``).

One step: forward in training mode (stochastic depth from an explicit
``torch.Generator``), Hungarian matching and losses, backward,
global-norm clip, AdamW, EMA. Band attention runs its CUDA kernels forward
and backward on the card; full attention runs its dense form, as the JAX
package trains through it.

``compute_dtype: bfloat16`` (read here, as the JAX train loop reads it;
the model computes in the dtype of its parameters and inputs) runs the
forward on a differentiable bf16 cast of the fp32 masters with bf16
features: the optimizer, its moments and the EMA stay fp32, the heads come
back in fp32 and matching and the losses run in fp32. ``remat`` recomputes
the forward, the cast included, in the backward (``remat_policy`` "full",
or "dots": the outputs of the plain matrix products are kept).

Not ported (it raises in ``train_torch.py``): a device mesh; see
ROADMAP.md queue 1, data parallelism.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch.utils import checkpoint

from ..config import ModelConfig
from ..convert import load_params
from ..models.maskvrd import MaskVRD, compute_losses
from ..utils.precision import cast_tensors, compute_dtype
from . import optim

REMAT_POLICIES = ("full", "dots")
# what remat policy "dots" keeps, as JAX's dots_with_no_batch_dims_saveable:
# the outputs of the products without a batch dimension (the Dense
# layers'); the attention's batched products and everything elementwise
# are recomputed
DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


@dataclasses.dataclass
class TrainState:
    """The model (its parameters are the trained ones), their EMA in the
    order of ``model.parameters()``, the optimizer and the step count."""
    model: MaskVRD
    ema_params: list[torch.Tensor]
    optimizer: optim.Optimizer
    step: int = 0
    ema_decay: float = 0.999

    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        """The EMA parameters under the model's ``state_dict`` names."""
        names = [n for n, _ in self.model.named_parameters()]
        return dict(zip(names, self.ema_params))


def create_train_state(cfg: ModelConfig, training_config: dict,
                       num_iters_per_epoch: int, *, device: torch.device,
                       generator: Optional[torch.Generator] = None,
                       flax_params: Optional[dict] = None
                       ) -> tuple[TrainState, optim.Schedule]:
    """Build the model (random init from ``generator``, or the flattened
    flax parameters ``flax_params``), its EMA copy and the optimizer. The
    parameters are fp32 whatever ``cfg.compute_dtype`` is."""
    compute_dtype(cfg.compute_dtype)   # raises for a name it does not take
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r}, not one of "
                         f"{REMAT_POLICIES}")
    if (generator is None) == (flax_params is None):
        raise ValueError("give exactly one of generator and flax_params")
    # built and filled on the CPU, where the generator draws, then moved:
    # one seed gives the same weights on every device
    model = MaskVRD(cfg, device=torch.device("cpu"), generator=generator)
    if flax_params is not None:
        load_params(model, flax_params)
    model.to(device)
    opt, schedule = optim.build_optimizer(model.named_parameters(),
                                          training_config,
                                          num_iters_per_epoch)
    state = TrainState(
        model=model,
        ema_params=[p.detach().clone() for p in model.parameters()],
        optimizer=opt,
        # reference ModelEma decay 0.999; configurable as in the JAX package
        # (short runs evaluate EMA weights and need a faster average)
        ema_decay=float(training_config.get("ema_decay", 0.999)))
    return state, schedule


def batch_to_device(batch: dict[str, np.ndarray],
                    device: torch.device) -> dict[str, torch.Tensor]:
    """A packed numpy training batch (``data.batching.pack_train_batch``)
    as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def _forward(model: MaskVRD, batch: dict[str, torch.Tensor],
             generator: Optional[torch.Generator]) -> dict:
    """The step's forward in training mode, as the JAX train step's
    ``forward``: in bf16 on ``cast_tensors`` of the fp32 parameters with
    bf16 features, and with ``remat`` under ``checkpoint``. The drop-path
    and dropout masks come from a generator rebuilt from ``generator``'s
    state at each run, so the recompute draws the masks the forward drew
    (``checkpoint`` restores the default generators, not this one);
    ``generator`` itself is not advanced."""
    cfg = model.config
    dtype = compute_dtype(cfg.compute_dtype)
    rng = None if generator is None else generator.get_state()

    def run():
        gen = None
        if rng is not None:
            gen = torch.Generator(generator.device)
            gen.set_state(rng)
        feats = batch["feats"].to(dtype)
        if dtype == torch.float32:
            return model(feats, batch["seq_mask"], gen)
        return torch.func.functional_call(
            model, cast_tensors(model, dtype), (feats, batch["seq_mask"], gen))

    if not cfg.remat:
        return run()
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, DOTS_SAVED)
    return checkpoint.checkpoint(run, use_reentrant=False, **kw)


def train_step(state: TrainState, batch: dict[str, torch.Tensor],
               generator: Optional[torch.Generator]
               ) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimisation step on ``batch`` (tensors on the model's device).
    Updates ``state`` in place and returns it with the detached losses."""
    model = state.model
    model.train()
    preds = _forward(model, batch, generator)
    losses = compute_losses(model.config, preds, batch)
    params = state.params()
    grads = torch.autograd.grad(losses["total_loss"], params,
                                allow_unused=True)
    # a parameter the loss does not reach gets a zero gradient, as in JAX
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    state.optimizer.update([p.data for p in params], grads)
    optim.ema_update(state.ema_params, [p.data for p in params],
                     state.ema_decay)
    state.step += 1
    return state, {k: v.detach() for k, v in losses.items()}


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for the drop-path and dropout draws of one step,
    seeded from (seed, step) as the JAX package folds the step into its
    key: a resumed run draws what an unbroken one would, and a CPU run and
    a card run draw the same masks."""
    entropy = np.random.SeedSequence([seed, step]).generate_state(2)
    return torch.Generator().manual_seed(
        int(entropy[0]) << 32 | int(entropy[1]))
