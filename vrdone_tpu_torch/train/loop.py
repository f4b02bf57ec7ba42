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

Data parallelism (one process per card under ``torchrun``,
``parallel/mesh.py``): the step equals one process's step on the global
batch, as JAX's dp step is one program on it. Each rank draws drop path and
dropout at the global batch's shape and keeps its rows (``StepDraws``),
divides its losses by the global normalisers (``compute_losses``'
``reduce``), and sums the ranks' partial gradients with one all-reduce of
a flat buffer; the clip, AdamW and EMA then run alike on every rank. The
step takes its gradients with ``torch.autograd.grad``, so DDP's hooks would
never fire: the all-reduce is the step's own.

Sequence and tensor parallelism (a ``parallel.mesh.Layout`` of dp x tp x
sp ranks, ``TrainState.layout``): N ranks take the step one process takes
on the global batch, as JAX's sp and tp steps equal its dp step. Under sp
a rank holds its time columns of its dp rows (``mesh.time_slice``), and
the forward (halos, gathers, the decoder whole on the gathered coarsest
level) and the losses (time reductions summed over the sp ranks) run under
``collectives.time_sharded``; under tp (``create_train_state(...,
tp=True)``) a rank holds only its shards of the large kernels (and their
moments and EMA). The objective is the sum of every rank's loss, so the
gradient of a replicated leaf is summed over all ranks (the same flat
all-reduce), that of a tp shard over the dp x sp ranks of its tp index,
and the losses over all ranks.
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
from ..ops.masked import StepDraws
from ..parallel import collectives, mesh
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
    """The model (its parameters are the trained ones, or this rank's
    shards of them: ``tp_dims``), their EMA in the order of
    ``model.parameters()``, the optimizer, the step count and the rank's
    layout."""
    model: MaskVRD
    ema_params: list[torch.Tensor]
    optimizer: optim.Optimizer
    step: int = 0
    ema_decay: float = 0.999
    layout: mesh.Layout = dataclasses.field(default_factory=mesh.Layout)
    tp_dims: dict[str, int] = dataclasses.field(default_factory=dict)

    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())


def create_train_state(cfg: ModelConfig, training_config: dict,
                       num_iters_per_epoch: int, *, device: torch.device,
                       generator: Optional[torch.Generator] = None,
                       flax_params: Optional[dict] = None,
                       layout: Optional[mesh.Layout] = None,
                       tp: bool = False, tp_min_size: int = 1 << 16
                       ) -> tuple[TrainState, optim.Schedule]:
    """Build the model (random init from ``generator``, or the flattened
    flax parameters ``flax_params``), its EMA copy and the optimizer. The
    parameters are fp32 whatever ``cfg.compute_dtype`` is. ``layout``
    (``mesh.make_layout``; data parallelism over every rank by default) is
    the rank's place; with ``tp`` the rank keeps only its shards of the
    leaves JAX's ``tp_shardings`` shards at ``tp_min_size``
    (``mesh.shard_params_``), as the JAX package's
    ``create_train_state(..., tp=True)``."""
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
    layout = layout or mesh.default_layout()
    tp_dims = mesh.shard_params_(model, layout, tp_min_size) if tp else {}
    model.to(device)
    opt, schedule = optim.build_optimizer(model.named_parameters(),
                                          training_config,
                                          num_iters_per_epoch)
    if tp_dims:
        opt.sharded = [n in tp_dims for n, _ in model.named_parameters()]
        opt.shard_sum = functools.partial(mesh.all_reduce_sum,
                                          group=layout.tp_group)
    state = TrainState(
        model=model,
        ema_params=[p.detach().clone() for p in model.parameters()],
        optimizer=opt,
        # reference ModelEma decay 0.999; configurable as in the JAX package
        # (short runs evaluate EMA weights and need a faster average)
        ema_decay=float(training_config.get("ema_decay", 0.999)),
        layout=layout, tp_dims=tp_dims)
    return state, schedule


def batch_to_device(batch: dict[str, np.ndarray],
                    device: torch.device) -> dict[str, torch.Tensor]:
    """A packed numpy training batch (``data.batching.pack_train_batch``)
    as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items()}


def _forward(model: MaskVRD, batch: dict[str, torch.Tensor],
             draws: Optional[StepDraws], layout: mesh.Layout) -> dict:
    """The step's forward in training mode, as the JAX train step's
    ``forward``: in bf16 on ``cast_tensors`` of the fp32 parameters with
    bf16 features, and with ``remat`` under ``checkpoint``. The drop-path
    and dropout masks come from a generator rebuilt from ``draws``'
    generator state at each run, so the recompute draws the masks the
    forward drew (``checkpoint`` restores the default generators, not this
    one); ``draws`` itself is not advanced. Each run is time-sharded as
    ``layout`` says, the recompute too."""
    cfg = model.config
    dtype = compute_dtype(cfg.compute_dtype)
    rng = None if draws is None else draws.generator.get_state()

    def run():
        gen = None if rng is None else draws.restarted(rng)
        feats = batch["feats"].to(dtype)
        with collectives.time_sharded(layout):
            if dtype == torch.float32:
                return model(feats, batch["seq_mask"], gen)
            return torch.func.functional_call(
                model, cast_tensors(model, dtype),
                (feats, batch["seq_mask"], gen))

    if not cfg.remat:
        return run()
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, DOTS_SAVED)
    return checkpoint.checkpoint(run, use_reentrant=False, **kw)


def step_draws(generator: Optional[torch.Generator | StepDraws],
               local_batch: int,
               layout: Optional[mesh.Layout] = None) -> Optional[StepDraws]:
    """The step's draws for this rank: at the global batch's shape
    (``local_batch`` rows a dp index) from ``generator``, keeping the rows
    from this rank's dp offset (the sp and tp ranks of one dp index draw
    alike) and, for a time-sharded tensor, its sp columns. A ``StepDraws``
    keeps its own source of draws."""
    if generator is None:
        return None
    layout = layout or mesh.default_layout()
    kw = dict(global_batch=layout.n_dp * local_batch,
              row_offset=layout.dp * local_batch, time_parts=layout.n_sp,
              time_index=layout.sp)
    if isinstance(generator, StepDraws):
        return dataclasses.replace(generator, **kw)
    return StepDraws(generator, **kw)


def train_step(state: TrainState, batch: dict[str, torch.Tensor],
               generator: Optional[torch.Generator | StepDraws]
               ) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimisation step on ``batch`` (tensors on the model's device;
    under data parallelism this rank's rows of the global batch, the same
    number on every rank; under sequence parallelism their time columns,
    ``mesh.time_slice``). Updates ``state`` in place and returns it with
    the detached losses of the global batch."""
    model, layout = state.model, state.layout
    model.train()
    b = batch["feats"].shape[0]
    preds = _forward(model, batch, step_draws(generator, b, layout), layout)
    with collectives.time_sharded(layout):
        losses = compute_losses(
            model.config, preds, batch,
            functools.partial(mesh.all_reduce_sum, group=layout.dp_group),
            copies=layout.n_tp)
    params = state.params()
    grads = torch.autograd.grad(losses["total_loss"], params,
                                allow_unused=True)
    # a parameter the loss does not reach gets a zero gradient, as in JAX
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    losses = {k: v.detach() for k, v in losses.items()}
    if mesh.is_distributed():
        # in a process group, even of one (the sums are then collectives),
        # each rank's loss is its partial sum over the global normalisers:
        # the SUM of the ranks' gradients (and losses) is the global one;
        # a tp shard's is summed over the dp x sp ranks of its tp index
        names = [n for n, _ in model.named_parameters()]
        for group, idx in ((None, [i for i, n in enumerate(names)
                                   if n not in state.tp_dims]),
                           (layout.dpsp_group,
                            [i for i, n in enumerate(names)
                             if n in state.tp_dims])):
            if not idx:
                continue
            flat = mesh.all_reduce_sum(
                torch.cat([grads[i].reshape(-1) for i in idx]), group)
            for i, g in zip(idx, flat.split([params[i].numel()
                                             for i in idx])):
                grads[i] = g.view_as(params[i])
        total = mesh.all_reduce_sum(torch.stack(list(losses.values())))
        losses = dict(zip(losses, total.unbind()))
    state.optimizer.update([p.data for p in params], grads)
    optim.ema_update(state.ema_params, [p.data for p in params],
                     state.ema_decay)
    state.step += 1
    return state, losses


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator for the drop-path and dropout draws of one step,
    seeded from (seed, step) as the JAX package folds the step into its
    key: a resumed run draws what an unbroken one would, and a CPU run and
    a card run draw the same masks."""
    entropy = np.random.SeedSequence([seed, step]).generate_state(2)
    return torch.Generator().manual_seed(
        int(entropy[0]) << 32 | int(entropy[1]))
