"""Optimizer, LR schedule and EMA (counterpart of
``vrdone_tpu/train/optim.py``), with optax's semantics rather than
``torch.optim``'s:

  * ``clip_by_global_norm`` scales the gradients by max/norm only when
    norm >= max (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm,
    a different function);
  * update t (0-based) uses lr = schedule(t), so with lr(0) =
    warmup_start_lr = 0 the first update leaves the weights as they are;
    Adam's bias correction counts t + 1;
  * AdamW adds weight_decay * param to the Adam direction before the
    learning rate scales it, and only where ``decay_mask`` is true: flax
    ``kernel`` / ``*_kernel`` leaves, picked by their flax name (see
    ``convert.is_flax_kernel``), never by the torch name ``weight`` that
    LayerNorm affine parameters carry too.

Updates work in place on lists of tensors with ``torch._foreach_*`` ops
(one multi-tensor launch per op on the card instead of one per parameter).
The detector's SGD (``detector_sgd``) is optax's chain of the JAX
package's ``detector_sgd``, with the bias leaves picked by ``bias_mask``
on their flax names.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..convert import flax_key, is_flax_kernel

Schedule = Callable[[int], float]


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, max_steps: int,
                           warmup_start_lr: float = 0.0,
                           eta_min: float = 1e-8) -> Schedule:
    """Closed-form LinearWarmupCosineAnnealingLR, in float32 as the JAX
    package computes it."""

    def schedule(step: int) -> float:
        step = np.float32(step)
        if step < warmup_steps:
            return float(warmup_start_lr + step * (base_lr - warmup_start_lr)
                         / max(warmup_steps - 1, 1))
        prog = (step - warmup_steps) / max(max_steps - warmup_steps, 1)
        return float(eta_min + 0.5 * (base_lr - eta_min)
                     * (1.0 + np.cos(np.pi * prog)))

    return schedule


def multistep_schedule(base_lr: float, warmup_steps: int,
                       milestones: tuple[int, ...], gamma: float,
                       warmup_start_lr: float = 0.0) -> Schedule:
    """LinearWarmupMultiStepLR (utils/lr_schedulers.py:122-210)."""
    milestones = tuple(sorted(milestones))

    def schedule(step: int) -> float:
        step = np.float32(step)
        if step < warmup_steps:
            return float(warmup_start_lr + step * (base_lr - warmup_start_lr)
                         / max(warmup_steps - 1, 1))
        decays = sum(1 for m in milestones if step >= m)
        return float(np.float32(base_lr) * np.float32(gamma) ** decays)

    return schedule


def cosine_decay_schedule(base_lr: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule(base_lr, decay_steps) (alpha 0)."""

    def schedule(step: int) -> float:
        count = np.float32(min(step, decay_steps))
        return float(base_lr * (0.5 * (1 + np.cos(np.pi * count
                                                  / np.float32(decay_steps)))))

    return schedule


def decay_mask(named_params) -> dict[str, bool]:
    """True where weight decay applies: the flax kernels of Dense and conv
    layers. ``named_params``: (name, tensor) pairs, e.g.
    ``model.named_parameters()``."""
    return {name: is_flax_kernel(name, p) for name, p in named_params}


def bias_mask(named_params) -> dict[str, bool]:
    """True on the bias leaves (the reference solver's ``"bias" in key``),
    taken on the flax leaf name, as the JAX package's ``bias_mask`` takes
    it: frozen batch norm's ``bias`` is one, its ``running_*`` are not."""
    return {name: "bias" in flax_key(name, p).rsplit("/", 1)[-1]
            for name, p in named_params}


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         sharded: list[bool] | None = None,
                         shard_sum: Callable[[torch.Tensor],
                                             torch.Tensor] | None = None
                         ) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm when the
    global L2 norm is not below max_norm, else unchanged. Stays on the
    device (no host sync). Under tensor parallelism the leaves flagged in
    ``sharded`` are this rank's shards: their squared norms are summed over
    the tp ranks by ``shard_sum``, and the replicated leaves count once."""
    norms = torch._foreach_norm(grads)
    if sharded is None or not any(sharded):
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        sq = torch.stack(norms) ** 2
        flags = torch.tensor(sharded, device=sq.device)
        norm = torch.sqrt(sq[~flags].sum() + shard_sum(sq[flags].sum()))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one,
                                           torch.full_like(norm, max_norm)))


class Optimizer:
    """AdamW or SGD with momentum, optionally after a global-norm clip:
    ``optax.chain(clip_by_global_norm(clip), adamw(schedule, 0.9, 0.999,
    1e-8, weight_decay, mask))`` or ``chain(add_decayed_weights(wd, mask),
    sgd(schedule, momentum))``. ``update`` changes the parameters in place
    and returns the learning rate it used. Under tensor parallelism
    ``sharded`` flags the parameters that are this rank's shards and
    ``shard_sum`` sums over the tp ranks (the clip's norm); every other
    step is elementwise, so it runs on the shards as on whole leaves."""

    def __init__(self, kind: str, schedule: Schedule, decay: list[bool], *,
                 weight_decay: float, clip: float = 0.0,
                 momentum: float = 0.9, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        if kind not in ("AdamW", "SGD"):
            raise TypeError(f"Unsupported optimizer: {kind}")
        self.kind = kind
        self.schedule = schedule
        self.decay = list(decay)
        self.weight_decay = weight_decay
        self.clip = clip
        self.momentum = momentum
        self.b1, self.b2, self.eps = b1, b2, eps
        # Set by train/loop.py::create_train_state under tensor parallelism.
        self.sharded: list[bool] | None = None
        self.shard_sum: Callable[[torch.Tensor], torch.Tensor] | None = None
        self.count = 0
        self.moments: dict[str, list[torch.Tensor]] = {}

    def _init(self, params: list[torch.Tensor]) -> None:
        names = ("mu", "nu") if self.kind == "AdamW" else ("trace",)
        self.moments = {n: [torch.zeros_like(p) for p in params]
                        for n in names}

    @torch.no_grad()
    def update(self, params: list[torch.Tensor],
               grads: list[torch.Tensor]) -> float:
        if len(params) != len(self.decay):
            raise ValueError(f"{len(params)} parameters, decay mask of "
                             f"{len(self.decay)}")
        if not self.moments:
            self._init(params)
        if self.clip and self.clip > 0.0:
            clip_by_global_norm_(grads, self.clip, self.sharded,
                                 self.shard_sum)
        lr = self.schedule(self.count)
        self.count += 1
        decayed = [i for i, d in enumerate(self.decay) if d]

        def add_decay(updates):
            if decayed and self.weight_decay:
                torch._foreach_add_(
                    [updates[i] for i in decayed],
                    torch._foreach_mul([params[i] for i in decayed],
                                       self.weight_decay))

        if self.kind == "AdamW":
            mu, nu = self.moments["mu"], self.moments["nu"]
            b1, b2 = self.b1, self.b2
            # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - b2)
            torch._foreach_add_(nu, sq)
            bc1 = float(1 - np.float32(b1) ** np.int32(self.count))
            bc2 = float(1 - np.float32(b2) ** np.int32(self.count))
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            updates = torch._foreach_div(mu, bc1)
            torch._foreach_div_(updates, den)
            add_decay(updates)
        else:
            updates = [g.clone() for g in grads]
            add_decay(updates)
            trace = self.moments["trace"]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, updates)
            updates = [t.clone() for t in trace]
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(params, updates)
        return lr

    def state_dict(self) -> dict:
        return {"kind": self.kind, "count": self.count,
                "moments": {n: [t.detach().cpu() for t in ts]
                            for n, ts in self.moments.items()}}

    def load_state_dict(self, state: dict, device) -> None:
        if state["kind"] != self.kind:
            raise ValueError(f"optimizer state of {state['kind']}, not "
                             f"{self.kind}")
        self.count = int(state["count"])
        self.moments = {n: [t.to(device) for t in ts]
                        for n, ts in state["moments"].items()}


class DetectorSGD:
    """The detector's SGD with momentum (the JAX package's
    ``detector_sgd``, after the reference solver): in optax's order,
    ``clip_by_global_norm(clip)`` on the raw gradient, ``weight_decay`` x
    param added to every non-bias leaf's gradient, ``weight_decay_bias``
    to the bias leaves', the momentum trace m = g + momentum * m (no
    dampening), bias leaves x ``bias_lr_factor``, then x -lr(count) with
    ``count`` from 0. ``update`` changes the parameters in place and
    returns the learning rate it used."""

    def __init__(self, schedule: Schedule, bias: list[bool], *,
                 momentum: float = 0.9, weight_decay: float = 1e-4,
                 bias_lr_factor: float = 2.0, weight_decay_bias: float = 0.0,
                 clip: float = 10.0):
        self.schedule = schedule
        self.bias = list(bias)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.bias_lr_factor = bias_lr_factor
        self.weight_decay_bias = weight_decay_bias
        self.clip = clip
        self.count = 0
        self.trace: list[torch.Tensor] = []

    @torch.no_grad()
    def update(self, params: list[torch.Tensor],
               grads: list[torch.Tensor]) -> float:
        if len(params) != len(self.bias):
            raise ValueError(f"{len(params)} parameters, bias mask of "
                             f"{len(self.bias)}")
        if not self.trace:
            self.trace = [torch.zeros_like(p) for p in params]
        if self.clip and self.clip > 0.0:
            clip_by_global_norm_(grads, self.clip)
        lr = self.schedule(self.count)
        self.count += 1
        updates = [g.clone() for g in grads]
        for is_bias, decay in ((False, self.weight_decay),
                               (True, self.weight_decay_bias)):
            idx = [i for i, b in enumerate(self.bias) if b == is_bias]
            if idx and decay:
                torch._foreach_add_([updates[i] for i in idx],
                                    torch._foreach_mul([params[i]
                                                        for i in idx], decay))
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, updates)
        updates = [t.clone() for t in self.trace]
        bias_idx = [i for i, b in enumerate(self.bias) if b]
        if bias_idx and self.bias_lr_factor != 1.0:
            torch._foreach_mul_([updates[i] for i in bias_idx],
                                self.bias_lr_factor)
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(params, updates)
        return lr

    def state_dict(self) -> dict:
        return {"count": self.count,
                "trace": [t.detach().cpu() for t in self.trace]}

    def load_state_dict(self, state: dict, device) -> None:
        self.count = int(state["count"])
        self.trace = [t.to(device) for t in state["trace"]]


def detector_sgd(schedule: Schedule, named_params, *, momentum: float = 0.9,
                 weight_decay: float = 1e-4, bias_lr_factor: float = 2.0,
                 weight_decay_bias: float = 0.0,
                 clip: float = 10.0) -> DetectorSGD:
    """The JAX package's ``detector_sgd(schedule, params, ...)`` over
    ``named_params`` (e.g. ``model.named_parameters()``), in their
    order."""
    return DetectorSGD(schedule, list(bias_mask(named_params).values()),
                       momentum=momentum, weight_decay=weight_decay,
                       bias_lr_factor=bias_lr_factor,
                       weight_decay_bias=weight_decay_bias, clip=clip)


def build_optimizer(named_params, training_config: dict,
                    num_iters_per_epoch: int) -> tuple[Optimizer, Schedule]:
    """The JAX package's build_optimizer: schedule, decay mask, clip and
    the optimizer, from ``training_config``."""
    base_lr = training_config["training_lr"]
    clip = training_config.get("clip_grad_l2norm", 0.0)
    wd = training_config.get("weight_decay", 0.05)
    max_steps = training_config["total_epoch"] * num_iters_per_epoch
    if training_config.get("warmup", True):
        warmup_steps = training_config["warmup_epochs"] * num_iters_per_epoch
        if training_config.get("schedule_type", "cosine") == "cosine":
            schedule = warmup_cosine_schedule(base_lr, warmup_steps,
                                              max_steps)
        else:
            steps = tuple(num_iters_per_epoch * s
                          for s in training_config["schedule_steps"])
            schedule = multistep_schedule(
                base_lr, warmup_steps, steps,
                training_config.get("schedule_gamma", 0.1))
    else:
        schedule = cosine_decay_schedule(base_lr, max_steps)
    mask = list(decay_mask(named_params).values())
    opt = Optimizer(training_config.get("type", "AdamW"), schedule, mask,
                    weight_decay=wd, clip=clip,
                    momentum=training_config.get("momentum", 0.9))
    return opt, schedule


@torch.no_grad()
def ema_update(ema: list[torch.Tensor], params: list[torch.Tensor],
               decay: float = 0.999) -> None:
    """ema = decay * ema + (1 - decay) * params, in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - decay))
