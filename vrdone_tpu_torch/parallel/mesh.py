"""The device layout (counterpart of ``vrdone_tpu/parallel/mesh.py``).

The JAX package lays its devices out as one ("dp", "tp", "sp") mesh: "dp"
shards the batch, "tp" the output features of the large kernels
(``tp_shardings``), "sp" the time axis of the temporal batch tensors
(``sp_batch_shardings``), and GSPMD places every collective. The port runs
one process per card under ``torchrun``, which sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``. ``make_layout(n_dp, n_tp, n_sp)`` gives
rank r the coordinates of ``make_mesh``'s row-major reshape (dp = r //
(n_tp n_sp), tp = (r // n_sp) % n_tp, sp = r % n_sp) and the process
groups of the ranks that differ only in sp, only in tp and only in dp, and
the dp x sp group of each tp index; ``parallel/collectives.py`` holds the
collectives placed on them. Each rank packs its contiguous rows of the
global batch (``local_batch_slice``, by its dp index) and, under
sequence parallelism, keeps its contiguous time columns of them
(``time_slice``); the train step sums the ranks' partial gradients
(``train/loop.py``). With no process group every helper gives the
one-process answer, so the same code runs in one process.

The default group is NCCL on the card and gloo on the CPU. Host-side
collectives (the pickled objects of the eval merge, barriers) run on a
gloo group of their own, so they work whatever the default backend is,
two ranks sharing one card included.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..convert import is_flax_kernel

_host_group = None   # the gloo group of the host-side collectives


def init_distributed(device: str = "cuda", backend: str | None = None
                     ) -> tuple[int, int, torch.device]:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``). Returns (rank, world size, this rank's device).

    ``device`` "cuda" gives ``cuda:LOCAL_RANK``; "cuda:<i>" keeps card i
    for every rank (ranks sharing one card); "cpu" the CPU. ``backend``
    defaults to NCCL on a card and gloo on the CPU. A rank that finds no
    card under "cuda" raises: it never falls back to the CPU."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "init_distributed needs RANK and WORLD_SIZE in the environment; "
            "launch with torchrun")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        index = local if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank}: no card cuda:{index} (this host has "
                f"{torch.cuda.device_count()})")
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world)
    host_group()
    return rank, world, dev


def join_world(device: str, multihost: bool
               ) -> tuple[int, int, torch.device]:
    """A CLI's (rank, world size, device): ``init_distributed`` under
    torchrun, one process without it. ``multihost`` (the CLIs'
    ``--multihost``) without torchrun's environment raises SystemExit."""
    if "WORLD_SIZE" in os.environ:
        return init_distributed(device)
    if multihost:
        raise SystemExit("--multihost runs under torchrun, which sets RANK "
                         "and WORLD_SIZE")
    return 0, 1, torch.device(device)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def host_group():
    """The group of the host-side collectives: the default group when it
    is gloo, else a gloo group over the same ranks, made on first use (every
    rank reaches it in the same order, as every collective)."""
    global _host_group
    if not is_distributed() or dist.get_backend() == "gloo":
        return None
    if _host_group is None:
        _host_group = dist.new_group(backend="gloo")
    return _host_group


@dataclasses.dataclass(frozen=True)
class Layout:
    """This rank's place in the dp x tp x sp layout: the sizes, its
    coordinates and its groups (``None`` stands for the default group of
    all ranks). A group may hold this rank alone (the dp group at n_dp 1):
    a collective over it returns its input."""
    n_dp: int = 1
    n_tp: int = 1
    n_sp: int = 1
    dp: int = 0
    tp: int = 0
    sp: int = 0
    dp_group: Any = None      # the ranks that differ only in dp
    tp_group: Any = None      # ... only in tp
    sp_group: Any = None      # ... only in sp
    dpsp_group: Any = None    # the dp x sp ranks of this tp index


def default_layout() -> Layout:
    """Data parallelism over every rank of the process group (one process
    without one): ``make_layout()``'s layout, without new groups."""
    return Layout(n_dp=process_count(), dp=process_index())


def make_layout(n_dp: Optional[int] = None, n_tp: int = 1,
                n_sp: int = 1) -> Layout:
    """This rank's layout in a (n_dp, n_tp, n_sp) arrangement of the
    process group's ranks, in the row-major order of JAX's ``make_mesh``;
    ``n_dp`` defaults to world / (n_tp n_sp). Every rank makes every group,
    in the same order (``torch.distributed.new_group``'s rule), so every
    rank calls this with the same sizes. Sizes whose product is not the
    world size raise."""
    world, rank = process_count(), process_index()
    if n_dp is None:
        n_dp = world // (n_tp * n_sp)
    if min(n_dp, n_tp, n_sp) < 1 or n_dp * n_tp * n_sp != world:
        raise ValueError(f"a layout of n_dp {n_dp} x n_tp {n_tp} x n_sp "
                         f"{n_sp} needs that many ranks; the world has "
                         f"{world}")
    if n_tp == n_sp == 1:
        return default_layout()
    ranks = torch.arange(world).reshape(n_dp, n_tp, n_sp)
    coords = [int(c) for c in (ranks == rank).nonzero()[0]]

    def family(lines: torch.Tensor):
        """One group for each line of ranks (every rank makes each); this
        rank's."""
        mine = None
        for line in lines.reshape(-1, lines.shape[-1]).tolist():
            group = dist.new_group(line)
            if rank in line:
                mine = group
        return mine

    return Layout(
        n_dp=n_dp, n_tp=n_tp, n_sp=n_sp, dp=coords[0], tp=coords[1],
        sp=coords[2],
        dp_group=family(ranks.permute(1, 2, 0)),
        tp_group=family(ranks.permute(0, 2, 1)),
        sp_group=family(ranks),
        dpsp_group=family(ranks.permute(1, 0, 2).reshape(n_tp, -1)))


def local_batch_slice(global_batch_size: int,
                      layout: Optional[Layout] = None) -> slice:
    """The rows of the global batch this process packs: contiguous, in the
    order of the dp index (``vrdone_tpu/parallel/mesh.py::
    local_batch_slice``; under dp alone the dp index is the rank)."""
    layout = layout or default_layout()
    n = layout.n_dp
    assert global_batch_size % n == 0, (global_batch_size, n)
    local = global_batch_size // n
    return slice(layout.dp * local, (layout.dp + 1) * local)


# the time axis of each temporal key of a training batch (the JAX
# package's sp_batch_shardings: feats and seq_mask P(dp, sp), gt_masks
# P(dp, None, sp)); every other key is sharded over dp only
TIME_AXES = {"feats": 1, "seq_mask": 1, "gt_masks": 2}


def check_time_split(max_seq_len: int, n_sp: int, scale_factor: int,
                     n_levels: int) -> None:
    """Raise unless ``max_seq_len`` splits into n_sp shards that every
    pyramid level divides alike: each shard must start on a multiple of the
    coarsest level's stride, scale_factor ** n_levels."""
    stride = scale_factor ** n_levels
    if max_seq_len % (n_sp * stride):
        raise ValueError(
            f"max_seq_len {max_seq_len} does not split over n_sp {n_sp}: "
            f"sequence parallelism needs max_seq_len divisible by n_sp x "
            f"scale_factor ** backbone_arch[2] = {n_sp} x {stride}")


def time_slice(batch: dict, layout: Layout) -> dict:
    """This rank's time columns of a batch of its rows: ``feats``,
    ``seq_mask`` and ``gt_masks`` cut to the contiguous columns [sp T /
    n_sp, (sp + 1) T / n_sp); numpy arrays or tensors, the other keys as
    they are."""
    if layout.n_sp == 1:
        return batch
    out = dict(batch)
    for key, axis in TIME_AXES.items():
        x = batch[key]
        t = x.shape[axis] // layout.n_sp
        index = (slice(None),) * axis + (slice(layout.sp * t,
                                               (layout.sp + 1) * t),)
        out[key] = x[index]
    return out


# ---------------------------------------------------------------------------
# tensor parallelism: the parameters' shards
# ---------------------------------------------------------------------------

def tp_plan(model: nn.Module, n_tp: int,
            min_size: int = 1 << 16) -> dict[str, int]:
    """{parameter name: the dimension its shards split} under JAX's
    ``tp_shardings`` rule, taken on each leaf's JAX-layout shape: two or
    more axes, at least ``min_size`` elements and a last axis that n_tp
    divides. That axis is the output features, dim 0 in the port's layout,
    of a kernel, and the last dim of any other leaf (``query_embed``)."""
    plan = {}
    for name, p in model.named_parameters():
        # the JAX layout (convert.py::params_to_jax) reverses a kernel's axes
        dim = 0 if is_flax_kernel(name, p) else p.ndim - 1
        if (n_tp > 1 and p.ndim >= 2 and p.numel() >= min_size
                and p.shape[dim] % n_tp == 0):
            plan[name] = dim
    return plan


def shard_params_(model: nn.Module, layout: Layout,
                  min_size: int = 1 << 16) -> dict[str, int]:
    """Keep only this rank's shard of each leaf of ``tp_plan`` (counterpart
    of ``shard_params``), and record it on the leaf's module as
    ``tp_dims`` {attribute: dim} and ``tp_layout``, which its forward
    reads. Returns the plan."""
    plan = tp_plan(model, layout.n_tp, min_size)
    modules = dict(model.named_modules())
    for name, dim in plan.items():
        owner, _, attr = name.rpartition(".")
        module = modules[owner]
        if attr not in getattr(module, "TP_SHARDABLE", ()):
            raise NotImplementedError(
                f"{name}: {type(module).__name__} has no tensor-parallel "
                f"form for {attr}")
        full = getattr(module, attr)
        setattr(module, attr, nn.Parameter(
            take_shard(full.detach(), dim, layout).clone()))
        module.tp_dims = {**getattr(module, "tp_dims", {}), attr: dim}
        module.tp_layout = layout
    return plan


def take_shard(x: torch.Tensor, dim: int, layout: Layout) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` along ``dim``."""
    n = x.shape[dim] // layout.n_tp
    return x.narrow(dim, layout.tp * n, n)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (the default group: all
    ranks), in place; ``x`` itself without a process group."""
    if is_distributed():
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def barrier() -> None:
    """Every rank waits for the others (on the host group)."""
    if is_distributed():
        dist.barrier(group=host_group())


def rank0_first(fn):
    """``fn()`` on rank 0, then on the other ranks: what rank 0 writes (a
    dataset cache) the others then read, so no two ranks write one file."""
    if process_index() > 0:
        barrier()
    try:
        return fn()
    finally:
        if process_index() == 0:
            barrier()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _host_group
    if is_distributed():
        dist.destroy_process_group()
    _host_group = None
