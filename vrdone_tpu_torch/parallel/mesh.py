"""The data-parallel layout (counterpart of the dp part of
``vrdone_tpu/parallel/mesh.py``).

The JAX package shards each global batch over the "dp" axis of one device
mesh, and XLA inserts the gradient all-reduce. The port runs one process
per card under ``torchrun``, which sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``: each process packs its contiguous rows of the global batch
(``local_batch_slice``, process-major as the mesh orders its devices), and
the train step sums the ranks' partial gradients with one all-reduce
(``train/loop.py``). With no process group every helper gives the
one-process answer, so the same code runs in one process.

The default group is NCCL on the card and gloo on the CPU. Host-side
collectives (the pickled objects of the eval merge, barriers) run on a
gloo group of their own, so they work whatever the default backend is,
two ranks sharing one card included.

The tensor- and sequence-parallel layouts of the JAX mesh
(``tp_shardings``, ``sp_batch_shardings``) are GSPMD's and not ported;
see ROADMAP.md queue 1, sequence and tensor parallelism.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

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


def local_batch_slice(global_batch_size: int) -> slice:
    """The rows of the global batch this process packs: contiguous, in
    rank order (``vrdone_tpu/parallel/mesh.py::local_batch_slice``)."""
    n = process_count()
    assert global_batch_size % n == 0, (global_batch_size, n)
    local = global_batch_size // n
    r = process_index()
    return slice(r * local, (r + 1) * local)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, in place, on the default group; ``x``
    itself without a process group."""
    if is_distributed():
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
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
