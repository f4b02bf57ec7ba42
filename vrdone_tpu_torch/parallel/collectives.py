"""The collectives of sequence and tensor parallelism (what GSPMD places
for the JAX package's "sp" and "tp" mesh axes).

The objective is the sum of every rank's loss. A term that is replicated
over the ranks of an sp (or tp) group carries a weight of 1/n_sp (1/n_tp),
and a time-sharded term is the rank's partial sum over the global
normalisers (``models/maskvrd.py::compute_losses``). Each collective here
is a ``torch.autograd.Function`` whose backward is the adjoint of its
forward, so the gradient of a replicated leaf on a rank is its partial
gradient, and summing over the ranks gives the whole one:

  * ``gather``: the ranks' tensors concatenated along a dim (keys and
    values along T, a layer's output features, a sharded parameter) <->
    reduce-scatter: the gradients summed over the ranks, each rank's slice;
  * ``halo``: the neighbours' edge rows along T <-> their gradients sent
    back and added to the rows they came from;
  * ``all_sum``: the sum over the ranks <-> the sum over the ranks.

Each runs as one all-reduce of a buffer in which a rank fills its own slot
(zeros elsewhere: the sum is exact), forward and backward, because gloo
takes all-reduces of CUDA tensors and not all-gathers, and two ranks
sharing one card (which NCCL refuses) run on gloo.

Which tensors are time-sharded is scoped, not global state: the train step
runs its forward and its losses under ``time_sharded(layout)``, the ops
of ``ops/masked.py`` read ``time_layout()`` to take their halos and
gathers and ``models/losses.py`` reads it to sum its time reductions over
the sp ranks; ``time_whole()`` turns it off where the tensors are whole along T again
(the predictor's decoder on the gathered coarsest level).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Layout

_time: contextvars.ContextVar[Optional[Layout]] = contextvars.ContextVar(
    "time_layout", default=None)


@contextlib.contextmanager
def time_sharded(layout: Layout):
    """Inside: the (B, T, ...) tensors of the ops are this rank's columns
    of ``layout``'s sp split (nothing changes when n_sp is 1)."""
    token = _time.set(layout if layout.n_sp > 1 else None)
    try:
        yield
    finally:
        _time.reset(token)


@contextlib.contextmanager
def time_whole():
    """Inside: the tensors are whole along T (no halo, no gather)."""
    token = _time.set(None)
    try:
        yield
    finally:
        _time.reset(token)


def time_layout() -> Optional[Layout]:
    """The layout whose sp split the current tensors follow, or None."""
    return _time.get()


def _slots(x: torch.Tensor, group, n: int, index: int) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in its slot, one all-reduce."""
    buf = x.new_zeros((n, *x.shape))
    buf[index] = x
    dist.all_reduce(buf, group=group)
    return buf


class _Gather(torch.autograd.Function):
    """Every rank's x stacked on a new leading axis; backward: the
    gradients summed over the ranks, this rank's slot."""

    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.index = group, index
        return _slots(x, group, n, index)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index], None, None, None


def gather(x: torch.Tensor, dim: int, group, n: int,
           index: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` concatenated along ``dim`` in rank order
    (this rank's is ``index``); ``x`` itself when n is 1."""
    if n == 1:
        return x
    return torch.cat(_Gather.apply(x, group, n, index).unbind(0), dim)


class _Sum(torch.autograd.Function):
    """The sum over the ranks; backward: the sum of the gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``x`` summed over the ``n`` ranks of ``group``, differentiably."""
    return x if n == 1 else _Sum.apply(x, group)


class _Halo(torch.autograd.Function):
    """x (B, T, ...) extended along T by ``left`` rows of the ranks before
    it and ``right`` rows of the ranks after it, ``fill`` past the global
    edges. A halo wider than a shard reads several neighbours. Backward:
    the halo rows' gradients go back to the ranks they came from and are
    added to those rows."""

    @staticmethod
    def forward(ctx, x, left, right, fill, group, n, index):
        t = x.shape[1]
        hl, hr = min(left, t), min(right, t)
        kl, kr = math.ceil(left / t), math.ceil(right / t)
        ctx.geom = (t, left, right, hl, hr, kl, kr, group, n, index)
        # each rank's tail (for the ranks after it), then its head
        buf = _slots(torch.cat([x[:, t - hl:], x[:, :hr]], 1), group, n,
                     index)

        def part(j, rows):
            if 0 <= j < n:
                return buf[j, :, :hl] if rows == "tail" else buf[j, :, hl:]
            size = hl if rows == "tail" else hr
            return x.new_full((x.shape[0], size, *x.shape[2:]), fill)

        pieces = []
        if left:
            before = torch.cat([part(j, "tail")
                                for j in range(index - kl, index)], 1)
            pieces.append(before[:, kl * hl - left:])
        pieces.append(x)
        if right:
            after = torch.cat([part(j, "head")
                               for j in range(index + 1, index + 1 + kr)], 1)
            pieces.append(after[:, :right])
        return torch.cat(pieces, 1)

    @staticmethod
    def backward(ctx, g):
        t, left, right, hl, hr, kl, kr, group, n, index = ctx.geom
        gx = g[:, left:left + t].clone(memory_format=torch.contiguous_format)
        gbuf = g.new_zeros((n, g.shape[0], hl + hr, *g.shape[2:]))
        if left:
            before = g.new_zeros((g.shape[0], kl * hl, *g.shape[2:]))
            before[:, kl * hl - left:] = g[:, :left]
            for i, j in enumerate(range(index - kl, index)):
                if j >= 0:
                    gbuf[j, :, :hl] += before[:, i * hl:(i + 1) * hl]
        if right:
            after = g.new_zeros((g.shape[0], kr * hr, *g.shape[2:]))
            after[:, :right] = g[:, left + t:]
            for i, j in enumerate(range(index + 1, index + 1 + kr)):
                if j < n:
                    gbuf[j, :, hl:] += after[:, i * hr:(i + 1) * hr]
        dist.all_reduce(gbuf, group=group)
        gx[:, t - hl:] += gbuf[index, :, :hl]
        gx[:, :hr] += gbuf[index, :, hl:]
        return gx, None, None, None, None, None, None


def halo(x: torch.Tensor, left: int, right: int, fill: float,
         layout: Layout) -> torch.Tensor:
    """(B, left + T + right, ...): this rank's (B, T, ...) columns with the
    ``left`` global rows before them and the ``right`` after them from the
    other ranks of ``layout``'s sp group, ``fill`` past the sequence's
    global edges (the padding of a convolution or a pool)."""
    if not left and not right:
        return x
    return _Halo.apply(x, left, right, fill, layout.sp_group, layout.n_sp,
                       layout.sp)


def gather_time(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The whole (B, T, ...) from every sp rank's columns."""
    return gather(x, 1, layout.sp_group, layout.n_sp, layout.sp)


def gather_time_mask(mask: torch.Tensor, layout: Layout) -> torch.Tensor:
    """The whole (B, T) bool mask from every sp rank's columns."""
    return gather_time(mask.to(torch.float32), layout) > 0.5


def sum_time(x: torch.Tensor, layout: Layout) -> torch.Tensor:
    """``x`` summed over the sp ranks (a time reduction's partial sums),
    differentiably."""
    return all_sum(x, layout.sp_group, layout.n_sp)


def gather_features(x: torch.Tensor, dim: int,
                    layout: Layout) -> torch.Tensor:
    """The whole tensor from every tp rank's shard along ``dim`` (a
    layer's output features, a sharded parameter)."""
    return gather(x, dim, layout.tp_group, layout.n_tp, layout.tp)
