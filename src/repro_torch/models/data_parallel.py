"""The data-parallel group a training forward runs in.

The reference trains on a mesh through GSPMD: one program over the global
batch, partitioned by the compiler, so a loss mean or a MoE statistic is
over every token whatever the batch sharding.  The port is SPMD: each rank
runs the model on its own rows (``launch/train.py``), and the few values of
the forward that are over the whole batch need a collective.  While a
``DataGroup`` is installed (``use``), the model reads it (``current``):

* ``models/lm.py``: the loss's denominator is the global ``sum(mask)`` (or
  token count); each rank's loss is its numerator over it, so the ranks'
  losses sum to the reference's.
* ``models/mlp.py``: the MoE load-balance statistics are over all tokens
  and capacity is per dispatch group of the global ``B * S`` tokens: where
  each rank's rows hold whole groups the statistics are all-reduced, else
  the tokens are all-gathered (with autograd) and routed globally.

The group is installed around the forward AND the backward: remat
recomputes a layer, and its collectives, in the backward.  It is one
process-wide setting, not a per-thread one: on CUDA the autograd engine
runs the backward, and with it the non-reentrant checkpoint's recompute,
on its own device thread, which must see the group the forward saw.  One
step runs at a time (SPMD), and every rank calls the collectives in the
same order.  Without a group the model is the single-device one.

``DataGroup`` also holds the group's collectives in shard order
(``all_gather``, ``reduce_scatter``, ``sum``), which ZeRO-1
(``optim/adamw.Zero1``) uses on the gradients and parameters; a dtype the
backends lack travels widened (``core.sharded.WIRE``), and a group of one
rank (the data axis of a (1, n) mesh) makes no collective: ``gloo`` would
carry a card tensor through the host to sum it with nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.sharded import WIRE

_group: DataGroup | None = None


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The ranks that split the batch's rows: ``group`` (a process group),
    ``size`` ranks, ``index`` this rank's shard (row-major over the data
    axes) and ``order`` the shard of each group rank."""
    group: object
    size: int
    index: int
    order: tuple[int, ...]

    def sum(self, t: torch.Tensor, *, grad: bool = False) -> torch.Tensor:
        """All-reduce SUM over the group; ``grad=True`` is differentiable
        (its backward all-reduces the gradient)."""
        if grad:
            return _Sum.apply(t, self)
        return self._all_reduce(t.detach())

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in shard order."""
        if self.size == 1:
            return x
        wire = WIRE.get(x.dtype)
        if wire is not None:
            return self.all_gather(x.to(wire), dim).to(x.dtype)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in self.order]
        dist.all_gather(parts, x, group=self.group)
        by_shard = [None] * self.size
        for j, p in zip(self.order, parts):
            by_shard[j] = p
        return torch.cat(by_shard, dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the sum over the group of
        every rank's ``x``."""
        if self.size == 1:
            return x
        wire = WIRE.get(x.dtype)
        if wire is not None:
            return self.reduce_scatter(x.to(wire), dim).to(x.dtype)
        chunks = [c.contiguous() for c in torch.chunk(x, self.size, dim)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, [chunks[j] for j in self.order], group=self.group)
        return out

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``all_gather`` along dim 0 with autograd (the backward sums each
        shard's gradient onto its rank: a reduce-scatter)."""
        return _GatherRows.apply(x, self)

    def local_rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of the whole ``x``."""
        return torch.chunk(x, self.size, dim=dim)[self.index]

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        if self.size == 1:               # the sum over one rank: no collective
            return t.clone(memory_format=torch.contiguous_format)
        wire = WIRE.get(t.dtype)
        out = t.to(wire) if wire is not None else t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out if wire is None else out.to(t.dtype)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dg):
        ctx.dg = dg
        return dg._all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.dg._all_reduce(g), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dg):
        ctx.dg = dg
        return dg.all_gather(x, 0)

    @staticmethod
    def backward(ctx, g):
        return ctx.dg.reduce_scatter(g, 0), None


@contextlib.contextmanager
def use(group: DataGroup | None):
    """Install ``group`` for the ``with`` block (process-wide)."""
    global _group
    prev, _group = _group, group
    try:
        yield group
    finally:
        _group = prev


def current() -> DataGroup | None:
    return _group
