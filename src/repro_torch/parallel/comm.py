"""The one door to ``torch.distributed`` for ``parallel/``, ``core/``,
``serve/`` and ``train/``: every collective those packages issue goes
through a function here, which counts it by kind in ``COUNTS`` and the
bytes of its output by kind in ``BYTES`` (both reset with
``reset_counts``), so a test or the card's smoke run can read how many
collectives a solve, an engine step or a train step made, and how much
they moved.  The differentiable regions of tensor parallelism (Megatron's
copy-to / reduce-from, gather-from- / scatter-to-sequence:
``parallel.tensor``) are ``autograd.Function``s over the same functions, so
the counts hold their backward's collectives too.

Only ``torch.distributed`` names present in both torch 2.11 and 2.13 are
used: the list forms of all_gather and reduce_scatter (the ``*_tensor``
forms are deprecated in 2.13, whose ``*_single`` replacements 2.11 lacks).
DTensor's own collectives (``full_tensor``, ``redistribute``) are never
called on these paths: under gloo with CUDA tensors on two ranks of one
card they crash in torch 2.11 (PERF.md §7), while the forms here work.
"""
from __future__ import annotations

import collections
from typing import List

import torch
import torch.distributed as dist

#: collectives issued since the last ``reset_counts``, by kind
COUNTS: collections.Counter = collections.Counter()
#: bytes of those collectives' outputs, by kind
BYTES: collections.Counter = collections.Counter()


def reset_counts() -> None:
    COUNTS.clear()
    BYTES.clear()


def _count(kind: str, nbytes: int) -> None:
    COUNTS[kind] += 1
    BYTES[kind] += nbytes


def counts() -> dict:
    return dict(COUNTS)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    _count("all_reduce", _nbytes(t))
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every member's ``t`` (same shape and dtype on every member), in
    group-rank order."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    _count("all_gather", _nbytes(t) * len(out))
    dist.all_gather(out, t, group=group)
    return out


def reduce_scatter(chunks: List[torch.Tensor], group) -> torch.Tensor:
    """Sum the members' ``chunks`` elementwise and hand member i the sum of
    chunk i (the chunks are equal in shape)."""
    chunks = [c.contiguous() for c in chunks]
    out = torch.empty_like(chunks[0])
    _count("reduce_scatter", _nbytes(out))
    dist.reduce_scatter(out, chunks, op=dist.ReduceOp.SUM, group=group)
    return out


def reduce(t: torch.Tensor, dst: int, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` into the member of global rank ``dst``, in
    place (the other members' ``t`` is left undefined)."""
    _count("reduce", _nbytes(t))
    dist.reduce(t, dst=dst, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of the member of global rank ``src`` into every member's
    ``t``, in place."""
    _count("broadcast", _nbytes(t))
    dist.broadcast(t, src=src, group=group)
    return t


def is_writer() -> bool:
    """Rank 0 of the world (or no process group at all): the one process
    that writes what every rank holds alike."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# differentiable regions (Megatron's): each forward and backward collective
# goes through the counted functions above, so COUNTS and BYTES see the
# backward's too.  ``group`` is a ``layout.Group``: ``order[b]`` is the group
# rank that holds block b, so a tensor split over the group is cut and
# joined in block order whatever the process group's rank order.
# ---------------------------------------------------------------------------

def _join(parts: List[torch.Tensor], group, dim: int) -> torch.Tensor:
    return torch.cat([parts[g] for g in group.order], dim)


def _scatter_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum ``x`` over the group and keep this member's block along
    ``dim`` (block b goes to the member at group rank order[b])."""
    blocks = torch.chunk(x, len(group.order), dim=dim)
    chunks = [None] * len(group.order)
    for b, g in enumerate(group.order):
        chunks[g] = blocks[b]
    return reduce_scatter(chunks, group.group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _join(all_gather(x, group.group), group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _join(all_gather(g, ctx.group.group), ctx.group,
                     ctx.dim), None, None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, summed):
        ctx.group, ctx.summed, ctx.n = group, summed, x.shape[-1]
        return _join(all_gather(x, group.group), group, x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return _scatter_sum(g, ctx.group, g.dim() - 1), None, None
        block = ctx.group.order.index(dist.get_rank(ctx.group.group))
        return g.narrow(-1, block * ctx.n, ctx.n), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` (all_reduce):
    the input of column-parallel layers on a replicated activation."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (all_reduce); identity backward: the
    output of row-parallel layers."""
    return _ReduceFrom.apply(x, group)


def gather_from_sequence(x: torch.Tensor, group, dim: int = 1):
    """The members' blocks of ``x`` joined along ``dim`` (all_gather); the
    gradient summed over ``group`` and cut back to this member's block
    (reduce_scatter)."""
    return _GatherSeq.apply(x, group, dim)


def gather_columns(x: torch.Tensor, group, summed: bool):
    """The members' column blocks of ``x`` joined along its last dim
    (all_gather); the gradient cut back to this member's block, summed over
    ``group`` first when ``summed`` (reduce_scatter; the members' gradients
    are partial), else as it is (no collective; they are whole and
    alike)."""
    return _GatherColumns.apply(x, group, summed)


def scatter_to_sequence(x: torch.Tensor, group, dim: int = 1):
    """``x`` summed over ``group`` and cut to this member's block along
    ``dim`` (reduce_scatter); the gradient's blocks joined (all_gather)."""
    return _ScatterSeq.apply(x, group, dim)
