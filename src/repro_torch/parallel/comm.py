"""The one door to ``torch.distributed`` for ``parallel/``, ``core/``,
``serve/`` and ``train/``: every collective those packages issue goes
through a function here, which counts it by kind in ``COUNTS`` and the
bytes of its output by kind in ``BYTES`` (both reset with
``reset_counts``), so a test or the card's smoke run can read how many
collectives a solve, an engine step or a train step made, and how much
they moved.

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
