"""Mesh-sharded masked-batch solving: lanes over the data axes, SPMD.

``solve(..., batch_axis=0, mesh=...)`` splits the lane axis of the masked
per-lane drivers over the mesh's data-parallel axes.  One process runs per
device, each the same program on its own block:

* Lanes are split contiguously over the longest *divisible prefix* of
  ``("pod", "data")`` present in the mesh (``lane_axes``); each rank runs
  the SAME local program a single-process solve of its lane block runs,
  so its values, stats, grids and h carries are bitwise those of that
  solve.
* The per-lane controller state lives rank-local: the forward makes NO
  collective.
* Both exact backward passes (the symplectic Algorithm-2 replay and the
  continuous adjoint) replay each lane's grid rank-locally; the only
  collectives of the backward are the reductions of the replicated
  parameters' cotangents over the lane axes, one all_reduce per parameter
  leaf, made by one ``autograd.Function`` at the solve boundary
  (``_ReduceCotangents``) and nowhere else.  The count is read off
  ``parallel.comm.COUNTS``.
* The outputs are DTensors built from the local blocks (no collective):
  ``ys`` on the lane axis (axis 0 for t1, axis 1 for the time-major
  ``SaveAt(ts)`` stacks), stats and success on axis 0.  The gradient of a
  full ``x0`` held by every rank is lane-local: each rank's x0.grad holds
  its own block's rows (zeros elsewhere).
"""
from __future__ import annotations

import collections.abc
import math
import warnings
from typing import Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..core.stepper import (BatchedAdaptiveSolution, BatchedSolverState,
                            SolverState)
from . import comm
from .layout import (axes_group, axis_names, axis_sizes, from_local, gather,
                     is_spec, lane_spec, local_piece, placements, replicated)

#: Mesh axes a batch's lane dim may shard over, in precedence order.
DATA_AXES: Tuple[str, ...] = ("pod", "data")


def lane_axes(mesh, batch: int, axes: Sequence[str] = DATA_AXES, *,
              require: bool = False) -> Tuple[str, ...]:
    """Longest divisible prefix of the data axes for a ``batch``-sized dim.

    Returns the longest prefix of ``axes`` (restricted to axes present in
    ``mesh``) whose total size divides ``batch``, so a batch that is not
    divisible by the FULL data-parallel product still shards over the axes
    it can fill (B=6 on a (2, 2) ("pod", "data") mesh shards over "pod"
    alone).  Warns whenever axes are dropped; with ``require=True`` an
    empty result raises instead of degrading to replication.
    """
    sizes = axis_sizes(mesh)
    present = tuple(a for a in axes if a in sizes)
    chosen = present
    while chosen and batch % math.prod(sizes[a] for a in chosen) != 0:
        chosen = chosen[:-1]
    if not chosen and require:
        detail = (f"no prefix of its data axes {present} divides the "
                  f"batch dim {batch}" if present
                  else f"mesh axes {tuple(sizes)} contain none of the "
                       f"data axes {tuple(axes)}")
        raise ValueError(
            f"cannot shard the lane axis: {detail}.  Pad the batch or "
            "pick a mesh whose leading data axis divides it")
    if chosen != present:
        full = math.prod(sizes[a] for a in present)
        warnings.warn(
            f"batch dim {batch} is not divisible by the full "
            f"data-parallel product {full} of mesh axes {present}; "
            + (f"sharding over the divisible prefix {chosen} "
               f"(size {math.prod(sizes[a] for a in chosen)})"
               if chosen else "no prefix divides — lanes replicated"),
            stacklevel=2)
    return chosen


def shard_count(mesh, axes: Sequence[str]) -> int:
    """Number of lane shards a mesh realizes over ``axes``."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes) if axes else 1


def batched_solution_specs(mesh, axes: Sequence[str]
                           ) -> BatchedAdaptiveSolution:
    """Placements for a ``BatchedAdaptiveSolution``: per-lane leaves on the
    lane axes, step-major checkpoint buffers (max_steps + 1, B, ...) on
    axis 1."""
    lane = lane_spec(mesh, axes)
    step = lane_spec(mesh, axes, lane_axis=1)
    return BatchedAdaptiveSolution(
        x_final=lane, xs=step, ts=step, hs=step, n_accepted=lane,
        n_fevals=lane, succeeded=lane, h_final=lane, n_attempts=lane)


def solver_state_specs(mesh, state, axes: Sequence[str]):
    """Placements for a solver state (the serve engine's resident state):
    a ``BatchedSolverState``'s per-lane fields on the lane axes (its (B,)
    horizons too: the engine's requests each have their own) and its
    step-major checkpoint buffers on axis 1; a single ``SolverState``'s
    fields all replicate (no lane axis)."""
    lane = lane_spec(mesh, axes)
    step = lane_spec(mesh, axes, lane_axis=1)
    rep = replicated(mesh)
    if isinstance(state, SolverState):
        return SolverState(
            t0=rep, t1=rep, t=rep, x=pytree.tree_map(lambda _: rep, state.x),
            h=rep, n_accepted=rep, n_attempts=rep, n_fevals=rep, xs=rep,
            ts=rep, hs=rep, active=rep,
            rtol=None if state.rtol is None else rep,
            atol=None if state.atol is None else rep)

    def opt(v, spec):
        return None if v is None else spec

    return BatchedSolverState(
        t0=lane, t1=lane, t=lane, x=pytree.tree_map(lambda _: lane, state.x),
        h=lane, n_accepted=lane, n_attempts=lane, n_fevals=lane,
        xs=None if state.xs is None else pytree.tree_map(lambda _: step,
                                                         state.xs),
        ts=opt(state.ts, step), hs=opt(state.hs, step), lanes=lane,
        live=lane, active=rep, rtol=opt(state.rtol, lane),
        atol=opt(state.atol, lane))


def resolve_param_specs(params, mesh, sharding):
    """The params layout of a sharded solve, per leaf.

    ``None`` replicates (the default, and the only layout under which the
    rank-local replay needs no collective but the cotangent reductions);
    ``"auto"`` applies the ``shardings.param_specs`` path rules (on a
    data-only mesh they replicate); anything else is a per-leaf tree of
    ``PartitionSpec``s or placements matching ``params``."""
    if sharding is None:
        return None
    if sharding == "auto":
        from .shardings import param_specs
        return param_specs(params, mesh)
    return sharding


class _ReduceCotangents(torch.autograd.Function):
    """Identity on the parameter leaves in the forward; in the backward,
    each leaf's cotangent is summed over its reduction group: ONE
    all_reduce per leaf (a leaf no lane used contributes zeros, so every
    rank issues the same collectives)."""

    @staticmethod
    def forward(ctx, groups, *leaves):
        ctx.groups = groups
        return tuple(l.view_as(l) for l in leaves)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g, group, need in zip(grads, ctx.groups,
                                  ctx.needs_input_grad[1:]):
            if not need:
                out.append(None)
                continue
            if group is not None:
                g = comm.all_reduce(g.contiguous().clone(), group)
            out.append(g)
        return (None, *out)


def _local_params(params, mesh, axes, params_spec):
    """Each param leaf's local block, wrapped so that its cotangent is
    summed over the lane axes on which the leaf is replicated."""
    leaves, spec = pytree.tree_flatten(params)
    if params_spec is None:
        specs = [replicated(mesh)] * len(leaves)
    else:
        specs = [placements(mesh, s) for s in pytree.tree_flatten(
            params_spec, is_leaf=is_spec)[0]]
    names = axis_names(mesh)
    from torch.distributed.tensor import DTensor, Replicate
    local, groups = [], []
    for leaf, place in zip(leaves, specs):
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        elif place != replicated(mesh):
            leaf = local_piece(leaf, mesh, place)
        rep = tuple(a for a in axes
                    if isinstance(place[names.index(a)], Replicate))
        local.append(leaf)
        groups.append(axes_group(mesh, rep).group if rep else None)
    if torch.is_grad_enabled() and any(
            isinstance(l, torch.Tensor) and l.requires_grad for l in local):
        idx = [i for i, l in enumerate(local) if isinstance(l, torch.Tensor)
               and (l.is_floating_point() or l.is_complex())]
        wrapped = _ReduceCotangents.apply(tuple(groups[i] for i in idx),
                                          *(local[i] for i in idx))
        for i, w in zip(idx, wrapped):
            local[i] = w
    return pytree.tree_unflatten(local, spec)


def _local_lanes(x0, mesh, axes):
    """This rank's lane block of every x0 leaf: a DTensor's local block
    (it must be sharded on axis 0 over the lane axes), or a narrow view of
    a full tensor every rank holds (no communication)."""
    from torch.distributed.tensor import DTensor
    want = lane_spec(mesh, axes)

    def one(leaf):
        if isinstance(leaf, DTensor):
            if tuple(leaf.placements) != want:
                raise ValueError(
                    f"solve(mesh=...): a DTensor x0 must be sharded on axis "
                    f"0 over the lane axes {tuple(axes)} (placements "
                    f"{want}); got {tuple(leaf.placements)}")
            return leaf.to_local()
        return local_piece(leaf, mesh, want)

    return pytree.tree_map(one, x0)


def sharded_solve_triple(body, mesh, axes: Sequence[str], x0, params, *,
                         params_spec=None, ys_lane_axis: int = 0):
    """Run a local ``(ys, stats, success)`` solve body on this rank's lane
    block (the counterpart of JAX's ``shard_map``).

    ``body(x0_local, params_local)`` must be the LOCAL solve: exactly what
    a single-process call runs on one lane block.  Returns ``ys`` (lanes on
    ``ys_lane_axis``: 0 for t1, 1 for time-major SaveAt stacks), ``stats``
    and ``success`` (lanes on axis 0) as DTensors over ``mesh``.
    """
    ys, stats, success = body(_local_lanes(x0, mesh, axes),
                              _local_params(params, mesh, axes, params_spec))
    ys_place = lane_spec(mesh, axes, ys_lane_axis)
    lane = lane_spec(mesh, axes)
    return (pytree.tree_map(lambda l: from_local(l, mesh, ys_place), ys),
            {k: from_local(v, mesh, lane) for k, v in stats.items()},
            from_local(success, mesh, lane))


class ShardLoadStats(collections.abc.Mapping):
    """A sharded solve's stats with the cross-shard load metrics.

    ``shard_steps`` is an (n_shards,) DTensor whose local element is this
    rank's accepted-step total (built with no collective).
    ``load_imbalance`` = max/mean of the shard totals (1.0 = balanced)
    needs every rank's total: it is gathered (one all_gather, through
    ``comm``) when first read, outside the solve, and every rank must read
    it."""

    def __init__(self, stats: dict):
        self._d = dict(stats)

    def __getitem__(self, key):
        if key == "load_imbalance" and key not in self._d:
            self._d[key] = _imbalance(gather(self._d["shard_steps"]))
        return self._d[key]

    def __iter__(self):
        yield from self._d
        if "load_imbalance" not in self._d:
            yield "load_imbalance"

    def __len__(self):
        return len(self._d) + ("load_imbalance" not in self._d)


def _imbalance(shard_steps: torch.Tensor) -> torch.Tensor:
    f = shard_steps.to(torch.float64)
    mean = f.mean()
    return torch.where(mean > 0, f.max() / mean, torch.ones_like(mean))


def with_shard_load_stats(stats: dict, n_shards: int):
    """Attach the cross-shard load-imbalance metric to a solve's stats.

    On full per-lane counts (a plain tensor: lanes are contiguous blocks)
    ``shard_steps`` is a reshape-sum and ``load_imbalance`` is computed at
    once.  On a sharded solve's DTensor counts the local sum IS this
    rank's shard total: ``shard_steps`` is built from it with no
    collective, and ``load_imbalance`` is gathered when read
    (``ShardLoadStats``).  The adaptive loop of a shard runs until its
    slowest lane finishes, so max/mean approximates the wall-clock cost of
    heterogeneous stiffness across shards."""
    from torch.distributed.tensor import DTensor
    steps = stats["n_steps"]
    out = dict(stats)
    if isinstance(steps, DTensor):
        local = steps.to_local().to(torch.int64).sum().reshape(1)
        out["shard_steps"] = from_local(local, steps.device_mesh,
                                        tuple(steps.placements))
        return ShardLoadStats(out)
    out["shard_steps"] = steps.reshape(n_shards, -1).to(torch.int64).sum(1)
    out["load_imbalance"] = _imbalance(out["shard_steps"])
    return out
