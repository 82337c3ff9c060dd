"""Elastic restart: lay a train state out on a (different) mesh (the JAX
package's ``repro.runtime.elastic``).

Checkpoints store full logical arrays, so elasticity reduces to cutting
each rank's block out of the full leaf for the new mesh.  ``reshard_state``
also handles LIVE state (a (4,) data mesh regrown as (2, 2) after a loss):
each leaf is first made whole (all_gathers over the mesh dims it is split
on, through ``parallel.comm``; every rank must call it), then cut for the
new layout; no leaf takes DTensor's own collectives.

A laid-out leaf is a DTensor (the spec's placements over the mesh), or,
for a ZeRO-1 ``Owned`` spec (a unit's optimizer leaf held whole by one data
slice), an ``OwnedShard``: the owners' piece, None elsewhere.  ``specs``
follows ``state``'s pytree (e.g. ``parallel.state_specs``), so a
``train.TrainState`` reshards like any other pytree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from ..parallel import comm
from ..parallel.layout import (axes_group, axis_names, coordinate,
                               distribute, gather_local, is_spec,
                               local_piece, placements)
from ..parallel.shardings import Owned


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: ``spec`` (a ``PartitionSpec``, placements or an
    ``Owned``) over ``mesh``."""
    mesh: Any
    spec: Any


@dataclasses.dataclass
class OwnedShard:
    """A leaf laid out by an ``Owned`` spec: ``local`` is this rank's piece
    (the leaf, cut by the spec's placements over the other mesh axes) on
    the owning slice, None on the other ranks."""
    local: Optional[torch.Tensor]
    sharding: NamedSharding
    shape: torch.Size
    dtype: torch.dtype

    def piece_shape(self):
        mesh = self.sharding.mesh
        place = placements(mesh, self.sharding.spec.spec)
        return tuple(local_piece(torch.empty(self.shape, device="meta"),
                                 mesh, place).shape)


def _is_spec_leaf(x) -> bool:
    return x is None or isinstance(x, Owned) or is_spec(x)


def mesh_shardings(mesh, specs: Any):
    """``NamedSharding`` tree from a spec tree."""
    return pytree.tree_map(lambda s: None if s is None
                           else NamedSharding(mesh, s), specs,
                           is_leaf=_is_spec_leaf)


def shard_leaf(full: Optional[torch.Tensor], sharding: Optional[NamedSharding]):
    """Lay a full leaf (the same on every rank) out per ``sharding``, with
    no communication: each rank keeps its own block."""
    if sharding is None or full is None:
        return full
    mesh, spec = sharding.mesh, sharding.spec
    if isinstance(spec, Owned):
        mine = coordinate(mesh)[axis_names(mesh).index(spec.axis)]
        local = (local_piece(full, mesh, placements(mesh, spec.spec))
                 .contiguous() if mine == spec.index else None)
        return OwnedShard(local, sharding, full.shape, full.dtype)
    return distribute(full, mesh, placements(mesh, spec))


def full_leaf(leaf):
    """The full tensor of a laid-out leaf, on every rank (collective for a
    split or owned leaf: every rank must call it).  A plain tensor is
    returned as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        return gather_local(leaf.to_local(), leaf.device_mesh,
                            tuple(leaf.placements))
    if isinstance(leaf, OwnedShard):
        mesh, spec = leaf.sharding.mesh, leaf.sharding.spec
        device = mesh.device_type
        local = leaf.local if leaf.local is not None else torch.zeros(
            leaf.piece_shape(), dtype=leaf.dtype, device=device)
        full = gather_local(local, mesh, placements(mesh, spec.spec))
        g = axes_group(mesh, [spec.axis])
        return comm.broadcast(full.contiguous(), g.ranks[spec.index],
                              g.group)
    return leaf


def reshard_state(state: Any, mesh, specs: Any):
    """Lay every leaf of ``state`` out on ``mesh`` per ``specs`` (live
    state: each leaf is made whole first, then cut)."""
    shardings = mesh_shardings(mesh, specs)
    leaves, tree = pytree.tree_flatten(state, is_leaf=_is_laid_out)
    flat = tree.flatten_up_to(shardings)
    return pytree.tree_unflatten(
        [shard_leaf(full_leaf(l), s) for l, s in zip(leaves, flat)], tree)


def _is_laid_out(x) -> bool:
    return isinstance(x, OwnedShard)
