"""Logical-axis -> mesh-axis rules and the activation sharding hook (the JAX
package's ``repro.parallel.mesh_rules``).

The mesh axes are ("pod", "data", "model") or ("data", "model"): tensor
parallelism ("model") inside a pod, data parallelism over ("pod", "data").
``make_sharder(mesh)`` returns ``shard(x, logical_axes)``; on a DTensor
activation it redistributes to the resolved placements (the counterpart of
``with_sharding_constraint``), and on a plain local tensor, or for
``mesh=None``, it is the identity: an SPMD rank's plain tensor is already
its own block.
"""
from __future__ import annotations

import math
from typing import Optional

from .layout import P, axis_names, axis_sizes, placements

# logical activation axis -> mesh axis (resolved against the live mesh)
LOGICAL_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    # the layer-boundary residual stream saved for the backward, sequence
    # sharded over "model" (Korthikanti-style sequence parallelism)
    "seq_carry": "model",
    "kv_seq": "data",        # long-context decode: shard cache sequence
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "embed": None,
    "ffn": "model",
    "experts": None,          # expert weights are TP-sharded on d_ff by
    "vocab": "model",         # default; EP (experts->model) is a config knob
}


def _resolve(axis_entry, names):
    if axis_entry is None:
        return None
    if isinstance(axis_entry, tuple):
        live = tuple(a for a in axis_entry if a in names)
        return live if live else None
    return axis_entry if axis_entry in names else None


def resolve_spec(mesh, rules: dict, shape, axes) -> P:
    """The ``PartitionSpec`` the rules give a tensor of ``shape`` whose dims
    carry the logical ``axes``; a dim that its mesh axes do not divide is
    never constrained."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    entries = []
    for dim, a in zip(shape, axes):
        e = _resolve(rules.get(a), names)
        if e is not None:
            size = sizes[e] if isinstance(e, str) else math.prod(
                sizes[n] for n in e)
            if dim % size != 0 or dim < size:
                e = None
        entries.append(e)
    return P(*entries)


def make_sharder(mesh, rules=None, overrides: Optional[dict] = None):
    """Returns ``shard(x, logical_axes)``.

    ``overrides`` retargets logical axes per shape cell (e.g. {"seq":
    "model"} for sequence-parallel activations, or {"batch": None,
    "kv_seq": "data"} for batch-1 long-context decode).  The returned
    function carries the mesh as ``shard.mesh`` (None for no mesh)."""
    if mesh is None:
        def shard(x, axes):
            return x
        shard.mesh = None
        return shard
    rules = dict(rules or LOGICAL_RULES)
    if overrides:
        rules.update(overrides)

    def shard(x, axes):
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor) or x.ndim != len(axes):
            return x
        want = placements(mesh, resolve_spec(mesh, rules, x.shape, axes))
        if tuple(x.placements) == want:
            return x
        return x.redistribute(mesh, want)

    shard.mesh = mesh
    return shard
