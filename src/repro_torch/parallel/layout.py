"""Meshes, specs and placements: the vocabulary the rest of ``parallel``
speaks.

* A mesh is a ``torch.distributed`` ``DeviceMesh`` (dims named by
  ``mesh_dim_names``), or, for the spec rules alone, any object with the
  JAX package's duck-typed ``.shape`` (a dict of axis sizes) and
  ``.axis_names`` (the rules read sizes and names only).
* A ``PartitionSpec`` names, per tensor dim, the mesh axes that dim is
  split over (None, a name or a tuple of names), as JAX's does.
* Placements are DTensor's: one ``Shard(d)`` / ``Replicate()`` per mesh
  dim (``placements`` converts a spec).  A tensor dim split over several
  mesh dims is split in mesh-dim order, dim 0 outermost, so the block of a
  rank is its row-major index over those dims.

Every rank of an SPMD program holds its own block; ``local_piece`` cuts it
out of a full tensor and ``from_local`` presents it as a DTensor, both with
no communication; ``gather`` makes it whole again through ``comm``.
``axes_group`` makes the process group that spans a set of mesh axes (the
lane group of a sharded solve), collectively on first use, then cached.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from . import comm


class PartitionSpec(tuple):
    """Per-tensor-dim mesh axes (None, "name" or ("name", ...)); equal to
    the same tuple, so it compares with JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P" + super().__repr__()


P = PartitionSpec


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _placement_types():
    from torch.distributed.tensor import Replicate, Shard
    return Replicate, Shard


def is_placements(spec) -> bool:
    from torch.distributed.tensor.placement_types import Placement
    return isinstance(spec, tuple) and len(spec) > 0 and all(
        isinstance(e, Placement) for e in spec)


def is_spec(x) -> bool:
    """A leaf of a spec tree: a ``PartitionSpec`` or a placements tuple."""
    return isinstance(x, PartitionSpec) or is_placements(x)


def placements(mesh, spec) -> tuple:
    """DTensor placements (one per mesh dim) of a ``PartitionSpec`` (or of
    JAX's; placements pass through): ``Shard(i)`` on each mesh dim that
    tensor dim i names, ``Replicate()`` on the others."""
    if is_placements(spec):
        return tuple(spec)
    Replicate, Shard = _placement_types()
    out = []
    for name in axis_names(mesh):
        dim = None
        for i, e in enumerate(spec):
            if e == name or (isinstance(e, tuple) and name in e):
                dim = i
        out.append(Shard(dim) if dim is not None else Replicate())
    return tuple(out)


def replicated(mesh) -> tuple:
    Replicate, _ = _placement_types()
    return tuple(Replicate() for _ in axis_names(mesh))


def lane_spec(mesh, axes: Sequence[str], lane_axis: int = 0) -> tuple:
    """Placements putting the lane axes at tensor dim ``lane_axis``:
    ``Shard(lane_axis)`` on the mesh dims named in ``axes``,
    ``Replicate()`` on the others."""
    Replicate, Shard = _placement_types()
    return tuple(Shard(lane_axis) if n in axes else Replicate()
                 for n in axis_names(mesh))


def coordinate(mesh) -> Tuple[int, ...]:
    """This rank's index along every mesh dim."""
    c = mesh.get_coordinate()
    if c is None:
        raise RuntimeError("this rank is not a member of the mesh")
    return tuple(int(v) for v in c)


def block_index(mesh, axes: Sequence[str]) -> int:
    """This rank's row-major block index over the mesh axes ``axes``."""
    sizes, coord = axis_sizes(mesh), coordinate(mesh)
    names = axis_names(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[names.index(a)]
    return idx


def local_piece(full: torch.Tensor, mesh, place) -> torch.Tensor:
    """The block of ``full`` this rank holds under placements ``place`` (a
    view; every split dim must divide)."""
    _, Shard = _placement_types()
    coord = coordinate(mesh)
    out = full
    for k, (p, n) in enumerate(zip(place, tuple(mesh.shape))):
        if isinstance(p, Shard):
            size = out.shape[p.dim]
            if size % n:
                raise ValueError(f"dim {p.dim} of size {size} does not "
                                 f"split {n} ways")
            out = out.narrow(p.dim, coord[k] * (size // n), size // n)
    return out


def global_shape(local_shape, mesh, place) -> Tuple[int, ...]:
    _, Shard = _placement_types()
    shape = list(local_shape)
    for p, n in zip(place, tuple(mesh.shape)):
        if isinstance(p, Shard):
            shape[p.dim] *= n
    return tuple(shape)


def from_local(local: torch.Tensor, mesh, place):
    """``local`` as this rank's block of a DTensor (no communication, no
    check that the other ranks agree; autograd flows through)."""
    from torch.distributed.tensor import DTensor
    shape = global_shape(local.shape, mesh, place)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def distribute(full: torch.Tensor, mesh, place):
    """A full tensor (the same on every rank) as a DTensor, by each rank
    keeping its own block: no communication (DTensor's own
    ``distribute_tensor`` broadcasts from rank 0)."""
    return from_local(local_piece(full, mesh, place).contiguous(), mesh,
                      place)


_GROUPS: dict = {}


def _mesh_key(mesh):
    return (tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh.shape),
            axis_names(mesh), mesh.device_type)


class Group(NamedTuple):
    """A process group over some mesh axes: ``order[b]`` is the group rank
    and ``ranks[b]`` the global rank that holds block b (the row-major
    index over those axes)."""
    group: object
    order: List[int]
    ranks: List[int]


def axes_group(mesh, axes: Sequence[str]) -> Group:
    """The process group spanning the mesh axes ``axes`` through this rank.
    The groups of every such slice of the mesh are made together on first
    use, by every rank (``new_group`` is collective), and cached; later
    calls make no collective."""
    axes = tuple(axes)
    key = (_mesh_key(mesh), axes)
    if key not in _GROUPS:
        names = axis_names(mesh)
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(len(names)) if d not in dims]
        n = math.prod(int(mesh.mesh.shape[d]) for d in dims)
        rows = mesh.mesh.permute(*rest, *dims).reshape(-1, n).tolist()
        me = dist.get_rank()
        mine = None
        for row in rows:
            g = dist.new_group(row)
            if me in row:
                members = sorted(row)
                mine = Group(g, [members.index(r) for r in row], row)
        _GROUPS[key] = mine
    return _GROUPS[key]


def forget_groups() -> None:
    """Drop the cached groups: call it after destroying the process group
    they belong to, before a new world makes a mesh of the same ranks."""
    _GROUPS.clear()


def gather_local(local: torch.Tensor, mesh, place) -> torch.Tensor:
    """The full tensor of which ``local`` is this rank's block under
    ``place``, on every rank (every rank of the mesh must call it): one
    all_gather over the split mesh dims' group when they all split the
    same tensor dim (a lane block), else one per split mesh dim,
    innermost first."""
    _, Shard = _placement_types()
    names = axis_names(mesh)
    split = [(k, p.dim) for k, p in enumerate(place) if isinstance(p, Shard)]
    if not split:
        return local
    if len({d for _, d in split}) == 1:
        steps = [([names[k] for k, _ in split], split[0][1])]
    else:
        steps = [([names[k]], d) for k, d in reversed(split)]
    for axes, dim in steps:
        g = axes_group(mesh, axes)
        parts = comm.all_gather(local, g.group)
        local = torch.cat([parts[i] for i in g.order], dim)
    return local


def gather(x):
    """The full tensor of a DTensor (every rank of its mesh must call it);
    a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return gather_local(x.to_local(), x.device_mesh, tuple(x.placements))
