"""Data-parallel training over a mesh's "data" axis, SPMD, with optional
ZeRO-1 (the JAX package's ``shard=`` / ``grad_constraint=`` of
``make_train_step``, made explicit: a torch program issues its own
collectives).

Every rank holds the same global batch (one ``TokenPipeline`` cursor) and
takes its block of rows (``parallel.batch_specs``).  Its loss and gradient
are those of its block's mean, weighted by its share n_r / N of the global
batch's valid tokens (N is counted from the global batch every rank holds:
no collective), so that the summed gradient and loss are the global batch's
mean, as one process computes it; with one rank the weight is exactly 1.
Then, per step:

* one collective per gradient leaf: an all_reduce (plain data parallel),
  or with ZeRO-1 (``Zero1``, the ``grad_constraint``) a reduce-scatter onto
  the leaf's ``parallel.state_specs`` shard (a ``reduce`` onto the owning
  rank for a unit's ``Owned`` leaf; an all_reduce for a leaf nothing
  splits);
* one all_reduce of the loss, and with ZeRO-1 one of the squared gradient
  norm (the global clip norm; without it every rank holds the whole
  reduced gradient and the norm is local);
* with ZeRO-1, AdamW updates only this rank's shard of m, v (and the
  float32 master) and the new params are gathered: one all_gather per
  split leaf, one broadcast per owned leaf.

Tensor parallelism (a "model" axis larger than 1) is not here: see
``check_mesh``.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch.utils import _pytree as pytree

from ..optim import adamw_update
from ..optim.clip import global_norm
from ..parallel import comm
from ..parallel.layout import (axes_group, axis_names, axis_sizes,
                               coordinate, from_local, local_piece,
                               placements)
from ..parallel.shardings import Owned, batch_specs, state_specs
from .losses import IGNORE


def check_mesh(mesh) -> None:
    """A data-parallel step runs on a mesh whose only axis larger than 1 is
    "data"."""
    sizes = axis_sizes(mesh)
    if "data" not in sizes:
        raise ValueError(f"data-parallel training needs a 'data' mesh axis; "
                         f"got {tuple(sizes)}")
    if sizes.get("model", 1) > 1:
        raise NotImplementedError(
            f"a training step on a mesh with 'model' = {sizes['model']}: "
            "tensor-parallel compute of the LM (Megatron column/row layers "
            "on DTensor, the kernels under local_map) is not ported yet "
            "(ROADMAP queue 1, item 17); its state and checkpoints lay out "
            "on such a mesh already (parallel.state_specs, runtime.elastic)")
    other = [a for a, n in sizes.items() if a not in ("data", "model")
             and n > 1]
    if other:
        raise NotImplementedError(
            f"data-parallel training over mesh axes {other}: only 'data' "
            "is ported")


def local_tensor(leaf):
    """A rank's own tensor of a laid-out leaf (DTensor -> its block,
    OwnedShard -> its piece or None)."""
    from torch.distributed.tensor import DTensor

    from ..runtime.elastic import OwnedShard
    if isinstance(leaf, DTensor):
        return leaf.to_local()
    if isinstance(leaf, OwnedShard):
        return leaf.local
    return leaf


class DataParallel:
    """The collectives of a data-parallel step over ``mesh``'s "data"
    axis; ``grad_constraint`` (a ``Zero1``) makes it ZeRO-1."""

    def __init__(self, mesh, grad_constraint: Optional["Zero1"] = None):
        check_mesh(mesh)
        self.mesh = mesh
        self.zero1 = grad_constraint
        self.group = axes_group(mesh, ["data"])
        self.data_rank = coordinate(mesh)[axis_names(mesh).index("data")]

    # -- batch and loss ------------------------------------------------------
    def local_batch(self, batch):
        """This rank's rows of the global batch, and its weight n_r / N."""
        specs = batch_specs(batch, self.mesh)
        local = {k: local_piece(local_tensor(v), self.mesh,
                                placements(self.mesh, specs[k]))
                 for k, v in batch.items()}
        n = (local["labels"] != IGNORE).sum()
        total = (local_tensor(batch["labels"]) != IGNORE).sum()
        return local, n.to(torch.float64) / total.clamp(min=1).to(
            torch.float64)

    def loss(self, weighted: torch.Tensor) -> torch.Tensor:
        """The global loss: the sum of the ranks' weighted losses."""
        return comm.all_reduce(weighted.clone(), self.group.group)

    # -- gradients -------------------------------------------------------------
    def reduce(self, grads):
        """One collective per leaf: each rank's gradient tree summed over
        the data axis, onto this rank's ZeRO-1 shard when there is one."""
        if self.zero1 is not None:
            return self.zero1(grads)
        return pytree.tree_map(
            lambda g: comm.all_reduce(g.contiguous(), self.group.group),
            grads)

    def norm(self, pieces) -> torch.Tensor:
        """The global gradient norm from this rank's pieces, each leaf's
        squares summed in leaf order as ``optim.clip.global_norm`` does.
        Without ZeRO-1 every rank holds every reduced leaf whole: no
        collective.  With it each rank sums what it alone holds (a leaf
        every rank holds whole counts on data rank 0): one all_reduce."""
        leaves = pytree.tree_leaves(pieces, is_leaf=_none)
        if self.zero1 is None:
            return global_norm(leaves)
        acc = torch.promote_types(
            next(g for g in leaves if g is not None).dtype, torch.float32) \
            if any(g is not None for g in leaves) else torch.float32
        total = torch.zeros((), dtype=acc, device=self._dev)
        for g, kind in zip(leaves, self.zero1.kinds):
            if g is None or (kind == "whole" and self.data_rank != 0):
                continue
            lf = g.to(torch.promote_types(g.dtype, torch.float32))
            total = total + torch.sum(lf * lf)
        return torch.sqrt(comm.all_reduce(total, self.group.group))

    @property
    def _dev(self):
        return torch.device(self.mesh.device_type)

    # -- the update ------------------------------------------------------------
    def update(self, p_leaves, full, opt, pieces, scale, lr, adamw_cfg):
        """AdamW on the leaves this rank holds (``pieces``: its reduced
        gradient of each param leaf, None where it holds none), scaled by
        the clip ``scale``; then each param made whole again (ZeRO-1's
        gathers).  ``p_leaves`` are the state's param leaves and ``full``
        their whole tensors.  Returns (param leaves, opt tree), each leaf
        in the representation of the state's leaf it replaces."""
        z = self.zero1
        mine = [i for i, g in enumerate(pieces) if g is not None]
        slot = {i: j for j, i in enumerate(mine)}

        def clip(g):
            acc = torch.promote_types(g.dtype, torch.float32)
            return (g.to(acc) * scale.to(acc)).to(g.dtype)

        def flat(tree):
            return pytree.tree_flatten(tree, is_leaf=_laid_out)

        held = {k: [local_tensor(l) for l in flat(opt[k])[0]]
                for k in ("m", "v", "master") if k in opt}
        own = {k: [ls[i] for i in mine] for k, ls in held.items()}
        own["step"] = local_tensor(opt["step"])
        new_p, new_opt = adamw_update(
            [full[i] if z is None else z.piece(i, full[i]) for i in mine],
            [clip(pieces[i]) for i in mine], own, lr, adamw_cfg)
        params = []
        for i, like in enumerate(p_leaves):
            piece = new_p[slot[i]] if i in slot else None
            whole = piece if z is None else z.gather(i, piece, full[i])
            params.append(relay(_block(whole, like), like))
        out = {}
        for k in opt:               # the state's key order
            if k == "step":
                out[k] = relay(new_opt[k], opt[k])
                continue
            leaves, tree = flat(opt[k])
            out[k] = pytree.tree_unflatten(
                [relay(new_opt[k][slot[i]] if i in slot else None, like)
                 for i, like in enumerate(leaves)], tree)
        return params, out


def _none(x):
    return x is None


def _laid_out(x) -> bool:
    from ..runtime.elastic import OwnedShard
    return x is None or isinstance(x, OwnedShard)


def _block(whole, like):
    """This rank's block of a whole param laid out as the state's leaf
    ``like`` (a DTensor's block; a plain leaf is whole)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor):
        return whole
    return local_piece(whole, like.device_mesh, tuple(like.placements))


class Zero1:
    """``grad_constraint`` of a ZeRO-1 data-parallel step: the optimizer
    state lives split over "data" per ``parallel.state_specs`` (the state
    given here, or one laid out by ``runtime.reshard_state`` with the same
    specs), and ``__call__`` reduces each gradient leaf onto this rank's
    shard of it (one collective per leaf).

    Per param leaf, ``kinds[i]`` is "split" (dim ``dims[i]`` over "data"),
    "owned" (a unit's leaf held whole by data rank ``owners[i]``) or
    "whole" (nothing splits it: every rank keeps the all-reduced
    gradient and updates it alike)."""

    def __init__(self, mesh, state):
        check_mesh(mesh)
        self.mesh = mesh
        specs = state_specs(state, mesh)["opt"]["m"]
        self.specs = pytree.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, Owned))
        names = axis_names(mesh)
        self.group = axes_group(mesh, ["data"])
        self.data_rank = coordinate(mesh)[names.index("data")]
        self.kinds: List[str] = []
        self.dims: List[Optional[int]] = []
        self.owners: List[Optional[int]] = []
        from torch.distributed.tensor import Shard
        for spec in self.specs:
            if isinstance(spec, Owned):
                self.kinds.append("owned")
                self.dims.append(None)
                self.owners.append(spec.index)
                continue
            p = placements(mesh, spec)[names.index("data")]
            split = isinstance(p, Shard)
            self.kinds.append("split" if split else "whole")
            self.dims.append(p.dim if split else None)
            self.owners.append(None)

    def __call__(self, grads):
        leaves, tree = pytree.tree_flatten(grads)
        group, n = self.group.group, len(self.group.ranks)
        out = []
        for g, kind, d, owner in zip(leaves, self.kinds, self.dims,
                                     self.owners):
            if kind == "split":
                chunks = list(torch.chunk(g, n, dim=d))
                out.append(comm.reduce_scatter(
                    [chunks[b] for b in _by_group_rank(self.group)], group))
            elif kind == "owned":
                r = comm.reduce(g.contiguous(), self.group.ranks[owner],
                                group)
                out.append(r if owner == self.data_rank else None)
            else:
                out.append(comm.all_reduce(g.contiguous(), group))
        return pytree.tree_unflatten(out, tree)

    def piece(self, i: int, full: torch.Tensor):
        """This rank's shard of param leaf i's full tensor (None when it
        owns none of it)."""
        kind = self.kinds[i]
        if kind == "split":
            return full.chunk(len(self.group.ranks), dim=self.dims[i])[
                self.data_rank]
        if kind == "owned" and self.owners[i] != self.data_rank:
            return None
        return full

    def gather(self, i: int, piece: Optional[torch.Tensor], like):
        """Param leaf i whole on every rank from the ranks' updated
        pieces: one all_gather (split), one broadcast (owned), none
        (whole)."""
        kind, group = self.kinds[i], self.group.group
        if kind == "split":
            parts = comm.all_gather(piece, group)
            return torch.cat([parts[g] for g in self.group.order],
                             self.dims[i])
        if kind == "owned":
            buf = piece.contiguous() if piece is not None else \
                torch.empty_like(like)
            return comm.broadcast(buf, self.group.ranks[self.owners[i]],
                                  group)
        return piece


def relay(new: Optional[torch.Tensor], like):
    """``new`` (this rank's tensor) in the representation of the state leaf
    ``like`` it replaces: a DTensor block with like's placements, an
    ``OwnedShard``, or a plain tensor."""
    from torch.distributed.tensor import DTensor

    from ..runtime.elastic import OwnedShard
    if isinstance(like, OwnedShard):
        return OwnedShard(new, like.sharding, like.shape, like.dtype)
    if isinstance(like, DTensor):
        return from_local(new, like.device_mesh, tuple(like.placements))
    return new


def _by_group_rank(g) -> List[int]:
    """Block indices in group-rank order (the chunk member i receives)."""
    out = [0] * len(g.order)
    for block, grank in enumerate(g.order):
        out[grank] = block
    return out
