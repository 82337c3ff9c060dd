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

With ``microbatches`` > 1 the step takes JAX's microbatches (microbatch
i is rows [i B / mb, (i + 1) B / mb) of the global batch) and each rank its
block of each, weighted n_r,i / N_i; a rank accumulates its float32
gradient over them and reduces once, so the count of collectives per step
does not grow with mb.  With gradient compression every leaf is reduced
whole (an all_reduce, in its own dtype): compression runs on the reduced
gradient, as JAX's program compresses the gradient of the global batch
(the int8 of a sum is not the sum of int8s); each rank compresses the
whole leaf and, under ZeRO-1, keeps its shard for AdamW.

On a mesh whose "model" axis is larger than 1 the step is also
tensor-parallel (``parallel.tensor``): the params and the optimizer state
are the rank's model blocks (ZeRO-1 splits a different dim over "data",
``P("data", "model")``), the forward and backward issue the regions'
collectives, and the leaves whose gradient is a partial sum over "model"
(``tensor.partial_leaves``) are summed in one fused all_reduce per step
before the data reduction.  The clip norm then takes one all_reduce over
("data", "model"), and int8's per-leaf scales one all_gather of the
stacked local maxima over "model".  ``check_mesh`` says which archs.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from ..optim import adamw_update
from ..optim.clip import global_norm
from ..parallel import comm
from ..parallel.layout import (axes_group, axis_names, axis_sizes,
                               coordinate, from_local, local_piece,
                               placements)
from ..parallel import tensor
from ..parallel.shardings import Owned, batch_specs, state_specs
from .losses import IGNORE


def check_mesh(mesh, arch=None) -> None:
    """A data-parallel step runs on a mesh with a "data" axis, whose other
    axes larger than 1 are at most "model"; a "model" axis larger than 1
    computes ``arch`` tensor-parallel: every arch of the zoo (GQA, MLA,
    Mamba, mLSTM and sLSTM mixers, dense SwiGLU and MoE FFNs, prefix
    layers, the patch frontend, the enc-dec model) whose split dims the
    axis divides (``parallel.tensor.check_arch``)."""
    sizes = _check_axes(mesh)
    if sizes.get("model", 1) > 1:
        if arch is None:
            raise ValueError("a step on a 'model' axis larger than 1 needs "
                             "the arch it computes")
        tensor.check_arch(arch, sizes["model"])


def _has_moe(arch) -> bool:
    return arch is not None and any(
        s.ffn == "moe" for s in tuple(arch.prefix) + tuple(arch.pattern))


def _check_axes(mesh):
    sizes = axis_sizes(mesh)
    if "data" not in sizes:
        raise ValueError(f"data-parallel training needs a 'data' mesh axis; "
                         f"got {tuple(sizes)}")
    other = [a for a, n in sizes.items() if a not in ("data", "model")
             and n > 1]
    if other:
        raise NotImplementedError(
            f"data-parallel training over mesh axes {other}: only 'data' "
            "and 'model' are ported")
    return sizes


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
    axis, tensor-parallel over its "model" axis when that is larger than 1
    (``arch`` is what the step computes); ``grad_constraint`` (a
    ``Zero1``) makes it ZeRO-1."""

    def __init__(self, mesh, grad_constraint: Optional["Zero1"] = None,
                 arch=None):
        check_mesh(mesh, arch)
        self.mesh = mesh
        self.patch = arch is not None and arch.frontend == "patch"
        self.zero1 = grad_constraint
        self.group = axes_group(mesh, ["data"])
        # the MoE aux loss's batch spans the data ranks' rows
        self.aux_group = self.group if _has_moe(arch) and \
            axis_sizes(mesh)["data"] > 1 else None
        names = axis_names(mesh)
        self.data_rank = coordinate(mesh)[names.index("data")]
        self.tp = None if arch is None else \
            tensor.TensorParallel.of(mesh, arch)
        # the clip norm's group: every rank holding a distinct piece
        self.norm_group = self.group if self.tp is None else \
            axes_group(mesh, ["data", "model"])
        self._roles: dict = {}

    # -- batch and loss ------------------------------------------------------
    def local_batch(self, batch):
        """This rank's rows of the global batch, and its weight n_r / N / c,
        c the number of data ranks that hold the same rows: 1 where the
        data axis splits the batch, all of them where it does not divide
        the rows and the batch stays whole on every rank (``batch_specs``),
        as JAX's program then computes the batch once."""
        specs = batch_specs(batch, self.mesh)
        local = {k: local_piece(local_tensor(v), self.mesh,
                                placements(self.mesh, specs[k]))
                 for k, v in batch.items()}
        labels = local_tensor(batch["labels"])
        n = (local["labels"] != IGNORE).sum()
        total = (labels != IGNORE).sum()
        copies = axis_sizes(self.mesh)["data"] * local["labels"].shape[0] \
            // labels.shape[0]
        return local, n.to(torch.float64) / total.clamp(min=1).to(
            torch.float64) / copies

    def tensor_parallel(self, batch):
        """The "model" context for a step on ``batch``: ``seq_carry`` when
        "model" divides its sequence (with the patch frontend, the P
        patches and the S tokens); None without a "model" axis."""
        if self.tp is None:
            return None
        seq = batch["tokens"].shape[1]
        if self.patch and "patch_embeds" in batch:
            seq += batch["patch_embeds"].shape[1]
        return self.tp.for_seq(seq)

    def loss(self, weighted: torch.Tensor) -> torch.Tensor:
        """The global loss: the sum of the ranks' weighted losses."""
        return comm.all_reduce(weighted.clone(), self.group.group)

    # -- gradients -------------------------------------------------------------
    def source_carry(self, batch) -> Optional[bool]:
        """The enc-dec model's encoder ``seq_carry`` for ``batch`` (its
        source frames' length); None for a decoder or without "model"."""
        if self.tp is None or "frames" not in batch:
            return None
        return tensor.divides(batch["frames"].shape[1], self.tp.size)

    def roles(self, params, tp, source_carry: Optional[bool] = None):
        """(model_split, partial) flags per leaf of the state's ``params``
        (``tree_leaves`` order) under the step's context ``tp`` (and the
        enc-dec encoder's ``source_carry``): split over "model" (as the
        state is laid out), and a partial sum over "model"."""
        if tp is None:
            n = len(pytree.tree_leaves(params))
            return [False] * n, [False] * n
        split = tensor.model_split(params, self.mesh)
        key = (tp.seq_carry, source_carry, tuple(split))
        if key not in self._roles:
            self._roles[key] = (split, tensor.partial_leaves(
                params, self.mesh, tp.seq_carry, source_carry))
        return self._roles[key]

    def check_layout(self, p_leaves) -> None:
        """Tensor parallelism computes on the rank's model blocks: the
        params must be laid out (``runtime.reshard_state`` with
        ``parallel.state_specs``)."""
        from torch.distributed.tensor import DTensor
        if self.tp is not None and not all(isinstance(l, DTensor)
                                           for l in p_leaves):
            raise ValueError(
                "a tensor-parallel step takes a state laid out on the mesh: "
                "runtime.reshard_state(state, mesh, parallel.state_specs("
                "state, mesh[, zero1=False]))")

    def sum_model(self, grads: List[torch.Tensor], partial: List[bool]):
        """The partial leaves summed over "model" (one fused all_reduce);
        as they are without a "model" axis."""
        if self.tp is None or not any(partial):
            return grads
        return tensor.sum_partial(grads, partial, self.tp)

    def reduce(self, grads):
        """One collective per leaf: each rank's gradient tree summed over
        the data axis, onto this rank's ZeRO-1 shard when there is one."""
        if self.zero1 is not None:
            return self.zero1(grads)
        return self.reduce_whole(grads)

    def reduce_whole(self, grads):
        """One all_reduce per leaf over the data axis: every rank holds
        each reduced leaf whole (the compression path)."""
        return pytree.tree_map(
            lambda g: comm.all_reduce(g.contiguous(), self.group.group),
            grads)

    def pieces(self, whole: List[torch.Tensor]):
        """This rank's piece of each whole reduced leaf: its ZeRO-1 shard
        (None where it holds none), or the leaf."""
        if self.zero1 is None:
            return list(whole)
        return [self.zero1.piece(i, g) for i, g in enumerate(whole)]

    def leaf_max(self, maxima: torch.Tensor) -> torch.Tensor:
        """Per-leaf maxima (stacked) over "model": int8's per-tensor scale
        of the whole leaf from the rank's block."""
        return tensor.reduce_max(maxima, self.tp)

    def norm(self, pieces, split) -> torch.Tensor:
        """The global gradient norm from this rank's pieces, each leaf's
        squares summed in leaf order as ``optim.clip.global_norm`` does.
        Without ZeRO-1 and "model" every rank holds every reduced leaf
        whole: no collective.  Otherwise each rank sums what it alone
        holds (a leaf every data rank holds whole counts on data rank 0,
        one "model" does not split (``split[i]`` False) on model rank 0):
        one all_reduce."""
        leaves = pytree.tree_leaves(pieces, is_leaf=_none)
        if self.zero1 is None and self.tp is None:
            return global_norm(leaves)
        kinds = self.zero1.kinds if self.zero1 is not None else \
            ["whole"] * len(leaves)
        acc = torch.promote_types(
            next(g for g in leaves if g is not None).dtype, torch.float32) \
            if any(g is not None for g in leaves) else torch.float32
        total = torch.zeros((), dtype=acc, device=self._dev)
        for g, kind, s in zip(leaves, kinds, split):
            if g is None or (kind == "whole" and self.data_rank != 0) or \
                    (not s and self.tp is not None and self.tp.rank != 0):
                continue
            lf = g.to(torch.promote_types(g.dtype, torch.float32))
            total = total + torch.sum(lf * lf)
        return torch.sqrt(comm.all_reduce(total, self.norm_group.group))

    @property
    def _dev(self):
        return torch.device(self.mesh.device_type)

    # -- the update ------------------------------------------------------------
    def update(self, p_leaves, local, opt, pieces, scale, lr, adamw_cfg):
        """AdamW on the leaves this rank holds (``pieces``: its reduced
        gradient of each param leaf, None where it holds none), scaled in
        place by the clip ``scale``; then each param made whole again over
        "data" (ZeRO-1's gathers).  ``p_leaves`` are the state's param
        leaves and ``local`` their tensors on this rank (whole, or the
        model block).  Returns (param leaves, opt tree), each leaf in the
        representation of the state's leaf it replaces."""
        z = self.zero1
        mine = [i for i, g in enumerate(pieces) if g is not None]
        slot = {i: j for j, i in enumerate(mine)}

        def clip(g):                # in place: the pieces are the step's own
            acc = torch.promote_types(g.dtype, torch.float32)
            if g.dtype == acc:
                return g.mul_(scale.to(acc))
            return g.copy_((g.to(acc) * scale.to(acc)).to(g.dtype))

        def flat(tree):
            return pytree.tree_flatten(tree, is_leaf=_laid_out)

        held = {k: [local_tensor(l) for l in flat(opt[k])[0]]
                for k in ("m", "v", "master") if k in opt}
        own = {k: [ls[i] for i in mine] for k, ls in held.items()}
        own["step"] = local_tensor(opt["step"])
        new_p, new_opt = adamw_update(
            [local[i] if z is None else z.piece(i, local[i]) for i in mine],
            [clip(pieces[i]) for i in mine], own, lr, adamw_cfg)
        params = []
        for i, like in enumerate(p_leaves):
            piece = new_p[slot[i]] if i in slot else None
            whole = piece if z is None else z.gather(i, piece, local[i])
            params.append(relay(whole, like))
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


class Zero1:
    """``grad_constraint`` of a ZeRO-1 data-parallel step: the optimizer
    state lives split over "data" per ``parallel.state_specs`` (the state
    given here, or one laid out by ``runtime.reshard_state`` with the same
    specs), and ``__call__`` reduces each gradient leaf onto this rank's
    shard of it (one collective per leaf).

    Per param leaf, ``kinds[i]`` is "split" (dim ``dims[i]`` over "data"),
    "owned" (a unit's leaf held whole by data rank ``owners[i]``) or
    "whole" (nothing splits it: every rank keeps the all-reduced
    gradient and updates it alike).  On a "model" axis each rank's leaves
    are its model blocks, which "data" splits on another dim."""

    def __init__(self, mesh, state):
        _check_axes(mesh)
        self.mesh = mesh
        self.group = axes_group(mesh, ["data"])
        self.data_rank = coordinate(mesh)[axis_names(mesh).index("data")]
        self.kinds, self.dims, self.owners = zero1_layout(state, mesh)

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


def zero1_layout(state, mesh):
    """ZeRO-1's layout of each param leaf: (kinds, data dims, owners), as
    ``Zero1`` documents; from the layout of each of ``state``'s AdamW m
    leaves where it is laid out (so a state laid out by ``state_specs(...,
    ep=True)`` reads as such), else from ``parallel.state_specs``.  A state
    not laid out needs the mesh's axis sizes and names only (a duck-typed
    mesh will do)."""
    from torch.distributed.tensor import DTensor, Shard

    from ..runtime.elastic import OwnedShard
    specs = pytree.tree_leaves(state_specs(state, mesh)["opt"]["m"],
                               is_leaf=lambda x: isinstance(x, Owned))
    held = pytree.tree_leaves(state["opt"]["m"], is_leaf=_laid_out)
    data = axis_names(mesh).index("data")
    kinds: List[str] = []
    dims: List[Optional[int]] = []
    owners: List[Optional[int]] = []
    for spec, leaf in zip(specs, held):
        if isinstance(leaf, OwnedShard):
            spec = leaf.sharding.spec
        if isinstance(spec, Owned):
            kinds.append("owned")
            dims.append(None)
            owners.append(spec.index)
            continue
        p = leaf.placements[leaf.device_mesh.mesh_dim_names.index("data")] \
            if isinstance(leaf, DTensor) else placements(mesh, spec)[data]
        split = isinstance(p, Shard)
        kinds.append("split" if split else "whole")
        dims.append(p.dim if split else None)
        owners.append(None)
    return kinds, dims, owners


C = collections.Counter


def _enter(seq: bool):
    """(forward, backward) collectives of ``TensorParallel.enter``."""
    return (C(all_gather=1) if seq else C(),
            C(reduce_scatter=1) if seq else C(all_reduce=1))


def _leave(seq: bool):
    """(forward, backward) collectives of ``TensorParallel.leave``."""
    return (C(reduce_scatter=1) if seq else C(all_reduce=1),
            C(all_gather=1) if seq else C())


#: a split weight made whole (``TensorParallel.whole``), the sLSTM's heads
#: gathered: (forward, backward)
_GATHER = (C(all_gather=1), C(reduce_scatter=1))
#: a partial sum used on the rank's channels (``TensorParallel.summed``)
_SUMMED = (C(all_reduce=1), C(all_reduce=1))


def _layer_regions(spec, arch, m: int, seq: bool, whole_mamba: bool):
    """The collectives of one layer on a "model" axis of ``m``, in forward
    order: a list of (forward, backward) Counters, and whether its last
    one is a leave after which nothing is saved for the backward (the
    leave of an entered FFN, or of a mixer without an FFN), which an
    early-stopped recompute does not run."""
    out = []
    if spec.mixer in ("attn", "mla"):
        out += [_enter(seq), _leave(seq)]
    elif spec.mixer == "mamba":
        mcfg = arch.mamba_config()
        if whole_mamba:             # whole on every rank: its rows kept
            out += [_enter(True)] if seq else []
        else:
            out += [_enter(seq), _GATHER]           # in_proj
            out += [_GATHER] * (tensor.divides(
                mcfg.rank + 2 * mcfg.d_state, m)
                + tensor.divides(mcfg.rank, m))     # x_proj, dt_proj
            out += [_SUMMED, _leave(seq)]           # the x_proj product
    elif spec.mixer == "mlstm":     # up; the skip norm's two statistics
        out += [_enter(seq), _GATHER, _SUMMED, _SUMMED, _leave(seq)]
    else:                           # slstm: the heads gathered for the norm
        out += [_enter(seq), _GATHER, _leave(seq)]
    entered = spec.ffn == "moe" or (spec.ffn == "dense"
                                    and tensor.divides(arch.d_ff, m))
    if entered:
        out += [_enter(seq), _leave(seq)]
    return out, entered or (spec.ffn == "none" and bool(out)
                            and out[-1] == _leave(seq))


def _passes(regions, trailing: bool, forward: int, recompute: int,
            backward: int, times: int = 1) -> collections.Counter:
    """The collectives of ``forward`` whole forward passes of a layer, of
    ``recompute`` early-stopped ones (the trailing leave not run) and of
    ``backward`` backward passes, ``times`` over."""
    c = C()
    for i, (f, b) in enumerate(regions):
        last = i == len(regions) - 1
        n = forward + recompute * (not (last and trailing))
        for k, v in f.items():
            c[k] += v * n * times
        for k, v in b.items():
            c[k] += v * backward * times
    return c


def step_collectives(arch, mesh, n_leaves: int, *, seq_len: int,
                     kinds: Optional[Sequence[str]] = None,
                     loss_chunk: int = 512, microbatches: int = 1,
                     compression: str = "none",
                     patches: int = 0, source_len: int = 0,
                     whole_mamba: bool = False) -> Dict[str, int]:
    """The collectives of one data-parallel step, by kind (what
    ``parallel.comm.counts()`` reads after it), for ``arch`` on ``mesh``
    (axis sizes read only), ``n_leaves`` param leaves, sequences of
    ``seq_len`` tokens after ``patches`` patch positions (the patch
    frontend's P; 0 without), the enc-dec model's source of
    ``source_len`` frames, ZeRO-1's leaf ``kinds`` (``zero1_layout``; None
    without ZeRO-1), and Mamba laid out whole (``whole_mamba``:
    ``state_specs(..., extra_replicated=MAMBA_PARAM_NAMES)``).

    "model" > 1: each layer pass makes its regions' collectives
    (``_layer_regions``): an attention (GQA, MLA, the enc-dec model's self-
    and cross-attention), an MoE (expert parallelism as TP-in-expert) or a
    split SwiGLU, a Mamba by channel, an mLSTM or an sLSTM by head are
    entered (``TensorParallel.enter``) and left (``leave``); Mamba also
    makes in_proj, and x_proj and dt_proj
    where "model" splits them, whole (an all_gather forward, a
    reduce_scatter backward) and sums its x_proj product (an all_reduce
    each way); the mLSTM makes up whole and sums its skip norm's two row
    statistics; the sLSTM gathers its heads' outputs; a Mamba laid out
    whole is only entered, under seq_carry.  Under seq_carry (the
    sequence, P + S, divides by "model") an enter is an all_gather forward
    and a reduce_scatter backward, a leave the reverse; without it an
    enter is nothing forward and an all_reduce backward, a leave an
    all_reduce forward and nothing backward.  Discrete with remat: the
    prefix layers a forward and a backward; a unit of one layer a forward,
    its recompute in the backward, which stops after the last tensor the
    backward needs (a leave after which nothing is saved, that of an
    entered FFN or of a mixer without an FFN, is not run again: a whole
    SwiGLU needs the attention's leave, which is then recomputed), and a
    backward; a unit of several layers (each also checkpointed) a forward
    of every layer, the unit's recompute, which runs every layer but the
    last (whose checkpoint holds its input, the last tensor the unit's
    backward needs), each layer's own early-stopped recompute, and a
    backward.  Node mode (no prefix layers): a forward per solver step,
    and in the symplectic adjoint's backward a forward, the layers'
    early-stopped recomputes (several layers a unit) and a backward per
    step.  The vocab-parallel lookup is one more leave, the head's input
    one more enter, and each loss chunk one all_gather.  With patches the
    embedding is made whole instead: the frontend's columns joined (an
    all_gather forward; a reduce_scatter backward under seq_carry), the
    vocab blocks' lookups summed (an all_reduce forward; another backward
    under seq_carry).  A d_ff or vocab that "model" does not divide leaves
    its layer whole: no enter or leave; a whole head's loss over the
    rank's rows is summed once (all_reduce) under seq_carry.  The enc-dec
    model: its encoder's seq_carry is decided on ``source_len``; its
    frontend's columns joined (an all_gather; a reduce_scatter backward
    under the encoder's seq_carry), each encoder and decoder layer a
    forward, its early-stopped recompute and a backward, the memory
    entered once (by the encoder's seq_carry), and the decoder's lookup
    and head as a decoder's.  All of that once per microbatch.

    An MoE layer on a "data" axis larger than 1, discrete: one all_reduce
    of the aux loss's sums per forward (a recompute's too) and one per
    backward (node mode drops the aux loss), once per microbatch.

    Then once per step: one collective per gradient leaf over "data"
    (ZeRO-1's reduce_scatter / reduce / all_reduce by leaf kind; all_reduce
    without ZeRO-1 or with compression), the fused all_reduce of the
    partial leaves over "model" (when there are any: under either
    seq_carry, with q/k norms, MLA, MoE or a recurrent mixer laid out by
    channel or head), the loss's all_reduce, the clip norm's all_reduce
    (ZeRO-1 or "model"), int8's all_gather of the leaf maxima over
    "model", and ZeRO-1's gathers of the new params (all_gather per split
    leaf, broadcast per owned one)."""
    c: collections.Counter = collections.Counter()
    m = axis_sizes(mesh).get("model", 1)
    specs = tuple(arch.prefix) + tuple(arch.pattern)
    if m > 1:
        vocab = tensor.divides(arch.vocab, m)
        length = seq_len + patches
        seq = tensor.divides(length, m)
        per = C()

        def regions(spec, s=seq):
            return _layer_regions(spec, arch, m, s, whole_mamba)

        src = arch.encdec and tensor.divides(source_len, m)
        if arch.encdec:             # its one layer spec: attention, SwiGLU
            enc, enc_t = regions(arch.pattern[0], src)
            dec, dec_t = regions(arch.pattern[0])
            dec = dec[:2] + dec             # self- and cross-attention
            per.update(_passes(enc, enc_t, 1, 1, 1, arch.enc_layers))
            per.update(_passes(dec, dec_t, 1, 1, 1, arch.n_layers))
            per.update(C(all_gather=1, reduce_scatter=src))  # frontend
            f, b = _enter(src)                               # memory
            per.update(f + b)
        elif arch.node.mode != "node":
            for spec in arch.prefix:
                per.update(_passes(*regions(spec), 1, 0, 1))
            several = arch.remat and len(arch.pattern) > 1
            for i, spec in enumerate(arch.pattern):
                outer = several and i < len(arch.pattern) - 1
                per.update(_passes(*regions(spec), 1 + outer,
                                   int(arch.remat), 1, arch.n_repeats))
        else:
            steps = arch.node.n_steps or arch.n_repeats
            inner = int(arch.remat and len(arch.pattern) > 1)
            for spec in arch.pattern:
                per.update(_passes(*regions(spec), 2, inner, 1, steps))
        if vocab:                               # the head's enter
            per.update(sum(_enter(seq), C()))
        if not patches:
            if vocab:                           # the lookup's leave
                per.update(sum(_leave(seq), C()))
        else:
            per["all_gather"] += 1              # the frontend's columns
            per["reduce_scatter"] += seq
            per["all_reduce"] += vocab * (1 + seq)   # the summed lookup
        if vocab:
            per["all_gather"] += -(-length // min(loss_chunk, length))
        elif seq:
            per["all_reduce"] += 1              # the rows' loss, summed
        for k, v in per.items():
            c[k] += v * microbatches
        mixers = {s.mixer for s in specs}
        if seq or src or any(
                (s.mixer == "attn" and arch.qk_norm) or s.mixer == "mla"
                or s.ffn == "moe" for s in specs) or \
                mixers & {"mlstm", "slstm"} or \
                ("mamba" in mixers and not whole_mamba):
            c["all_reduce"] += 1                # the partial leaves
    moe = [s.ffn == "moe" for s in arch.pattern]
    if axis_sizes(mesh)["data"] > 1 and any(moe + [s.ffn == "moe" for s in
                                                   arch.prefix]) \
            and arch.node.mode != "node":
        # the MoE aux loss's sums over "data": one all_reduce per MoE layer
        # forward (a recompute's too) and one per backward
        pre = sum(s.ffn == "moe" for s in arch.prefix)
        several = arch.remat and len(arch.pattern) > 1
        passes = sum((2 + arch.remat + (several and i < len(moe) - 1))
                     * is_moe for i, is_moe in enumerate(moe))
        c["all_reduce"] += (2 * pre + passes * arch.n_repeats) \
            * microbatches
    c["all_reduce"] += 1                        # the loss
    if kinds is not None or m > 1:
        c["all_reduce"] += 1                    # the clip norm
    if compression == "int8" and m > 1:
        c["all_gather"] += 1                    # the leaf maxima
    if kinds is None or compression != "none":
        c["all_reduce"] += n_leaves
    else:
        for kind in kinds:
            c[{"split": "reduce_scatter", "owned": "reduce",
               "whole": "all_reduce"}[kind]] += 1
    for kind in kinds or ():
        if kind != "whole":
            c[{"split": "all_gather", "owned": "broadcast"}[kind]] += 1
    return {k: v for k, v in c.items() if v}


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
