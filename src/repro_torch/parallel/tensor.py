"""Tensor parallelism over a mesh's "model" axis, eager and SPMD: the
counterpart of the JAX package's logical rules (``mesh_rules.LOGICAL_RULES``:
heads, kv_heads, ffn and vocab on "model", and ``seq_carry`` on "model") and
of its Megatron column / row leaf rules (``shardings.COL_NAMES`` /
``ROW_NAMES``), which XLA turns into collectives there.

The model code computes on each rank's local blocks (``DTensor.to_local()``
of a state laid out by ``parallel.state_specs``): a column-split weight
(wq, wk, wv, wg, wu) holds the rank's heads or ffn columns, a row-split one
(wo, wd) the matching rows, ``embed`` and ``lm_head`` the rank's vocab
block.  Where the activation's layout changes the code calls a region of
``parallel.comm``:

* ``enter`` at a column-parallel layer's input: the activation whole on
  every rank, gathered from the sequence blocks under ``seq_carry``
  (all_gather; backward reduce_scatter) or marked as replicated
  (``copy_to``; backward all_reduce);
* ``leave`` at a row-parallel layer's output: the partial products summed
  over "model", onto the sequence blocks under ``seq_carry``
  (reduce_scatter; backward all_gather) or whole (``reduce_from``:
  all_reduce).

Under ``seq_carry`` (the sequence divides by the "model" size: JAX never
constrains a dim that does not divide) the residual stream between the
regions is sequence-sharded: the norms, the residual adds and a node-mode
solve's state hold the rank's rows only.  A dim that "model" does not
divide leaves its leaf whole (``shardings`` ``pad``): that layer then runs
on the rank's rows (``seq_carry``) or on the replicated activation, with
no collective.

A leaf that "model" does not split but that computes on
"model"-partitioned data has a partial gradient on each rank
(``partial_leaves``): the q/k norms on the local heads; MLA's latent
(``wdkv``, ``kv_norm``) and rotated key (``wkr``), which only the rank's
heads read; the MoE router, whose gates weight the rank's partial expert
outputs; and under ``seq_carry`` every such leaf (the norms, a whole ffn or
vocab).  The data-parallel step sums those over "model" (one fused
all_reduce per step).  A term of the loss that every rank computes alike
from whole inputs (the MoE aux loss) enters through ``once``: its gradient
is 1/TP on each rank, so those sums count it once.

An MoE FFN runs on the entered, whole sequence (routing and capacity count
every token of a row) with the rank's f columns of every expert (TP-in-
expert) or, from a state laid out by ``state_specs(..., ep=True)``, its
E/TP experts whole (expert parallelism); either way its output is a
partial sum that the layer's ``leave`` sums.  With the patch frontend the
sequence is the P patches and the S tokens, ``seq_carry`` is decided on
P + S, and the embedding is made whole before the rank takes its rows
(``models.lm._embed_patches_tp``).

The recurrent mixers run on the entered, whole sequence too (a scan needs
every position): Mamba on the rank's d_inner / TP channels, the mLSTM and
the sLSTM on its heads (``nn.mamba``, ``nn.xlstm``).  Where a leaf's
"model" layout is not the rank's channel or head block (Mamba's in_proj
over [x | z], x_proj over [dt | B | C], dt_proj's rows; the mLSTM's up
over [x | z]) the layer makes it whole (``whole``: an all_gather, its
backward a reduce_scatter of the ranks' partial gradients) and takes its
part; a product or a statistic summed over every channel is ``summed``
(an all_reduce each way), and the unsplit leaves the rank takes its
channels or heads of are partial (``PARTIAL_IN``).  A Mamba laid out whole
(``state_specs(..., extra_replicated=MAMBA_PARAM_NAMES)``) runs whole on
every rank.  The enc-dec model decides ``seq_carry`` for its encoder on
the source's length and for its decoder on the target's, enters the
memory whole once for every decoder layer's cross-attention, and its
encoder's unsplit leaves are partial by the encoder's ``seq_carry``
(``partial_leaves``' ``source_carry``).

The data-parallel step makes a rank's context (``TensorParallel``) and
passes it down as the ``tp`` argument of ``train_step.loss_and_grads``,
``models.lm.lm_forward``, ``models.blocks.layer_forward`` and
``train.losses.lm_loss_chunked`` (None on one device); a checkpoint's
recompute and a node-mode field hold it in their closures.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch.utils import _pytree as pytree

from . import comm
from .layout import Group, axes_group, axis_names, axis_sizes, coordinate

def check_arch(arch, size: int) -> None:
    """Raise unless a "model" axis of ``size`` can compute ``arch``: every
    dim a layer splits must divide by ``size`` (``divides``): the heads and
    kv heads of its attention (GQA, MLA, the enc-dec model's), with MoE its
    experts' f (and the shared experts' f), Mamba's d_inner (its channels),
    the xLSTM heads (the mLSTM's and the sLSTM's, and the sLSTM's up-
    projection), and d_model where a frontend (the patch or the enc-dec
    model's) is split by its columns.  A leaf whose dim "model" does not
    divide is laid out whole (``shardings`` ``pad``); where the layer
    computes on it as a whole (a SwiGLU of an undivided d_ff, an undivided
    vocab) it trains, elsewhere it raises here."""
    if size <= 1:
        return
    specs = tuple(arch.prefix) + tuple(arch.pattern)
    mixers = {s.mixer for s in specs}
    dims = {}
    if arch.frontend not in ("none", "patch") and not (
            arch.encdec and arch.frontend == "audio"):
        raise NotImplementedError(
            f"tensor-parallel training of {arch.name} on 'model' = {size}: "
            f"the {arch.frontend} frontend is not ported")
    if arch.encdec or mixers & {"attn", "mla"}:
        if arch.n_kv_heads % size or arch.n_heads % size:
            raise NotImplementedError(
                f"tensor-parallel training of {arch.name}: 'model' = {size} "
                f"does not divide its {arch.n_heads} heads / "
                f"{arch.n_kv_heads} kv heads (replicated attention is not "
                f"ported)")
    if any(s.ffn == "moe" for s in specs):
        moe = arch.moe_config()
        dims["expert f"] = moe.d_ff
        if moe.n_shared:
            dims["shared expert f"] = moe.shared_d_ff or \
                moe.d_ff * moe.n_shared
    if arch.frontend == "patch" or arch.encdec:
        dims["d_model (the frontend's columns)"] = arch.d_model
    if "mamba" in mixers:
        dims["Mamba d_inner"] = arch.mamba_config().d_inner
    if mixers & {"mlstm", "slstm"}:
        dims["xLSTM heads"] = arch.xlstm_config().n_heads
    if "slstm" in mixers:
        from repro_torch.nn.xlstm import _slstm_up
        dims["sLSTM up-projection"] = _slstm_up(
            arch.d_model, arch.xlstm_config().s_proj_factor)
    whole = [f"{name} {n}" for name, n in dims.items()
             if not divides(n, size)]
    if whole:
        raise NotImplementedError(
            f"tensor-parallel training of {arch.name}: 'model' = {size} "
            f"does not divide its {', '.join(whole)}")


def divides(n: int, size: int) -> bool:
    """The ``shardings`` rule: "model" splits a dim it divides and that is
    at least its size."""
    return n % size == 0 and n >= size


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A rank's view of the "model" axis: its group (``layout.Group``),
    size and coordinate; whether the vocab and the ffn dims are split; and
    whether ``seq_carry`` shards the residual stream of the step at hand
    (``for_seq``)."""
    group: Group
    size: int
    rank: int
    vocab_split: bool
    ffn_split: bool
    seq_carry: bool = False

    @classmethod
    def of(cls, mesh, arch) -> Optional["TensorParallel"]:
        """The context of ``mesh``'s "model" axis for ``arch`` (None when
        the axis is absent or of size 1).  Collective on first use (the
        group is made by every rank)."""
        size = axis_sizes(mesh).get("model", 1)
        if size <= 1:
            return None
        check_arch(arch, size)
        rank = coordinate(mesh)[axis_names(mesh).index("model")]
        return cls(axes_group(mesh, ["model"]), size, rank,
                   divides(arch.vocab, size), divides(arch.d_ff, size))

    def for_seq(self, seq_len: int) -> "TensorParallel":
        return dataclasses.replace(self,
                                   seq_carry=divides(seq_len, self.size))

    # -- regions ---------------------------------------------------------
    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """A column-parallel layer's input (B, S[/TP], d) whole."""
        if self.seq_carry:
            return comm.gather_from_sequence(h, self.group, 1)
        return comm.copy_to(h, self.group)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer's partial output summed over "model", on
        this rank's sequence block under ``seq_carry``."""
        if self.seq_carry:
            return comm.scatter_to_sequence(y, self.group, 1)
        return comm.reduce_from(y, self.group)

    def rows(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's sequence block of a whole tensor under
        ``seq_carry`` (a view), else ``x``."""
        if not self.seq_carry:
            return x
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def vocab_block(self, local_vocab: int):
        """The vocab ids [lo, hi) this rank's embed / head block holds."""
        lo = self.rank * local_vocab
        return lo, lo + local_vocab

    def once(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, a term every rank computes alike from whole inputs, with
        1/TP of its gradient on each rank: the sums over "model" downstream
        of it (``enter``'s backward, ``sum_partial``) then count it once."""
        return _ShareGrad.apply(t, self.size)

    def join_columns(self, w: torch.Tensor) -> torch.Tensor:
        """The rank's column block of a column-split weight made whole
        along its last dim (all_gather).  Backward: under ``seq_carry``,
        where what it computes is then cut to the rank's rows, the ranks'
        gradients are partial and are summed onto the rank's block
        (reduce_scatter); without it they are whole and alike, and the rank
        takes its block (no collective)."""
        return comm.gather_columns(w, self.group, self.seq_carry)

    def whole(self, w: torch.Tensor, dim: int, size: int) -> torch.Tensor:
        """A weight ``size`` long along ``dim`` made whole: the ranks'
        blocks of a split one joined (all_gather), a whole one as it is.
        Backward of the join: the ranks' gradients, each partial (the rank
        computes on its own channels or heads of the whole weight), summed
        onto the rank's block (reduce_scatter)."""
        if w.shape[dim] == size:
            return w
        return comm.gather_from_sequence(w, self.group, dim % w.dim())

    def summed(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, this rank's part of a sum over "model" that every rank
        then uses on its own channels or heads: the sum (all_reduce), whose
        gradient, partial on each rank, is summed too (all_reduce)."""
        return comm.copy_to(comm.reduce_from(t, self.group), self.group)


class _ShareGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, size):
        ctx.size = size
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def _path_names(path):
    return [str(e.key) for e in path if hasattr(e, "key")]


#: unsplit leaves that compute on whole data for the rank's heads or
#: partial expert outputs alone: their gradient is partial without
#: ``seq_carry`` too (see the module note)
PARTIAL_NAMES = frozenset({"q_norm", "k_norm", "wdkv", "kv_norm", "wkr",
                           "router"})
#: per recurrent mixer, the leaf whose split over "model" makes the layer
#: run on the rank's channels or heads, and the unsplit leaves the rank
#: then takes its channels or heads of (Mamba's depthwise conv, dt bias, A
#: and D; the mLSTM's conv, which every rank runs whole but whose output
#: only the rank's heads and skip channels read, its gates and its skip
#: norm; the sLSTM's recurrent weights and gate biases, and its out norm,
#: which every rank runs whole but whose output only the rank's up-
#: projection columns read): their gradient is partial without
#: ``seq_carry`` too.  A Mamba laid out whole (``state_specs(...,
#: extra_replicated=MAMBA_PARAM_NAMES)``) computes whole on every rank, so
#: its leaves are partial under ``seq_carry`` alone.
PARTIAL_IN = {"mamba": ("in_proj", frozenset({"conv_w", "conv_b",
                                              "dt_bias", "A_log", "D"})),
              "mlstm": ("up", frozenset({"conv_w", "conv_b", "wi", "wf",
                                         "skip_norm"})),
              "slstm": ("wx", frozenset({"r", "b", "out_norm"}))}


def model_split(params, mesh) -> List[bool]:
    """Per leaf of ``params`` (in ``tree_leaves`` order): True where the
    leaf, as laid out, is split over ``mesh``'s "model" axis: read from a
    DTensor's own placements (so a state laid out with ``state_specs(...,
    ep=True)`` reads as such); a plain tensor is not split."""
    from torch.distributed.tensor import DTensor
    leaves = pytree.tree_leaves(params)
    if "model" not in axis_names(mesh):
        return [False] * len(leaves)
    out = []
    for leaf in leaves:
        split = False
        if isinstance(leaf, DTensor):
            dim = leaf.device_mesh.mesh_dim_names.index("model")
            split = leaf.placements[dim].is_shard()
        out.append(split)
    return out


def _mixer_at(path):
    """(the path up to a recurrent mixer's key, the mixer, the key after
    it) of a leaf under one (``PARTIAL_IN``), else None."""
    for i, e in enumerate(path[:-1]):
        mixer = getattr(e, "key", None)
        if mixer in PARTIAL_IN and hasattr(path[i + 1], "key"):
            return tuple(map(str, path[:i + 1])), mixer, str(path[i + 1].key)
    return None


#: the enc-dec model's leaves that compute on the encoder's sequence
ENCODER_KEYS = frozenset({"frontend", "enc_unit", "enc_norm"})


def partial_leaves(params, mesh, seq_carry: bool,
                   source_carry: Optional[bool] = None) -> List[bool]:
    """Per leaf of ``params`` (in ``tree_leaves`` order): True where the
    rank's gradient is a partial sum over "model" (see the module note and
    ``PARTIAL_IN``).  ``source_carry``: the enc-dec encoder's own
    ``seq_carry``, which its leaves (``ENCODER_KEYS``) take instead."""
    paths = [p for p, _ in pytree.tree_flatten_with_path(params)[0]]
    split = model_split(params, mesh)
    at = [_mixer_at(path) for path in paths]
    running = {a[0] for s, a in zip(split, at)      # mixers run split
               if s and a is not None and a[2] == PARTIAL_IN[a[1]][0]}
    out = []
    for s, path, a in zip(split, paths, at):
        names = _path_names(path)
        local = a is not None and a[0] in running and \
            a[2] in PARTIAL_IN[a[1]][1]
        rows = source_carry if source_carry is not None and \
            names[:1] and names[0] in ENCODER_KEYS else seq_carry
        out.append(not s and (rows or local
                              or not PARTIAL_NAMES.isdisjoint(names)))
    return out


def sum_partial(grads: List[Optional[torch.Tensor]], partial: List[bool],
                tp: TensorParallel) -> List[Optional[torch.Tensor]]:
    """``grads`` with each partial leaf summed over "model": one all_reduce
    of the partial leaves flattened together (one per dtype)."""
    out = list(grads)
    by_dtype: dict = {}
    for i, (g, p) in enumerate(zip(grads, partial)):
        if p and g is not None:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        comm.all_reduce(flat, tp.group.group)
        for i, part in zip(idx, torch.split(
                flat, [grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def reduce_max(values: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The elementwise max of ``values`` (a stacked vector) over "model":
    one all_gather (``comm`` has no MAX reduction)."""
    parts = comm.all_gather(values, tp.group.group)
    return torch.stack(parts).amax(0)
