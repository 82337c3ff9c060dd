"""PartitionSpec assignment for params, optimizer state, batches and caches
(the JAX package's ``repro.parallel.shardings``, the same rules).

Param specs are derived from leaf names (path-based rules), giving
Megatron-style tensor parallelism:

  column-parallel (shard OUT dim on "model"): wq wk wv wg wu up in_proj
      x_proj wuk wuv frontend up1 up2 lm_head
  row-parallel    (shard IN dim on "model"):  wo wd down out_proj dt_proj
  embed (vocab, d): vocab on "model"
  MoE expert banks (E, d, f)/(E, f, d): shard f on "model" (TP-in-expert);
      ``ep=True`` shards E instead (expert parallelism).
  everything else (norms, gates, biases, scalars, ssm params): replicated.

The port's LM keeps one leaf per repeat unit (``params["unit"][r]``) where
the JAX package stacks the R units on a leading dim; that stack dim is
never sharded on "model" there, so a unit leaf's spec is the JAX spec with
its leading None dropped.

Optimizer state: the spec of its param; with ``zero1=True`` the float32
m / v / master leaves are also split over "data" (ZeRO-1) on the first
dimension that is unsharded and divisible.  For a unit leaf that is the
JAX package's stack dim whenever R divides by the data size: the port then
gives each data rank a contiguous block of R / data units whole
(``Owned``); otherwise it splits the same dim of every unit leaf that JAX
splits.  Either way each data rank holds 1/data of the optimizer bytes.
"""
from __future__ import annotations

import dataclasses

from torch.utils import _pytree as pytree

from .layout import P, axis_names, axis_sizes

COL_NAMES = {"wq", "wk", "wv", "wg", "wu", "up", "in_proj", "x_proj",
             "wuk", "wuv", "frontend", "up1", "up2", "lm_head", "wx",
             "wt_gate", "wt_bias", "fc1", "fc2"}
ROW_NAMES = {"wo", "wd", "down", "out_proj", "dt_proj"}
REPLICATED = {"router", "conv_w", "conv_b", "dt_bias", "A_log", "D", "r",
              "b", "w", "b1", "b2", "wi", "wf", "conv_b"}
#: the Mamba leaves the JAX dryrun's ``--replicate-mamba`` lays out whole
#: (``extra_replicated``; ``repro.launch.dryrun.MAMBA_PARAM_NAMES``)
MAMBA_PARAM_NAMES = frozenset({"in_proj", "out_proj", "x_proj", "dt_proj",
                               "conv_w", "conv_b"})


@dataclasses.dataclass(frozen=True)
class Owned:
    """The ZeRO-1 spec of a unit's optimizer leaf held WHOLE by the ranks
    whose ``axis`` coordinate is ``index`` (laid out there by ``spec`` over
    the other axes); the other ranks hold nothing of it."""
    axis: str
    index: int
    spec: P


def _key_name(entry):
    for attr in ("key", "name"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return None


def _leaf_name(path) -> str:
    for entry in reversed(path):
        name = _key_name(entry)
        if name is not None:
            return name
    return ""


def _path_names(path):
    return [str(e.key) for e in path if hasattr(e, "key")]


def _shape(leaf):
    return tuple(getattr(leaf, "shape", ()))


def _spec_for(path, leaf, mesh, ep: bool, fsdp: bool = False,
              extra_replicated=frozenset()) -> P:
    name = _leaf_name(path)
    shape = _shape(leaf)
    ndim = len(shape)
    if name in extra_replicated:
        return P(*([None] * ndim))
    names = _path_names(path)
    sizes = axis_sizes(mesh)
    if ndim == 0 or "model" not in sizes:
        return P()
    m, msize = "model", sizes["model"]
    in_moe = "moe" in names or name == "shared"

    def pad(entries):
        entries = list(entries)
        # drop any axis assignment whose dim is not divisible
        for i, e in enumerate(entries):
            if e is not None and (shape[i] % msize != 0
                                  or shape[i] < msize):
                entries[i] = None
        if fsdp and "data" in sizes:
            # FSDP: also split one large weight dim over "data"
            dsize = sizes["data"]
            nelems = 1
            for s in shape:
                nelems *= s
            if nelems >= (1 << 20):
                for i in range(len(entries)):
                    if entries[i] is None and shape[i] % dsize == 0 \
                            and shape[i] >= dsize:
                        entries[i] = "data"
                        break
        return P(*entries)

    if name == "embed" and ndim == 2:
        return pad([m, None])
    if in_moe and ndim == 3:          # (E, d, f) or (E, f, d) expert banks
        if ep:
            return pad([m, None, None])
        if name in ("wg", "wu"):
            return pad([None, None, m])
        if name == "wd":
            return pad([None, m, None])
        return pad([None] * 3)
    if name in COL_NAMES and ndim >= 2:
        return pad([None] * (ndim - 1) + [m])
    if name in ROW_NAMES and ndim >= 2:
        return pad([m] + [None] * (ndim - 1))
    return pad([None] * ndim)


def param_specs(params, mesh, *, ep: bool = False, fsdp: bool = False,
                extra_replicated=frozenset()):
    """Tree of ``PartitionSpec`` matching ``params``."""
    return pytree.tree_map_with_path(
        lambda path, leaf: _spec_for(path, leaf, mesh, ep, fsdp,
                                     extra_replicated), params)


def _zero1_spec(spec: P, shape, mesh) -> P:
    sizes = axis_sizes(mesh)
    if "data" not in sizes:
        return spec
    dsize = sizes["data"]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for e in entries:  # FSDP already consumed the data axis
        if e == "data" or (isinstance(e, tuple) and "data" in e):
            return spec
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % dsize == 0 and dim >= dsize:
            entries[i] = "data"
            return P(*entries)
    return spec


def _unit_index(path):
    """(unit index r) of a leaf under ``["unit"][r]``, else None."""
    for a, b in zip(path, path[1:]):
        if getattr(a, "key", None) == "unit" and hasattr(b, "idx"):
            return b.idx
    return None


def _zero1_leaf(path, spec, leaf, mesh, n_units):
    """ZeRO-1 spec of one optimizer leaf, mapping the JAX package's
    stacked unit leaves onto the port's per-unit leaves."""
    shape = _shape(leaf)
    r = _unit_index(path)
    if r is None:
        return _zero1_spec(spec, shape, mesh)
    stacked = _zero1_spec(P(None, *spec), (n_units,) + shape, mesh)
    if stacked and stacked[0] == "data":
        per = n_units // axis_sizes(mesh)["data"]
        return Owned("data", r // per, P(*stacked[1:]))
    return P(*stacked[1:])


def _is_spec_leaf(x):
    return isinstance(x, (P, Owned))


def state_specs(state, mesh, *, ep: bool = False, zero1: bool = True,
                fsdp: bool = False, extra_replicated=frozenset()):
    """Specs for the full train state: the ``{"params", "opt"}`` dict or a
    ``train.TrainState`` (rng / data cursor / solver stats are small and
    always replicated; the result mirrors the input's kind).
    ``extra_replicated``: leaf names laid out whole (``param_specs``; e.g.
    ``MAMBA_PARAM_NAMES``, the JAX dryrun's ``--replicate-mamba``), their
    optimizer state alike."""
    from repro_torch.train.state import TrainState
    if isinstance(state, TrainState):
        as_dict = {"params": state.params, "opt": state.opt}
        if state.compress_err is not None:
            as_dict["compress_err"] = state.compress_err
        base = state_specs(as_dict, mesh, ep=ep, zero1=zero1, fsdp=fsdp,
                           extra_replicated=extra_replicated)

        def repl(t):
            return pytree.tree_map(lambda l: P(*([None] * len(_shape(l)))),
                                   t)
        return TrainState(
            params=base["params"], opt=base["opt"],
            rng=repl(state.rng), data_step=repl(state.data_step),
            solver_stats=repl(state.solver_stats),
            compress_err=base.get("compress_err"))
    params = state["params"]
    pspecs = param_specs(params, mesh, ep=ep, fsdp=fsdp,
                         extra_replicated=extra_replicated)
    n_units = len(params["unit"]) if isinstance(params, dict) \
        and "unit" in params else 0
    out = {"params": pspecs}
    opt = {}
    for k in state["opt"]:
        if k == "step":
            opt["step"] = P()
            continue
        if zero1:
            flat, spec = pytree.tree_flatten_with_path(state["opt"][k])
            pflat = pytree.tree_flatten(pspecs, is_leaf=_is_spec_leaf)[0]
            opt[k] = pytree.tree_unflatten(
                [_zero1_leaf(path, ps, leaf, mesh, n_units)
                 for (path, leaf), ps in zip(flat, pflat)], spec)
        else:
            opt[k] = pspecs
    out["opt"] = opt
    if "compress_err" in state:
        out["compress_err"] = pspecs
    return out


def batch_specs(batch, mesh):
    """Shard every batch leaf's leading (batch) dim over (pod, data).

    A batch dim that is not divisible by the FULL data-parallel product
    falls back to the longest divisible prefix of ("pod", "data"), with a
    warning (``solve.lane_axes`` is the single source of that rule); only
    when NO prefix divides does the leaf replicate."""
    from .solve import lane_axes

    def spec(leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        dp = lane_axes(mesh, int(shape[0]))
        if not dp:
            return P(*([None] * len(shape)))
        return P(dp, *([None] * (len(shape) - 1)))

    return pytree.tree_map(spec, batch)


def cache_specs(caches, mesh, *, batch_size: int):
    """KV-cache sharding for serving: batch dim -> (pod, data) when
    divisible; the cache SEQUENCE dim (the first trailing dim >= 1024) ->
    "model" (both ("data", "model") when the batch is 1); a cache without
    a sequence dim shards its largest feature dims instead."""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    dp = tuple(a for a in ("pod", "data") if a in names)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    msize = sizes.get("model", 1)
    batch_sharded = batch_size % dp_size == 0 and batch_size >= dp_size

    def spec(leaf):
        shape = _shape(leaf)
        nd = len(shape)
        if nd == 0:
            return P()
        entries = [None] * nd
        b_idx = 0 if shape[0] == batch_size else \
            (1 if nd > 1 and shape[1] == batch_size else None)
        if b_idx is None:
            return P(*entries)
        if batch_sharded:
            entries[b_idx] = dp
        rest = list(range(b_idx + 1, nd))
        seq_idx = next((i for i in rest if shape[i] >= 1024), None)
        if seq_idx is not None:
            if batch_sharded:
                if shape[seq_idx] % msize == 0:
                    entries[seq_idx] = "model"
            else:
                full = dp + ("model",)
                fsize = dp_size * msize
                if shape[seq_idx] % fsize == 0:
                    entries[seq_idx] = full
                elif shape[seq_idx] % msize == 0:
                    entries[seq_idx] = "model"
            return P(*entries)
        cands = sorted(rest, key=lambda i: -shape[i])
        for i in cands:
            if entries[i] is None and shape[i] % msize == 0 and \
                    shape[i] >= msize:
                entries[i] = "model"
                break
        if not batch_sharded and dp:
            for i in cands:
                if entries[i] is None and shape[i] % dp_size == 0 and \
                        shape[i] >= dp_size:
                    entries[i] = dp
                    break
        return P(*entries)

    return pytree.tree_map(spec, caches)
