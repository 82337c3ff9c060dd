"""Op recording: the record every analysis rule reads (the JAX package's
``repro.analysis.traversal``).

JAX traces a solve into a jaxpr and walks it without running anything.
Eager PyTorch has no trace: the port RUNS the call once under
``OpRecorder``, a ``TorchDispatchMode``, and keeps a record of what ran.
Forward and backward both pass through the dispatcher, so one recorder
around a loss and its ``torch.autograd.grad`` sees the whole gradient.

The JAX walker's pieces and their counterparts here:

``iter_eqns`` / ``EqnContext``   ``OpRecorder.records``: one ``OpRecord`` per
                                 aten op (name, input and output dtypes,
                                 shapes, the bytes it allocated) with its
                                 ``OpContext``: the innermost solver frame
                                 on the Python stack when it ran (attempt,
                                 step, stage, step adjoint).  An op inside
                                 one of them re-runs every step, which is
                                 what a loop depth > 0 means in a jaxpr.
                                 Ops that autograd's engine runs in C++
                                 (the backward of DirectBackprop's steps)
                                 have no Python frame: their context is the
                                 top level.  An op whose every operand was
                                 made outside the call (a literal lifted,
                                 a cached tableau row moved or cast on a
                                 combiner's first call) is constant
                                 preparation, JAX's trace-time work: not
                                 recorded, so what ran before a call does
                                 not change its record.
``count_eqns``                   ``count_ops``: the recorded aten ops plus
                                 the port's own kernel launches, read from
                                 each wrapper's ``.launches`` counter
                                 around the call (the ctypes kernels do
                                 not pass through the dispatcher).
                                 ``OpCounter`` counts every op, cheaply
                                 (what the per-observation flatness rule
                                 compares between runs).
``peak_resident_bytes``          ``OpRecorder.peak_bytes``: live bytes of
                                 the storages allocated inside the call, by
                                 storage (a storage counts once however
                                 many views read it, and is freed when the
                                 last tensor the recorder saw on it dies,
                                 by ``weakref.finalize``: autograd keeps
                                 the Python object of a saved tensor alive,
                                 so a saved activation stays live until
                                 the graph frees it).  Each allocation has
                                 an id of its own (a freed ``data_ptr`` is
                                 reused at once), an in-place op or a view
                                 allocates nothing, and inputs do not
                                 count: the peak is what the call adds.
``dce``                          nothing: eager execution allocates only
                                 what it runs, so there is no dead stacked
                                 buffer to prune.
``closed_constants``             ``OpRecorder.external``: tensors an op
                                 read that are neither a declared input
                                 nor made inside the call (a closure's
                                 captured tensor, ``torch.tensor`` of
                                 literal data).
``collective_eqns``              ``OpRecorder.collectives``: the ``c10d``
                                 ops the dispatcher saw, with their
                                 operands' shapes (``parallel.comm.COUNTS``
                                 counts the same calls by kind).
"""
from __future__ import annotations

import dataclasses
import functools
import sys
import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpContext", "OpRecord", "OpCounter", "OpRecorder", "record",
           "count_ops", "tensor_bytes", "kernel_launches", "CAST_OPS",
           "SOLVER_FRAMES"]

# (module, function) -> the solver context an op inside it runs in
SOLVER_FRAMES: Dict[Tuple[str, str], str] = {
    ("repro_torch.core.stepper", "advance"): "attempt",
    ("repro_torch.core.stepper", "advance_in_place"): "attempt",
    ("repro_torch.core.stepper", "rk_step"): "step",
    ("repro_torch.core.stepper", "rk_stages"): "stage",
    ("repro_torch.core.symplectic", "_step_adjoint"): "step_adjoint",
    ("repro_torch.core.symplectic",
     "symplectic_step_adjoint_lanes"): "step_adjoint",
}

# ops that change a tensor's dtype: (source, destination) argument indices
CAST_OPS: Dict[str, Tuple[int, Optional[int]]] = {
    "aten._to_copy": (0, None),     # .to(dtype) / .double() / .float()
    "aten.copy_": (1, 0),           # dst.copy_(src) in dst's dtype
}


@dataclasses.dataclass(frozen=True)
class OpContext:
    """Where an op ran: the innermost solver frame on the Python stack
    ("attempt", "step", "stage", "step_adjoint"), or none at the top level.
    Non-empty means the op re-runs every step (a jaxpr's loop depth > 0)."""
    path: Tuple[str, ...] = ()

    @property
    def loop_depth(self) -> int:
        return 1 if self.path else 0


class OpRecord(NamedTuple):
    name: str                                   # "aten.mul", "c10d.allreduce_"
    in_dtypes: Tuple[torch.dtype, ...]
    in_shapes: Tuple[Tuple[int, ...], ...]
    out_dtypes: Tuple[torch.dtype, ...]
    out_shapes: Tuple[Tuple[int, ...], ...]
    new_bytes: int                              # storages it allocated
    context: OpContext
    # (src, dst) dtypes of a cast of a tensor the call made or took as an
    # input
    cast: Optional[Tuple[torch.dtype, torch.dtype]] = None


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of a tensor's own elements (``aval_bytes``'s counterpart)."""
    return t.numel() * t.element_size()


def _storage_ptr(t: torch.Tensor) -> Optional[int]:
    """The address of a tensor's storage (None where there is none)."""
    if t.layout is not torch.strided or t.is_meta:
        return None
    return t.data_ptr() - t.storage_offset() * t.element_size()


@functools.lru_cache(maxsize=None)
def _solver_codes() -> Dict[object, str]:
    """The code objects of ``SOLVER_FRAMES``' functions -> their kind."""
    import importlib
    codes = {}
    for (mod, name), kind in SOLVER_FRAMES.items():
        m = importlib.import_module(mod)
        for obj in [m] + [v for v in vars(m).values() if isinstance(v, type)
                          and v.__module__ == mod]:
            fn = getattr(obj, name, None) if obj is not m \
                else vars(m).get(name)
            code = getattr(fn, "__code__", None)
            if code is not None and code.co_name == name:
                codes[code] = kind
    return codes


_CONTEXTS: Dict[str, OpContext] = {None: OpContext()}


def _context(codes, stop) -> OpContext:
    """The innermost solver frame between the op and the recorder's entry
    frame ``stop``."""
    f = sys._getframe(2)
    kind = None
    while f is not None and f is not stop:
        kind = codes.get(f.f_code)
        if kind is not None:
            break
        f = f.f_back
    ctx = _CONTEXTS.get(kind)
    if ctx is None:
        ctx = _CONTEXTS[kind] = OpContext((kind,))
    return ctx


def _tensors(tree, out):
    """The tensors of an op's arguments or outputs (tensors, lists, tuples
    and dicts of them)."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    return out


def _kernel_wrappers():
    from repro_torch.kernels import butcher_combine, flash_attention, rmsnorm
    return {"butcher_combine": butcher_combine.butcher_combine,
            "butcher_combine_rows": butcher_combine.butcher_combine_rows,
            "rms_norm": rmsnorm.rms_norm,
            "rms_norm_bwd": rmsnorm.rms_norm_bwd,
            "flash_attention": flash_attention.flash_attention,
            "flash_attention_bwd": flash_attention.flash_attention_bwd}


def kernel_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by name."""
    return {k: w.launches for k, w in _kernel_wrappers().items()}


class OpCounter(TorchDispatchMode):
    """Counts the aten ops and the kernel launches of the calls made inside
    ``with`` (all the per-observation flatness rule reads)."""

    def __init__(self):
        super().__init__()
        self.n_ops = 0
        self.launches: Dict[str, int] = {}
        self._launches0: Dict[str, int] = {}

    def __enter__(self):
        self._launches0 = kernel_launches()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self.launches = {k: v - self._launches0[k]
                         for k, v in kernel_launches().items()
                         if v != self._launches0[k]}
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n_ops += 1
        return func(*args, **(kwargs or {}))


class OpRecorder(OpCounter):
    """Records every aten op of the calls made inside ``with``, and the
    bytes they hold.

    ``inputs``: the call's declared inputs and parameters (a pytree of
    tensors); an op that reads any other tensor made outside the call
    records it in ``external``.  ``records=False`` keeps only the counts,
    the bytes, ``external`` and ``collectives`` (no per-op record, no
    solver context: what the memory rule reads, at a lower cost)."""

    def __init__(self, inputs=None, records: bool = True):
        super().__init__()
        self.records: List[OpRecord] = []
        self.collectives: List[Tuple[str, Tuple[Tuple[int, ...], ...]]] = []
        self.external: Dict[int, Tuple[Tuple[int, ...], torch.dtype, int]] = {}
        self.peak_bytes = 0
        self.live_bytes = 0
        self._keep = records
        self._declared = set()
        for t in pytree.tree_leaves(inputs):
            p = _storage_ptr(t) if isinstance(t, torch.Tensor) else None
            if p is not None:
                self._declared.add(p)
        self._live: Dict[int, int] = {}          # data_ptr -> allocation id
        self._alloc: Dict[int, List] = {}        # id -> [ptr, bytes, refs]
        self._dead: List[int] = []               # ids whose tensor died
        self._next = 0
        self._ops: Dict[object, Tuple] = {}      # op -> (name, cast, c10d)

    def __enter__(self):
        self._codes = _solver_codes()
        self._stop = sys._getframe(1)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._drain()
        self._stop = None          # the entry frame holds its locals alive
        return out

    # finalizers only append: the counts change here, between ops
    def _drain(self):
        while self._dead:
            aid = self._dead.pop()
            entry = self._alloc[aid]
            entry[2] -= 1
            if entry[2] == 0:
                del self._alloc[aid]
                if self._live.get(entry[0]) == aid:
                    del self._live[entry[0]]
                self.live_bytes -= entry[1]

    def _watch(self, t: torch.Tensor, aid: int):
        self._alloc[aid][2] += 1
        weakref.finalize(t, self._dead.append, aid).atexit = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._ops.get(func)
        if info is None:
            name = str(func.overloadpacket)
            info = self._ops[func] = (name, CAST_OPS.get(name),
                                      name.startswith("c10d."))
        name, cast_spec, collective = info
        ins = _tensors(args, [])
        if kwargs:
            _tensors(kwargs, ins)
        live, in_ptrs, internal = self._live, {}, not ins
        for a in ins:
            p = _storage_ptr(a)
            if p is None:
                continue
            in_ptrs[p] = a
            if p in live or p in self._declared:
                internal = True
            elif p not in self.external:
                self.external[p] = (tuple(a.shape), a.dtype,
                                    a.untyped_storage().nbytes())
        out = func(*args, **kwargs)
        if self._dead:
            self._drain()
        outs = _tensors(out, [])
        new = 0
        for t in outs:
            p = _storage_ptr(t)
            if p is None or any(t is a for a in ins):
                continue                         # in place: the same tensor
            aid = live.get(p)
            if aid is not None:
                self._watch(t, aid)              # a view of a live storage
                continue
            if p in in_ptrs:
                continue                         # a view of an input
            nbytes = t.untyped_storage().nbytes()
            if nbytes == 0:
                continue
            aid = self._next
            self._next += 1
            live[p] = aid
            self._alloc[aid] = [p, nbytes, 0]
            self._watch(t, aid)
            new += nbytes
        if new:
            self.live_bytes += new
            if self.live_bytes > self.peak_bytes:
                self.peak_bytes = self.live_bytes
        if not internal:
            # every operand made outside the call: a literal lifted, a
            # cached constant moved or cast (the first call of a combiner
            # fills its row cache), which JAX does at trace time; not
            # counted, so a count does not depend on what ran before
            return out
        self.n_ops += 1
        if not self._keep:
            if collective:
                self.collectives.append((name, tuple([a.shape for a in ins])))
            return out
        cast = None
        if cast_spec is not None:
            src, dst = cast_spec
            dst_dtype = kwargs.get("dtype", args[0].dtype) if dst is None \
                else args[dst].dtype
            p = _storage_ptr(args[src])
            # a cast of a tensor made outside the call (a literal, a cached
            # tableau row) is a constant taking the state's dtype: JAX's
            # weakly-typed literals, no convert
            if dst_dtype is not None and (p in live or p in self._declared):
                cast = (args[src].dtype, dst_dtype)
        in_shapes = tuple([a.shape for a in ins])
        if collective:
            self.collectives.append((name, in_shapes))
        self.records.append(OpRecord(
            name, tuple([a.dtype for a in ins]), in_shapes,
            tuple([t.dtype for t in outs]), tuple([t.shape for t in outs]),
            new, _context(self._codes, self._stop), cast))
        return out


def record(fn, *args, inputs=None, records: bool = True):
    """``fn(*args)`` under a fresh ``OpRecorder``: returns (result,
    recorder).  ``inputs`` defaults to ``args``."""
    rec = OpRecorder(args if inputs is None else inputs, records)
    with rec:
        result = fn(*args)
    return result, rec


def count_ops(rec: OpCounter) -> int:
    """aten ops plus kernel launches of one recorded call."""
    return rec.n_ops + sum(rec.launches.values())
