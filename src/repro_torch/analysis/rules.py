"""Pluggable analysis rules over recorded calls (the JAX package's
``repro.analysis.rules``).

Every rule is a function ``(recorder or counts, case_key, **knobs) ->
[Finding]``.  Findings carry a severity: ``error`` findings fail
``--check``; ``warning`` and ``info`` findings are reported but never gate.

Where a JAX rule reads what eager PyTorch does not have, its counterpart
here:

* ``dtype-discipline`` reads the recorded casts (``aten._to_copy``,
  ``aten.copy_``) and every op's float dtypes, in place of
  ``convert_element_type`` eqns; "inside a loop" is an op whose
  ``OpContext`` holds a solver frame.
* ``constant-hazard``: a closed-over jaxpr constant is, eagerly, a tensor
  an op reads that is neither an input, a parameter nor made inside the
  call (``OpRecorder.external``).
* ``donation-hazard``: eager code has no donation; its counterpart is the
  serve engine's in-place contract.  Across one
  ``AdaptiveStepper.advance_in_place`` every state buffer of at least
  ``min_bytes`` keeps its ``data_ptr`` and the attempt allocates no new
  buffer of that size (an ERROR for the engine probe, INFO elsewhere).
* ``trace-size-budget``: the jaxpr's eqn count becomes ``count_ops`` of
  the run (aten ops plus kernel launches) against the port's own budgets,
  ``budgets.json`` beside this module, keyed ``case:kind:backend``.  The
  counts of an eager run depend on the data (an adaptive case's attempts),
  so the probes run seeded inputs; they also differ between backends
  (a kernel launch replaces the plain combine's ops) and may differ
  between torch versions, so each backend's keys are written from the
  platform it runs on: ``torch`` from the CPU, ``cuda`` from the card.
* the O(1)-in-observations trace size of ``flatness_findings``: an eager
  run has no trace to stay constant, and a SaveAt solve does its steps'
  work once per observation segment.  The counterpart holds the work per
  observation constant: at 4, 8 and 16 observations on one grid
  (``cases.observation_times``), the op count grows by the same number per
  added observation, within 10 % of the ops per observation.  A
  driver whose work per observation grows with the number of observations
  (a rescan of the earlier ones, a restack per segment) fails it.
* ``collective-count`` reads ``parallel.comm.COUNTS`` (the calls by kind)
  and the recorder's ``c10d`` ops (their operands' shapes) around a
  sharded probe, in place of ``psum`` eqns.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch

from .traversal import OpRecorder, count_ops

__all__ = ["Finding", "RULE_REGISTRY", "register_rule", "dtype_findings",
           "constant_findings", "donation_findings", "budget_findings",
           "flatness_findings", "collective_findings", "ERROR", "WARNING",
           "INFO"]

ERROR, WARNING, INFO = "error", "warning", "info"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    severity: str          # "error" | "warning" | "info"
    case: str              # enumerated-case key or a probe's name
    message: str

    def __str__(self):
        return f"[{self.severity}] {self.rule} :: {self.case}: {self.message}"


RULE_REGISTRY: Dict[str, Callable] = {}


def register_rule(name: str):
    def deco(fn):
        RULE_REGISTRY[name] = fn
        return fn
    return deco


def _where(ctx) -> str:
    return ("inside " + "/".join(ctx.path)) if ctx.path else \
        "at the top level"


@register_rule("dtype-discipline")
def dtype_findings(rec: OpRecorder, case: str = "<call>") -> List[Finding]:
    """Flag silent float precision changes.

    Demotions (f64 -> f32, f32 -> bf16, ...) are ERRORS anywhere: run with
    float64 inputs, a narrowing float cast, or an op whose float output is
    narrower than its widest float operand of rank >= 1, means some
    intermediate hardcodes a dtype.  Widening casts inside a solver step
    are WARNINGS (a cast per step is a bandwidth smell), except when the
    destination is exactly f32: the deliberate promote(x, f32) accumulate
    idiom for bf16/f16 states (kernels/ref.py)."""
    out = []
    for r in rec.records:
        if r.cast is not None:
            src, dst = r.cast
            if not (src.is_floating_point and dst.is_floating_point):
                continue
            size_s, size_d = src.itemsize, dst.itemsize
        else:
            ins = [d for d, s in zip(r.in_dtypes, r.in_shapes)
                   if d.is_floating_point and len(s) > 0]
            outs = [d for d in r.out_dtypes if d.is_floating_point]
            if not ins or not outs:
                continue
            src = max(ins, key=lambda d: d.itemsize)
            dst = min(outs, key=lambda d: d.itemsize)
            size_s, size_d = src.itemsize, dst.itemsize
            if size_d >= size_s:
                continue
        where = _where(r.context)
        if size_d < size_s:
            out.append(Finding(
                "dtype-discipline", ERROR, case,
                f"float demotion {src} -> {dst} in {r.name} {where} "
                f"(loop depth {r.context.loop_depth}): an intermediate "
                "hardcodes a narrower dtype than the state"))
        elif size_d > size_s and r.context.loop_depth > 0 \
                and dst != torch.float32:
            out.append(Finding(
                "dtype-discipline", WARNING, case,
                f"float promotion {src} -> {dst} in {r.name} {where} "
                f"(loop depth {r.context.loop_depth}): widening cast "
                "repeats every step"))
    return out


@register_rule("constant-hazard")
def constant_findings(rec: OpRecorder, case: str = "<call>",
                      min_bytes: int = 1 << 20) -> List[Finding]:
    """Large tensors (>= ``min_bytes``) an op read that the call neither
    took as an input or parameter nor made: the eager form of a
    closed-over constant.  It is invisible to the caller (a gradient or a
    device move skips it) and should be an argument instead.  WARNING."""
    out = []
    for shape, dtype, nbytes in rec.external.values():
        if nbytes >= min_bytes:
            out.append(Finding(
                "constant-hazard", WARNING, case,
                f"closed-over tensor {dtype}{list(shape)} "
                f"({nbytes / 2**20:.1f} MiB >= {min_bytes / 2**20:.1f} MiB):"
                " pass it as an argument instead of capturing it"))
    return out


@register_rule("donation-hazard")
def donation_findings(rec: OpRecorder, case: str = "<call>",
                      min_bytes: int = 1 << 16,
                      before: Mapping[str, Tuple[int, int]] = None,
                      after: Mapping[str, Tuple[int, int]] = None,
                      severity: str = INFO) -> List[Finding]:
    """The in-place contract of a state update.

    ``before``/``after``: the state's buffers as ``{name: (data_ptr,
    nbytes)}`` around the call.  A buffer of at least ``min_bytes`` whose
    ``data_ptr`` moved, or a new allocation of at least ``min_bytes`` in
    the call, means the update did not write in place.  INFO by default (a
    hint: the call could reuse its input's buffer); the serve engine's
    ``advance_in_place``, whose slot tensors must keep their storage,
    passes ``severity="error"``."""
    out = []
    moved = sorted(k for k, (p, b) in (before or {}).items()
                   if b >= min_bytes and (after or {}).get(k, (p,))[0] != p)
    if moved:
        out.append(Finding(
            "donation-hazard", severity, case,
            f"state buffer(s) {moved} changed storage across the update: "
            "write them in place"))
    big = [r for r in rec.records if r.new_bytes >= min_bytes]
    if big:
        total = sum(r.new_bytes for r in big)
        out.append(Finding(
            "donation-hazard", severity, case,
            f"{len(big)} allocation(s) of >= {min_bytes} B "
            f"({total / 2**10:.0f} KiB; {sorted({r.name for r in big})}): "
            "the update could reuse its input buffers"))
    return out


@register_rule("collective-count")
def collective_findings(counts: Mapping[str, int],
                        collectives: Sequence[Tuple[str, Tuple]],
                        case: str = "<call>", kind: str = "value",
                        param_shapes=None) -> List[Finding]:
    """The sharded solve's communication contract.

    ``counts``: ``parallel.comm.COUNTS`` over the call; ``collectives``:
    the recorder's ``c10d`` ops with their operands' shapes.  The value
    pass makes NO collective; the gradient makes EXACTLY one ``all_reduce``
    per parameter leaf, each of that leaf's shape, and nothing else (any
    other collective means lane state started crossing ranks; a missing
    one means a parameter cotangent is rank-partial)."""
    out = []
    other = {k: v for k, v in counts.items() if k != "all_reduce" and v}
    if other:
        out.append(Finding(
            "collective-count", ERROR, case,
            f"{kind} pass makes non-all_reduce collectives {other}: lane "
            "state is crossing ranks (the shard-local replay contract)"))
    n_reduce = counts.get("all_reduce", 0)
    shapes = sorted(s for name, operands in collectives
                    if name.startswith("c10d.allreduce") for s in operands)
    if kind == "value":
        if n_reduce or shapes:
            out.append(Finding(
                "collective-count", ERROR, case,
                f"value pass makes {n_reduce} all_reduce(s): the sharded "
                "forward must be collective-free"))
        return out
    expected = sorted(tuple(s) for s in (param_shapes or []))
    if n_reduce != len(expected) or shapes != expected:
        out.append(Finding(
            "collective-count", ERROR, case,
            f"grad pass makes {n_reduce} all_reduce(s) of shapes {shapes} "
            f"!= one per param leaf {expected}: the backward must "
            "all-reduce exactly the theta cotangents and nothing else"))
    return out


@register_rule("trace-size-budget")
def budget_findings(rec: OpRecorder, case: str, budgets: Dict[str, int],
                    kind: str = "value",
                    backend: str = "torch") -> List[Finding]:
    """Ratchet ``count_ops`` against ``budgets.json``.

    Over budget is an ERROR (some driver started doing more per call); a
    count under 80 % of the budget is INFO (re-run ``--write-budgets`` to
    tighten the ratchet after a deliberate improvement); a case missing
    from the committed budgets is an ERROR (new strategies commit budgets
    with their change)."""
    key = f"{case}:{kind}:{backend}"
    n = count_ops(rec)
    budget = budgets.get(key)
    if budget is None:
        return [Finding(
            "trace-size-budget", ERROR, case,
            f"no committed budget for {key!r} (count {n}); run "
            "`python -m repro_torch.analysis --write-budgets` on this "
            "backend and commit budgets.json")]
    if n > budget:
        return [Finding(
            "trace-size-budget", ERROR, case,
            f"{kind} pass runs {n} ops > budget {budget} ({backend}): "
            "op-count regression (if intended, re-ratchet with "
            "--write-budgets)")]
    if n < 0.8 * budget:
        return [Finding(
            "trace-size-budget", INFO, case,
            f"{kind} pass runs {n} ops, well under budget {budget} "
            f"({backend}); consider tightening with --write-budgets")]
    return []


def flatness_findings(case: str, kind: str, counts: Mapping[int, int],
                      tol: float = 0.10) -> List[Finding]:
    """Constant work per observation for the SaveAt drivers: with
    ``counts`` = {n_obs: op count} at three or more observation counts of
    one horizon, each added observation must cost the same number of ops
    (the per-observation increments agree within ``tol`` of the larger of
    them and of the ops per observation at the fewest observations)."""
    ns = sorted(counts)
    rates = [(counts[b] - counts[a]) / (b - a) for a, b in zip(ns, ns[1:])]
    lo, hi = min(rates), max(rates)
    # "the same number" within tol of the work per observation (a driver
    # that observes in one vectorized op adds ~0 per observation)
    scale = max(abs(hi), abs(lo), counts[ns[0]] / ns[0])
    if hi - lo > tol * scale:
        return [Finding(
            "trace-size-budget", ERROR, case,
            f"{kind} pass's ops per observation change with len(ts): "
            f"{ {n: counts[n] for n in ns} } gives "
            f"{[round(r, 1) for r in rates]} per added observation "
            f"(> {tol:.0%} apart): a SaveAt driver's work per observation "
            "grows with the number of observations")]
    return []
