"""Composable solve API: solver x gradient x stepping x observation.

The paper's contribution is a *gradient strategy* — the symplectic adjoint —
that composes orthogonally with the solver tableau, the step controller, and
the observation scheme.  One entry point:

    sol = solve(f, x0, params,
                saveat=SaveAt(t1=1.0),
                method="dopri5",
                gradient=SymplecticAdjoint(),
                stepping=AdaptiveConfig(rtol=1e-6, atol=1e-8))
    sol.ys           # the final state, or the observations stacked over
                     # SaveAt(ts=...) (differentiable)
    sol.stats        # n_steps / n_fevals / n_attempts (int32, on the CPU)
    sol.success      # bool tensor on the CPU: the adaptive budgets sufficed
    sol.final_state  # the state at the end of integration

Gradient strategies are frozen dataclasses carrying their own knobs:

    SymplecticAdjoint()                  — the paper: exact gradient,
                                           memory O(N + s + L)    [default]
    DirectBackprop()                     — autograd through the solver:
                                           exact gradient, memory O(N s L)
    RematStep()                          — one rematerialization per step:
                                           exact gradient, memory O(N + s L)
    RematSolve()                         — whole-solve rematerialization:
                                           exact, memory O(N s L) in bwd
    ContinuousAdjoint(steps_multiplier=...,
                      bwd_adaptive=...)  — Chen et al. 2018: approximate
                                           gradient, memory O(L)

Each registers itself in ``GRADIENT_REGISTRY`` under a short name
(``register_gradient``); ``solve`` dispatches purely through the strategy
interface.  Which (stepping, saveat) cells a strategy supports is declared
on the class as ``capabilities``; ``capability_matrix()`` assembles the
table and every illegal combination fails with the same uniformly-shaped
``ValueError``.  The port offers every cell of the JAX package's
``capability_matrix()`` and ``batched_capability_matrix()``.

``SaveAt(ts=...)`` observes the solution at user times: the solve is split
into segments at ``ts`` (ending at ``ts[-1]``), ``ys`` is stacked over the
observations (leading axis len(ts) per leaf) and ``final_state`` is the
last one.  The symplectic adjoint and DirectBackprop thread the adaptive
controller's step across the segment boundaries; the other strategies
chain their plain solves over the segments (``_segmented``), restarting
the controller in every segment.  ``SaveAt(ts=..., dense=True)`` (adaptive
DirectBackprop only) solves once to ``ts[-1]`` and interpolates (cubic
Hermite) at ``ts``.

``stepping`` is either an ``int`` (fixed grid, N equal steps) or an
``AdaptiveConfig`` (PI-controlled adaptive stepping).

``batch_axis=0`` declares the leading axis of every state leaf a batch of
INDEPENDENT trajectories: an adaptive solve then runs masked per-lane step
control (each lane its own error norm, accept/reject and accepted grid) in
one loop, ``stats``/``success`` become per-lane (B,) tensors on the solve's
device, and the symplectic adjoint replays each lane's own grid, so the
batched gradient equals the sum of single-lane gradients to rounding
(``batched_capability_matrix()`` declares the cells).  The field is then
evaluated once per stage over all lanes through ``torch.func.vmap``: it
must be ``torch.func``-safe (no ``requires_grad_``/``autograd.grad`` inside;
``torch.func.vjp`` is fine).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, ClassVar, Dict, FrozenSet, Optional, Tuple, Type,
                    Union)

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .adjoint import (odeint_adjoint, odeint_adjoint_adaptive,
                      odeint_adjoint_adaptive_batched)
from .backprop import odeint_backprop, odeint_remat_solve, odeint_remat_step
from .combine import resolve_backend
from .rk import (AdaptiveConfig, VectorField, apply_on_failure,
                 apply_on_failure_lanes, counters, hermite_observe,
                 lane_count,
                 rk_solve_adaptive, rk_solve_adaptive_batched,
                 rk_solve_adaptive_batched_saveat_stacked,
                 rk_solve_adaptive_saveat_stacked, segment_starts,
                 segment_stats, tree_stack)
from .stepper import time_dtype
from .symplectic import (odeint_symplectic, odeint_symplectic_adaptive,
                         odeint_symplectic_adaptive_batched,
                         odeint_symplectic_saveat,
                         odeint_symplectic_saveat_adaptive,
                         odeint_symplectic_saveat_adaptive_batched)
from .tableau import ButcherTableau, get_tableau

Pytree = Any

STEPPING_KINDS = ("fixed", "adaptive")
SAVEAT_KINDS = ("t1", "ts", "dense")


# ---------------------------------------------------------------------------
# SaveAt: what to observe
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SaveAt:
    """Observation scheme: exactly one of ``t1`` (final state) or ``ts``
    (stacked observations; the solve ends at ``ts[-1]``).

    ``dense=True`` selects Hermite dense-output interpolation at ``ts``
    instead of checkpointed segmentation (adaptive solves only; the step
    controller never sees the observation times)."""
    t1: Optional[Any] = None
    ts: Optional[Any] = None
    dense: bool = False

    def __post_init__(self):
        if self.t1 is not None and self.ts is not None:
            raise ValueError(
                "pass EITHER t1 or ts: with observation times the solve "
                "ends at ts[-1] (include the end time in ts)")
        if self.t1 is None and self.ts is None:
            raise ValueError("SaveAt needs one of t1=... or ts=...")
        if self.dense and self.ts is None:
            raise ValueError("SaveAt(dense=True) needs observation times "
                             "ts=..., not t1")

    @property
    def kind(self) -> str:
        if self.ts is None:
            return "t1"
        return "dense" if self.dense else "ts"


def _as_ts(ts, dtype: torch.dtype, device, t0=None) -> torch.Tensor:
    """Validate and coerce observation times to a 1-D ``dtype`` tensor on
    ``device``.  Duplicates are legal zero-length segments; descending ts
    is legal reverse-time integration, but the direction must be
    consistent across [t0, ts[0], ..., ts[-1]]."""
    if not isinstance(ts, torch.Tensor):
        # Python floats go through float64, not torch's float32 default
        ts = np.asarray(ts, dtype=np.float64)
    ts = torch.as_tensor(ts).to(dtype=dtype, device=device)
    if ts.dim() != 1 or ts.shape[0] == 0:
        raise ValueError("ts must be a non-empty 1-D array of observation "
                         f"times; got shape {tuple(ts.shape)}")
    seq = ts.detach().cpu().numpy()
    if t0 is not None:
        t0 = np.asarray(t0.detach().cpu() if isinstance(t0, torch.Tensor)
                        else t0, dtype=seq.dtype)
        seq = np.concatenate([np.reshape(t0, (1,)), seq])
    d = np.diff(seq)
    if not (np.all(d >= 0) or np.all(d <= 0)):
        raise ValueError(
            "ts must be monotone in the direction of integration "
            "(duplicates are allowed; descending ts is reverse-time); "
            f"got t0={None if t0 is None else t0} "
            f"ts={ts.detach().cpu().numpy()}")
    return ts


# ---------------------------------------------------------------------------
# Solution: the one return shape
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Solution:
    """Result of ``solve``.

    ys          — the observed solution: stacked over ``SaveAt.ts``
                  (leading axis len(ts) per leaf) or the final state for
                  ``SaveAt.t1``.  Differentiable under the selected
                  gradient strategy.
    final_state — the state at the end of integration (== ``ys`` for t1;
                  the last observation for ts).
    stats       — {"n_steps", "n_fevals", "n_attempts"}: int32 scalars on
                  the CPU (the controller decides on the host).  Exact
                  static counts on fixed grids; the controller's realized
                  counters on adaptive solves.  Per-lane (B,) int32 tensors
                  on the solve's device under ``batch_axis=0``.  Never
                  differentiated.
    success     — bool scalar on the CPU: the solve reached its target
                  time within the adaptive budgets (always True on fixed
                  grids).  Per-lane (B,) on the solve's device under
                  ``batch_axis=0``: one lane failing does not flag (or
                  poison) its batchmates.
    """
    ys: Pytree
    final_state: Pytree
    stats: Dict[str, torch.Tensor]
    success: torch.Tensor


# ---------------------------------------------------------------------------
# Gradient strategies
# ---------------------------------------------------------------------------

class _Ctx:
    """Static per-solve context handed to every strategy hook."""
    __slots__ = ("f", "tab", "n_steps", "adaptive", "backend")

    def __init__(self, f: VectorField, tab: ButcherTableau,
                 n_steps: Optional[int], adaptive: Optional[AdaptiveConfig],
                 backend: str):
        self.f = f
        self.tab = tab
        self.n_steps = n_steps
        self.adaptive = adaptive
        self.backend = backend


_FIXED_T1 = ("fixed", "t1")
_FIXED_TS = ("fixed", "ts")
_ADAPT_T1 = ("adaptive", "t1")
_ADAPT_TS = ("adaptive", "ts")
_ADAPT_DENSE = ("adaptive", "dense")


def _stats(n_steps: int, n_fevals: int, n_attempts: int, success: bool):
    return ({"n_steps": torch.tensor(n_steps, dtype=torch.int32),
             "n_fevals": torch.tensor(n_fevals, dtype=torch.int32),
             "n_attempts": torch.tensor(n_attempts, dtype=torch.int32)},
            torch.tensor(bool(success)))


def _segmented(solve_one, x0, t0, ts):
    """Generic SaveAt segmentation: chain per-segment solves (a Python loop
    over the segments), stacking the segment endpoints; autograd injects
    the observation cotangents at the boundaries through the composition.
    ``solve_one(x, a, b)`` returns (end state, *extras); returns (obs, the
    list of each segment's extras)."""
    x, out, extras = x0, [], []
    for a, b in zip(segment_starts(t0, ts), ts):
        x, *rest = solve_one(x, a, b)
        out.append(x)
        extras.append(rest)
    return tree_stack(out), extras


class GradientStrategy:
    """Base class for gradient strategies.

    A strategy declares its legal (stepping, saveat) cells in
    ``capabilities`` and implements the hook of each stepping it claims:
    ``fixed`` (the final state) and ``adaptive_with_stats`` (the final
    state, the stats and the success flag of ONE controller run).  The
    adaptive cells it also offers under ``batch_axis=0`` go in
    ``batched_capabilities``, with the hook ``adaptive_batched_with_stats``
    (per-lane stats and success).  The SaveAt hooks default to the generic
    segmentation over those (the adaptive controller restarts in every
    segment; the stats are summed over the segments of the same run), so a
    strategy overrides them only to do better.  Register it with
    ``@register_gradient``; ``solve`` needs no edits.
    """
    name: ClassVar[str]
    capabilities: ClassVar[FrozenSet[Tuple[str, str]]]
    # adaptive cells ALSO legal under ``solve(..., batch_axis=0)``: cells
    # for which the strategy has a masked per-lane batched driver.  Fixed
    # cells never appear here: a fixed grid does not depend on the state,
    # so every claimed fixed cell batches for free (``batched_cells``).
    batched_capabilities: ClassVar[FrozenSet[Tuple[str, str]]] = frozenset()

    @classmethod
    def batched_cells(cls) -> FrozenSet[Tuple[str, str]]:
        """(stepping, saveat) cells legal with ``batch_axis=0``: every fixed
        cell the strategy claims plus its ``batched_capabilities``."""
        fixed = frozenset(c for c in cls.capabilities if c[0] == "fixed")
        return fixed | cls.batched_capabilities

    def fixed(self, ctx: _Ctx, x0, t0, t1, params):
        raise NotImplementedError

    def adaptive_with_stats(self, ctx: _Ctx, x0, t0, t1, params):
        raise NotImplementedError

    def adaptive_batched_with_stats(self, ctx: _Ctx, x0, t0, t1, params):
        raise NotImplementedError

    # -- SaveAt hooks: observations stacked over ts --------------------------
    def fixed_saveat(self, ctx: _Ctx, x0, t0, ts, params):
        return _segmented(
            lambda x, a, b: (self.fixed(ctx, x, a, b, params),),
            x0, t0, ts)[0]

    def adaptive_saveat_with_stats(self, ctx: _Ctx, x0, t0, ts, params):
        obs, per_segment = _segmented(
            lambda x, a, b: self.adaptive_with_stats(ctx, x, a, b, params),
            x0, t0, ts)
        return (obs, *segment_stats(per_segment))

    def adaptive_saveat_batched_with_stats(self, ctx: _Ctx, x0, t0, ts,
                                           params):
        obs, per_segment = _segmented(
            lambda x, a, b: self.adaptive_batched_with_stats(
                ctx, x, a, b, params), x0, t0, ts)
        return (obs, *segment_stats(per_segment))

    def dense_saveat_with_stats(self, ctx: _Ctx, x0, t0, ts, params):
        """Dense-output observation: (ys, stats, success).  Unreachable
        unless the strategy claims ('adaptive', 'dense')."""
        raise NotImplementedError


GRADIENT_REGISTRY: Dict[str, Type[GradientStrategy]] = {}


def register_gradient(cls: Type[GradientStrategy]) -> Type[GradientStrategy]:
    """Class decorator: register a strategy under ``cls.name``."""
    GRADIENT_REGISTRY[cls.name] = cls
    return cls


def as_gradient(spec: Union[str, GradientStrategy,
                            Type[GradientStrategy]]) -> GradientStrategy:
    """Coerce a strategy instance / class / registered name to an instance."""
    if isinstance(spec, GradientStrategy):
        return spec
    if isinstance(spec, type) and issubclass(spec, GradientStrategy):
        return spec()
    if isinstance(spec, str):
        if spec not in GRADIENT_REGISTRY:
            raise ValueError(
                f"unknown gradient strategy {spec!r}; registered strategies: "
                f"{sorted(GRADIENT_REGISTRY)}")
        return GRADIENT_REGISTRY[spec]()
    raise TypeError(
        "gradient must be a GradientStrategy instance, a GradientStrategy "
        f"subclass, or a registered name; got {type(spec).__name__}")


@register_gradient
@dataclasses.dataclass(frozen=True)
class SymplecticAdjoint(GradientStrategy):
    """The paper's method: exact gradient of the discrete forward map with
    O(N + s + L) memory (Algorithm 2 backward from per-step checkpoints)."""
    name: ClassVar[str] = "symplectic"
    capabilities: ClassVar[FrozenSet] = frozenset(
        {_FIXED_T1, _FIXED_TS, _ADAPT_T1, _ADAPT_TS})
    batched_capabilities: ClassVar[FrozenSet] = frozenset(
        {_ADAPT_T1, _ADAPT_TS})

    def fixed(self, ctx, x0, t0, t1, params):
        return odeint_symplectic(ctx.f, ctx.tab, ctx.n_steps, ctx.backend,
                                 x0, t0, t1, params)

    # the forward of the autograd.Function IS the controller: value and
    # stats come from one run, no replay.
    def adaptive_with_stats(self, ctx, x0, t0, t1, params):
        ys, st, ok = odeint_symplectic_adaptive(
            ctx.f, ctx.tab, ctx.adaptive, ctx.backend, x0, t0, t1, params)
        return (ys, *_stats(st["n_steps"], st["n_fevals"],
                            st["n_attempts"], ok))

    # batched: exact per-lane gradients replaying each lane's own grid
    def adaptive_batched_with_stats(self, ctx, x0, t0, t1, params):
        return odeint_symplectic_adaptive_batched(
            ctx.f, ctx.tab, ctx.adaptive, ctx.backend, x0, t0, t1, params)

    # SaveAt: one autograd.Function over all segments, the controller's
    # step threaded across the boundaries
    def fixed_saveat(self, ctx, x0, t0, ts, params):
        return odeint_symplectic_saveat(ctx.f, ctx.tab, ctx.n_steps,
                                        ctx.backend, x0, t0, ts, params)

    def adaptive_saveat_with_stats(self, ctx, x0, t0, ts, params):
        ys, st, ok = odeint_symplectic_saveat_adaptive(
            ctx.f, ctx.tab, ctx.adaptive, ctx.backend, x0, t0, ts, params)
        return (ys, *_stats(st["n_steps"], st["n_fevals"],
                            st["n_attempts"], ok))

    def adaptive_saveat_batched_with_stats(self, ctx, x0, t0, ts, params):
        return odeint_symplectic_saveat_adaptive_batched(
            ctx.f, ctx.tab, ctx.adaptive, ctx.backend, x0, t0, ts, params)


@register_gradient
@dataclasses.dataclass(frozen=True)
class DirectBackprop(GradientStrategy):
    """Differentiate through the solver (exact; memory O(N s L)).  On an
    adaptive solve the accepted grid is data: the gradient is that of the
    realized discrete map, as the symplectic adjoint's."""
    name: ClassVar[str] = "backprop"
    capabilities: ClassVar[FrozenSet] = frozenset(
        {_FIXED_T1, _FIXED_TS, _ADAPT_T1, _ADAPT_TS, _ADAPT_DENSE})
    batched_capabilities: ClassVar[FrozenSet] = frozenset(
        {_ADAPT_T1, _ADAPT_TS})

    def fixed(self, ctx, x0, t0, t1, params):
        return odeint_backprop(ctx.f, ctx.tab, ctx.n_steps, x0, t0, t1,
                               params, ctx.backend)

    # autograd runs through the controller's own solve: value and stats
    # come from one run.
    def adaptive_with_stats(self, ctx, x0, t0, t1, params):
        sol = rk_solve_adaptive(ctx.f, ctx.tab, x0, t0, t1, params,
                                ctx.adaptive, ctx.backend)
        ys = apply_on_failure(sol.x_final, sol.succeeded,
                              ctx.adaptive.on_failure)
        return (ys, *_stats(sol.n_accepted, sol.n_fevals, sol.n_attempts,
                            sol.succeeded))

    def adaptive_batched_with_stats(self, ctx, x0, t0, t1, params):
        sol = rk_solve_adaptive_batched(ctx.f, ctx.tab, x0, t0, t1, params,
                                        ctx.adaptive, ctx.backend)
        ys = apply_on_failure_lanes(sol.x_final, sol.succeeded,
                                    ctx.adaptive.on_failure)
        return (ys, *counters(sol))

    # SaveAt: autograd through the threaded segmented solve; value and
    # stats from its one run
    def adaptive_saveat_with_stats(self, ctx, x0, t0, ts, params):
        obs, sols = rk_solve_adaptive_saveat_stacked(
            ctx.f, ctx.tab, x0, t0, ts, params, ctx.adaptive, ctx.backend)
        st, ok = segment_stats(map(counters, sols))
        return (obs, *_stats(st["n_steps"], st["n_fevals"],
                             st["n_attempts"], ok))

    def adaptive_saveat_batched_with_stats(self, ctx, x0, t0, ts, params):
        obs, sols = rk_solve_adaptive_batched_saveat_stacked(
            ctx.f, ctx.tab, x0, t0, ts, params, ctx.adaptive, ctx.backend)
        return (obs, *segment_stats(map(counters, sols)))

    def dense_saveat_with_stats(self, ctx, x0, t0, ts, params):
        # ONE unsegmented solve + Hermite interpolation: value and stats
        # from the same controller run (2 extra f-evals per observation
        # for the endpoint slopes)
        cfg = ctx.adaptive
        sol = rk_solve_adaptive(ctx.f, ctx.tab, x0, t0, ts[-1], params,
                                cfg, ctx.backend)
        obs = hermite_observe(ctx.f, ctx.tab, sol, params, ts, ctx.backend)
        ys = apply_on_failure(obs, sol.succeeded, cfg.on_failure)
        return (ys, *_stats(sol.n_accepted,
                            sol.n_fevals + 2 * ts.shape[0],
                            sol.n_attempts, sol.succeeded))


@register_gradient
@dataclasses.dataclass(frozen=True)
class RematStep(GradientStrategy):
    """ANODE/ACA-style per-step rematerialization (exact; O(N + s L))."""
    name: ClassVar[str] = "remat_step"
    capabilities: ClassVar[FrozenSet] = frozenset({_FIXED_T1, _FIXED_TS})

    def fixed(self, ctx, x0, t0, t1, params):
        return odeint_remat_step(ctx.f, ctx.tab, ctx.n_steps, x0, t0, t1,
                                 params, ctx.backend)


@register_gradient
@dataclasses.dataclass(frozen=True)
class RematSolve(GradientStrategy):
    """Whole-solve rematerialization, the paper's baseline scheme (exact;
    O(M) after the forward, O(N s L) inside the backward)."""
    name: ClassVar[str] = "remat_solve"
    capabilities: ClassVar[FrozenSet] = frozenset({_FIXED_T1, _FIXED_TS})

    def fixed(self, ctx, x0, t0, t1, params):
        return odeint_remat_solve(ctx.f, ctx.tab, ctx.n_steps, x0, t0, t1,
                                  params, ctx.backend)


@register_gradient
@dataclasses.dataclass(frozen=True)
class ContinuousAdjoint(GradientStrategy):
    """Chen et al. 2018 continuous adjoint: O(L) memory, approximate
    gradient (O(h^p) backward-integration error).

    steps_multiplier — fixed-grid backward solves take
                       ``n_steps * steps_multiplier`` steps (must be >= 1:
                       a zero-step backward solve silently returns garbage
                       gradients).
    bwd_adaptive     — controller for the adaptive backward solve of the
                       augmented system (defaults to the forward config).
    """
    name: ClassVar[str] = "adjoint"
    capabilities: ClassVar[FrozenSet] = frozenset(
        {_FIXED_T1, _FIXED_TS, _ADAPT_T1, _ADAPT_TS})
    batched_capabilities: ClassVar[FrozenSet] = frozenset(
        {_ADAPT_T1, _ADAPT_TS})

    steps_multiplier: int = 1
    bwd_adaptive: Optional[AdaptiveConfig] = None

    def __post_init__(self):
        if not isinstance(self.steps_multiplier, (int, np.integer)) \
                or isinstance(self.steps_multiplier, bool) \
                or self.steps_multiplier < 1:
            raise ValueError(
                "ContinuousAdjoint.steps_multiplier must be an int >= 1 "
                "(a zero-step backward solve returns garbage gradients); "
                f"got {self.steps_multiplier!r}")
        object.__setattr__(self, "steps_multiplier",
                           int(self.steps_multiplier))

    def fixed(self, ctx, x0, t0, t1, params):
        return odeint_adjoint(ctx.f, ctx.tab, ctx.n_steps,
                              self.steps_multiplier, ctx.backend,
                              x0, t0, t1, params)

    # value and stats come from the forward's one controller run
    def adaptive_with_stats(self, ctx, x0, t0, t1, params):
        ys, st, ok = odeint_adjoint_adaptive(
            ctx.f, ctx.tab, ctx.adaptive, self.bwd_adaptive or ctx.adaptive,
            ctx.backend, x0, t0, t1, params)
        return (ys, *_stats(st["n_steps"], st["n_fevals"],
                            st["n_attempts"], ok))

    # per-lane forward AND backward grids; the backward augmented state
    # carries a per-lane parameter-gradient accumulator: O(B L) memory
    def adaptive_batched_with_stats(self, ctx, x0, t0, t1, params):
        return odeint_adjoint_adaptive_batched(
            ctx.f, ctx.tab, ctx.adaptive, self.bwd_adaptive or ctx.adaptive,
            ctx.backend, x0, t0, t1, params)
    # SaveAt value AND stats both come from the base class (batched and
    # not): the generic segmentation restarts the controller per segment.


# ---------------------------------------------------------------------------
# Capability matrix
# ---------------------------------------------------------------------------

def capability_matrix() -> Dict[str, Dict[Tuple[str, str], bool]]:
    """The declarative (gradient x stepping x saveat) legality table,
    assembled from the registered strategies."""
    return {name: {(sk, vk): (sk, vk) in cls.capabilities
                   for sk in STEPPING_KINDS for vk in SAVEAT_KINDS}
            for name, cls in sorted(GRADIENT_REGISTRY.items())}


def batched_capability_matrix() -> Dict[str, Dict[Tuple[str, str], bool]]:
    """The same table for ``solve(..., batch_axis=0)``: every fixed cell a
    strategy claims, plus its declared batched adaptive cells."""
    return {name: {(sk, vk): (sk, vk) in cls.batched_cells()
                   for sk in STEPPING_KINDS for vk in SAVEAT_KINDS}
            for name, cls in sorted(GRADIENT_REGISTRY.items())}


def mesh_capability_matrix() -> Dict[str, Dict[Tuple[str, str], bool]]:
    """The same table for ``solve(..., batch_axis=0, mesh=...)``: the
    batched cells restricted to t1|ts saveat.  The mesh path runs the SAME
    batched hooks (``fixed``/``fixed_saveat``/``adaptive_*_with_stats``) on
    each rank's lane block, so every batched t1/ts cell is mesh-legal;
    dense output is not wired through it."""
    return {name: {cell: ok and cell[1] in ("t1", "ts")
                   for cell, ok in cells.items()}
            for name, cells in batched_capability_matrix().items()}


def _check_capability(gradient: GradientStrategy, stepping_kind: str,
                      saveat_kind: str, batched: bool = False) -> None:
    cells = (type(gradient).batched_cells() if batched
             else type(gradient).capabilities)
    if (stepping_kind, saveat_kind) in cells:
        return
    name = type(gradient).name
    legal = ", ".join(f"{sk}+{vk}" for sk, vk in sorted(cells))
    where = " with batch_axis=0" if batched else ""
    raise ValueError(
        f"gradient {name!r} does not support stepping={stepping_kind!r} "
        f"with saveat={saveat_kind!r}{where}; legal (stepping+saveat) "
        f"combinations for {name!r}{where}: {legal}.")


# ---------------------------------------------------------------------------
# solve
# ---------------------------------------------------------------------------

def _fixed_stats(tab: ButcherTableau, n_steps: int, n_segments: int,
                 lanes: Optional[int] = None, device=None):
    """Fixed-grid stats are exact static counts: the drivers skip the
    embedded error estimate, so the cost is exactly s f-evals per step.
    With ``lanes`` (batch_axis=0) the counts are per lane, on ``device``:
    every lane takes the same grid."""
    total = n_segments * n_steps
    if lanes is None:
        return _stats(total, total * tab.s, total, True)

    def full(v):
        return torch.full((lanes,), v, dtype=torch.int32, device=device)

    return ({"n_steps": full(total), "n_fevals": full(total * tab.s),
             "n_attempts": full(total)},
            torch.ones(lanes, dtype=torch.bool, device=device))


def solve(f: VectorField, x0, params, *,
          saveat: Optional[SaveAt] = None,
          method: Union[str, ButcherTableau] = "dopri5",
          gradient: Union[str, GradientStrategy, None] = None,
          stepping: Union[int, AdaptiveConfig] = 16,
          backend: str = "auto",
          t0=0.0,
          batch_axis: Optional[int] = None,
          mesh=None,
          sharding=None) -> Solution:
    """Integrate ``dx/dt = f(x, t, params)`` and return a ``Solution``.

    f          — vector field over pytrees of tensors; times are not
                 differentiated, matching the paper's fixed-T setting.
    x0, params — pytrees of tensors, all on one device (the solve runs
                 there).
    saveat     — observation scheme (default ``SaveAt(t1=1.0)``); the
                 observation times are cast to the time dtype of the
                 state (float64 if any leaf is, else float32).
    method     — tableau name or a ``ButcherTableau``.
    gradient   — a ``GradientStrategy`` (or registered name; default
                 ``SymplecticAdjoint()``).
    stepping   — int N (fixed grid; N steps per observation segment) or
                 an ``AdaptiveConfig`` (``max_steps`` per segment).
    backend    — stage-combine dispatch: auto | torch | cuda
                 (core/combine.py).
    t0         — start time (keyword; default 0).
    batch_axis — None (default): ONE trajectory; a leading batch axis in
                 the state is part of that trajectory, so an adaptive
                 controller pools its error norm over the whole batch
                 (lockstep).  0: the leading axis of every state leaf
                 indexes B INDEPENDENT trajectories (masked per-lane step
                 control; per-lane (B,) stats and success).  Only axis 0.
    mesh       — a ``DeviceMesh`` over the running process group: each rank
                 solves its contiguous block of lanes over the mesh's data
                 axes (the longest divisible prefix of ("pod", "data")),
                 SPMD.  Requires ``batch_axis=0`` and saveat t1|ts.  ``x0``
                 is a DTensor sharded on axis 0 over those axes, or a full
                 tensor every rank holds (each takes its block, no
                 communication).  The forward makes no collective; the
                 backward makes one all_reduce per parameter leaf.  ``ys``,
                 ``stats`` and ``success`` are DTensors on the lane axis,
                 and ``stats`` gains ``shard_steps`` / ``load_imbalance``
                 (``repro_torch.parallel.solve``).
    sharding   — params placement under ``mesh``: None (replicated,
                 default), ``"auto"`` (``repro_torch.parallel`` path
                 rules), or an explicit per-leaf tree of specs.
    """
    tab = get_tableau(method) if isinstance(method, str) else method
    resolve_backend(backend)  # eager validation, single source
    gradient = as_gradient("symplectic" if gradient is None else gradient)
    saveat = SaveAt(t1=1.0) if saveat is None else saveat
    if batch_axis is not None and batch_axis != 0:
        raise ValueError(
            f"batch_axis={batch_axis!r}: only the leading axis "
            "(batch_axis=0) is supported — move the trajectory axis of "
            "every state leaf to axis 0")
    batched = batch_axis is not None
    lanes = lane_count(x0) if batched else None

    if isinstance(stepping, AdaptiveConfig):
        stepping_kind, n_steps, adaptive = "adaptive", None, stepping
    elif isinstance(stepping, (int, np.integer)) \
            and not isinstance(stepping, bool):
        if stepping < 1:
            raise ValueError(
                f"stepping={stepping}: a fixed-grid solve needs >= 1 steps")
        stepping_kind, n_steps, adaptive = "fixed", int(stepping), None
    else:
        raise TypeError(
            "stepping must be an int (fixed-grid step count) or an "
            f"AdaptiveConfig; got {type(stepping).__name__}")

    _check_capability(gradient, stepping_kind, saveat.kind, batched)
    ctx = _Ctx(f, tab, n_steps, adaptive, backend)
    if mesh is None and sharding is not None:
        raise ValueError("solve(sharding=...) requires mesh=: the params "
                         "placement only means something on a mesh")
    if mesh is not None:
        if not batched:
            raise ValueError(
                "solve(mesh=...) shards the lane axis over the mesh's data "
                "axes: pass batch_axis=0 (a single trajectory has no lane "
                "axis to shard)")
        return _solve_sharded(gradient, ctx, tab, n_steps, stepping_kind,
                              saveat, x0, t0, params, lanes, mesh, sharding)
    device = pytree.tree_leaves(x0)[0].device
    if saveat.kind == "t1":
        if stepping_kind == "fixed":
            # the fixed grid does not depend on the state: the plain driver
            # IS the per-lane solve, only the stats' shapes change
            ys = gradient.fixed(ctx, x0, t0, saveat.t1, params)
            stats, success = _fixed_stats(tab, n_steps, 1, lanes, device)
        elif batched:
            ys, stats, success = gradient.adaptive_batched_with_stats(
                ctx, x0, t0, saveat.t1, params)
        else:
            ys, stats, success = gradient.adaptive_with_stats(
                ctx, x0, t0, saveat.t1, params)
        return Solution(ys=ys, final_state=ys, stats=stats, success=success)

    ts = _as_ts(saveat.ts, time_dtype(x0), device, t0)
    if saveat.kind == "dense":
        ys, stats, success = gradient.dense_saveat_with_stats(
            ctx, x0, t0, ts, params)
    elif stepping_kind == "fixed":
        ys = gradient.fixed_saveat(ctx, x0, t0, ts, params)
        stats, success = _fixed_stats(tab, n_steps, ts.shape[0], lanes,
                                      device)
    elif batched:
        ys, stats, success = gradient.adaptive_saveat_batched_with_stats(
            ctx, x0, t0, ts, params)
    else:
        ys, stats, success = gradient.adaptive_saveat_with_stats(
            ctx, x0, t0, ts, params)
    final = pytree.tree_map(lambda l: l[-1], ys)
    return Solution(ys=ys, final_state=final, stats=stats, success=success)


def _solve_sharded(gradient: GradientStrategy, ctx: _Ctx,
                   tab: ButcherTableau, n_steps: Optional[int],
                   stepping_kind: str, saveat: SaveAt, x0, t0, params,
                   lanes: int, mesh, sharding) -> Solution:
    """The mesh path of ``solve``: the SAME dispatch as the unsharded
    batched solve, run by every rank on its contiguous lane block exactly
    as a single-process call would (bitwise: values, per-lane stats, grids,
    h carries).  It lives here so that the dispatch stays next to the
    unsharded branch it must mirror; the mesh mechanics (lane axes,
    placements, the cotangent reductions, load stats) come from
    ``repro_torch.parallel.solve``."""
    from ..parallel import solve as _pps  # parallel imports core: lazy
    axes = _pps.lane_axes(mesh, lanes, require=True)
    n_shards = _pps.shard_count(mesh, axes)
    lanes_local = lanes // n_shards
    pspec = _pps.resolve_param_specs(params, mesh, sharding)

    def device_of(x):
        leaf = pytree.tree_leaves(x)[0]
        return leaf.device

    if saveat.kind == "t1":
        if stepping_kind == "fixed":
            def body(x0_, params_):
                ys = gradient.fixed(ctx, x0_, t0, saveat.t1, params_)
                return (ys, *_fixed_stats(tab, n_steps, 1, lanes_local,
                                          device_of(x0_)))
        else:
            def body(x0_, params_):
                return gradient.adaptive_batched_with_stats(
                    ctx, x0_, t0, saveat.t1, params_)
        ys, stats, success = _pps.sharded_solve_triple(
            body, mesh, axes, x0, params, params_spec=pspec, ys_lane_axis=0)
        stats = _pps.with_shard_load_stats(stats, n_shards)
        return Solution(ys=ys, final_state=ys, stats=stats, success=success)

    if saveat.kind != "ts":
        # unreachable today (_check_capability rejects batched dense), but
        # the mesh path must never fall through to a new kind
        raise ValueError(
            f"solve(mesh=...) supports saveat t1|ts; got {saveat.kind!r}")

    def times(x0_):
        return _as_ts(saveat.ts, time_dtype(x0_), device_of(x0_), t0)

    if stepping_kind == "fixed":
        def body(x0_, params_):
            ts = times(x0_)
            ys = gradient.fixed_saveat(ctx, x0_, t0, ts, params_)
            return (ys, *_fixed_stats(tab, n_steps, ts.shape[0],
                                      lanes_local, device_of(x0_)))
    else:
        def body(x0_, params_):
            return gradient.adaptive_saveat_batched_with_stats(
                ctx, x0_, t0, times(x0_), params_)
    # SaveAt stacks are time-major: lanes live on axis 1 of the ys leaves
    ys, stats, success = _pps.sharded_solve_triple(
        body, mesh, axes, x0, params, params_spec=pspec, ys_lane_axis=1)
    stats = _pps.with_shard_load_stats(stats, n_shards)
    # the last observation, from the local blocks (lanes on axis 0)
    lane = _pps.lane_spec(mesh, axes)
    final = pytree.tree_map(
        lambda l: _pps.from_local(l.to_local()[-1], mesh, lane), ys)
    return Solution(ys=ys, final_state=final, stats=stats, success=success)
