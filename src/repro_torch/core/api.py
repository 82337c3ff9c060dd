"""Composable solve API: solver x gradient x stepping x observation.

The paper's contribution is a *gradient strategy* — the symplectic adjoint —
that composes orthogonally with the solver tableau, the step controller, and
the observation scheme.  One entry point:

    sol = solve(f, x0, params,
                saveat=SaveAt(t1=1.0),
                method="dopri5",
                gradient=SymplecticAdjoint(),
                stepping=AdaptiveConfig(rtol=1e-6, atol=1e-8))
    sol.ys           # the final state (differentiable)
    sol.stats        # n_steps / n_fevals / n_attempts (int32, on the CPU)
    sol.success      # bool tensor on the CPU: the adaptive budgets sufficed
    sol.final_state  # the state at the end of integration

Gradient strategies are frozen dataclasses:

    SymplecticAdjoint()  — the paper: exact gradient, memory O(N + s + L)
                                                                  [default]
    DirectBackprop()     — autograd through the solver: exact gradient,
                           memory O(N s L)

Each registers itself in ``GRADIENT_REGISTRY`` under a short name
(``register_gradient``); ``solve`` dispatches purely through the strategy
interface.  Which (stepping, saveat) cells a strategy supports is declared
on the class as ``capabilities``; ``capability_matrix()`` assembles the
table and every illegal combination fails with the same uniformly-shaped
``ValueError``.  The port offers a subset of the JAX package's cells: the
t1 cells of these two strategies.  What is not ported yet raises a
``ValueError`` that names its ROADMAP item: the strategies ``remat_step``,
``remat_solve`` and ``adjoint`` (queue 1 item 7), ``SaveAt(ts=...)`` and
dense output (item 9), and ``batch_axis=0`` (item 10).

``stepping`` is either an ``int`` (fixed grid, N equal steps) or an
``AdaptiveConfig`` (PI-controlled adaptive stepping).
"""
from __future__ import annotations

import dataclasses
from typing import (Any, ClassVar, Dict, FrozenSet, Optional, Tuple, Type,
                    Union)

import numpy as np
import torch

from .backprop import odeint_backprop
from .combine import resolve_backend
from .rk import AdaptiveConfig, VectorField, apply_on_failure, \
    rk_solve_adaptive
from .symplectic import odeint_symplectic, odeint_symplectic_adaptive
from .tableau import ButcherTableau, get_tableau

Pytree = Any

STEPPING_KINDS = ("fixed", "adaptive")
SAVEAT_KINDS = ("t1", "ts", "dense")

# Parts of the JAX package's solve() that this package does not have yet,
# and the ROADMAP item (queue 1) that ports each.
NOT_PORTED = {
    "remat_step": "ROADMAP queue 1 item 7",
    "remat_solve": "ROADMAP queue 1 item 7",
    "adjoint": "ROADMAP queue 1 item 7",
    "ts": "ROADMAP queue 1 item 9",
    "dense": "ROADMAP queue 1 item 9",
    "batch_axis": "ROADMAP queue 1 item 10",
}


# ---------------------------------------------------------------------------
# SaveAt: what to observe
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SaveAt:
    """Observation scheme: ``t1`` (the final state).  ``ts`` and ``dense``
    mirror the JAX package's fields; ``solve`` rejects them until SaveAt is
    ported (ROADMAP queue 1 item 9)."""
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


# ---------------------------------------------------------------------------
# Solution: the one return shape
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Solution:
    """Result of ``solve``.

    ys          — the final state, differentiable under the selected
                  gradient strategy.
    final_state — the state at the end of integration (== ``ys``).
    stats       — {"n_steps", "n_fevals", "n_attempts"}: int32 scalars on
                  the CPU (the controller decides on the host).  Exact
                  static counts on fixed grids; the controller's realized
                  counters on adaptive solves.  Never differentiated.
    success     — bool scalar on the CPU: the solve reached its target
                  time within the adaptive budgets (always True on fixed
                  grids).
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
_ADAPT_T1 = ("adaptive", "t1")


def _stats(n_steps: int, n_fevals: int, n_attempts: int, success: bool):
    return ({"n_steps": torch.tensor(n_steps, dtype=torch.int32),
             "n_fevals": torch.tensor(n_fevals, dtype=torch.int32),
             "n_attempts": torch.tensor(n_attempts, dtype=torch.int32)},
            torch.tensor(bool(success)))


class GradientStrategy:
    """Base class for gradient strategies.

    A strategy declares its legal (stepping, saveat) cells in
    ``capabilities`` and implements the hook of each stepping it claims:
    ``fixed`` (the final state) and ``adaptive_with_stats`` (the final
    state, the stats and the success flag of ONE controller run).
    Register it with ``@register_gradient``; ``solve`` needs no edits.
    """
    name: ClassVar[str]
    capabilities: ClassVar[FrozenSet[Tuple[str, str]]]

    def fixed(self, ctx: _Ctx, x0, t0, t1, params):
        raise NotImplementedError

    def adaptive_with_stats(self, ctx: _Ctx, x0, t0, t1, params):
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
        if spec in NOT_PORTED:
            raise ValueError(
                f"gradient strategy {spec!r} is not ported to PyTorch yet "
                f"({NOT_PORTED[spec]}); registered strategies: "
                f"{sorted(GRADIENT_REGISTRY)}")
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
    capabilities: ClassVar[FrozenSet] = frozenset({_FIXED_T1, _ADAPT_T1})

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


@register_gradient
@dataclasses.dataclass(frozen=True)
class DirectBackprop(GradientStrategy):
    """Differentiate through the solver (exact; memory O(N s L)).  On an
    adaptive solve the accepted grid is data: the gradient is that of the
    realized discrete map, as the symplectic adjoint's."""
    name: ClassVar[str] = "backprop"
    capabilities: ClassVar[FrozenSet] = frozenset({_FIXED_T1, _ADAPT_T1})

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


# ---------------------------------------------------------------------------
# Capability matrix
# ---------------------------------------------------------------------------

def capability_matrix() -> Dict[str, Dict[Tuple[str, str], bool]]:
    """The declarative (gradient x stepping x saveat) legality table,
    assembled from the registered strategies."""
    return {name: {(sk, vk): (sk, vk) in cls.capabilities
                   for sk in STEPPING_KINDS for vk in SAVEAT_KINDS}
            for name, cls in sorted(GRADIENT_REGISTRY.items())}


def _check_capability(gradient: GradientStrategy, stepping_kind: str,
                      saveat_kind: str) -> None:
    cells = type(gradient).capabilities
    if (stepping_kind, saveat_kind) in cells:
        return
    name = type(gradient).name
    legal = ", ".join(f"{sk}+{vk}" for sk, vk in sorted(cells))
    todo = (f" (saveat={saveat_kind!r} is not ported yet: "
            f"{NOT_PORTED[saveat_kind]})" if saveat_kind in NOT_PORTED
            else "")
    raise ValueError(
        f"gradient {name!r} does not support stepping={stepping_kind!r} "
        f"with saveat={saveat_kind!r}; legal (stepping+saveat) "
        f"combinations for {name!r}: {legal}.{todo}")


# ---------------------------------------------------------------------------
# solve
# ---------------------------------------------------------------------------

def _fixed_stats(tab: ButcherTableau, n_steps: int, n_segments: int):
    """Fixed-grid stats are exact static counts: the drivers skip the
    embedded error estimate, so the cost is exactly s f-evals per step."""
    total = n_segments * n_steps
    return _stats(total, total * tab.s, total, True)


def solve(f: VectorField, x0, params, *,
          saveat: Optional[SaveAt] = None,
          method: Union[str, ButcherTableau] = "dopri5",
          gradient: Union[str, GradientStrategy, None] = None,
          stepping: Union[int, AdaptiveConfig] = 16,
          backend: str = "auto",
          t0=0.0,
          batch_axis: Optional[int] = None) -> Solution:
    """Integrate ``dx/dt = f(x, t, params)`` and return a ``Solution``.

    f          — vector field over pytrees of tensors; times are not
                 differentiated, matching the paper's fixed-T setting.
    x0, params — pytrees of tensors, all on one device (the solve runs
                 there).
    saveat     — observation scheme (default ``SaveAt(t1=1.0)``).
    method     — tableau name or a ``ButcherTableau``.
    gradient   — a ``GradientStrategy`` (or registered name; default
                 ``SymplecticAdjoint()``).
    stepping   — int N (fixed grid) or an ``AdaptiveConfig``.
    backend    — stage-combine dispatch: auto | torch | cuda
                 (core/combine.py).
    t0         — start time (keyword; default 0).
    batch_axis — must be None: per-lane batching is not ported yet.
    """
    tab = get_tableau(method) if isinstance(method, str) else method
    resolve_backend(backend)  # eager validation, single source
    gradient = as_gradient("symplectic" if gradient is None else gradient)
    saveat = SaveAt(t1=1.0) if saveat is None else saveat
    if batch_axis is not None:
        raise ValueError(
            f"batch_axis={batch_axis!r}: per-lane batched solving is not "
            f"ported to PyTorch yet ({NOT_PORTED['batch_axis']})")

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

    _check_capability(gradient, stepping_kind, saveat.kind)
    ctx = _Ctx(f, tab, n_steps, adaptive, backend)
    if stepping_kind == "fixed":
        ys = gradient.fixed(ctx, x0, t0, saveat.t1, params)
        stats, success = _fixed_stats(tab, n_steps, 1)
    else:
        ys, stats, success = gradient.adaptive_with_stats(
            ctx, x0, t0, saveat.t1, params)
    return Solution(ys=ys, final_state=ys, stats=stats, success=success)
