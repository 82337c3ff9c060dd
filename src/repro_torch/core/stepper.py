"""Explicit solver state machine: one step of a driver as a function.

Each driver advances the same small bundle of values: the integration
clock, the state pytree, the controller's step carry, counters, and the
checkpoints {x_n, t_n, h_n} that Algorithm 1 of the paper retains:

    stepper = AdaptiveStepper(f, tab, cfg, combine_backend)
    state   = stepper.init_state(x0, t0, t1)
    state   = stepper.advance(state, params)   # ONE attempted step:
                                               #   trial, accept/reject,
                                               #   commit
    stepper.is_done(state)
    sol     = stepper.finalize(state)          # AdaptiveSolution

Times, h and the error norm are 0-dim tensors on the state's device, in the
time dtype ``time_dtype(x0)`` (float64 when any state leaf is float64, else
float32).  The step controller runs on the host: each attempted step reads
ONE pair of booleans back from the device (accept, and whether the clock is
still short of t1), and the checkpoints are Python lists holding only the
accepted steps.  The controller sees detached values, so the accepted grid
is data to autograd — the gradient of a solve is the gradient of its
realized discrete map (the paper's setting; times are not differentiated).

This module also owns the step-level primitives the steppers are built from
(``rk_step``, ``rk_stages``, the error norm, ``AdaptiveConfig`` and the
solution tuples).  Lane-batched states (``solve(..., batch_axis=0)``) are
not ported yet (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from .combine import (StageCombiner, alloc_stages, append_stage,
                      get_combiner, set_stage)
from .tableau import ButcherTableau

Pytree = Any
VectorField = Callable[[Pytree, torch.Tensor, Pytree], Pytree]
# f(x, t, params) -> dx/dt, pytree-in pytree-out.


def time_dtype(x: Pytree) -> torch.dtype:
    """The dtype of times and step sizes for a state: float64 when any
    floating state leaf is float64, float32 otherwise."""
    dt = torch.float32
    for l in pytree.tree_leaves(x):
        if l.is_floating_point():
            dt = torch.promote_types(dt, l.dtype)
    return dt


def as_time(v, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A 0-dim time tensor on ``device``.  A Python number is written on the
    device by a fill (no host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=device).reshape(())
    return torch.full((), float(v), dtype=dtype, device=device)


def _device_of(x: Pytree) -> torch.device:
    return pytree.tree_leaves(x)[0].device


def _detach(tree: Pytree) -> Pytree:
    return pytree.tree_map(lambda l: l.detach(), tree)


# ---------------------------------------------------------------------------
# One explicit RK step (stage states, slopes, embedded error).
# ---------------------------------------------------------------------------

def rk_stages(f: VectorField, tab: ButcherTableau, x, t, h, params,
              combiner: Optional[StageCombiner] = None):
    """Compute all stage states X_i and slopes k_i for one step.

    Returns (Xs, K): ``Xs`` is a list of s stage-state pytrees, ``K`` the
    stacked slope buffer (leading stage dim s per leaf), a fresh buffer
    whose rows are each written once.  Purely forward; the symplectic
    backward pass re-runs this from a checkpoint (Alg. 2 lines 3-7).
    """
    combiner = combiner or get_combiner(tab)
    s = tab.s
    K = alloc_stages(s, x)
    Xs = []
    for i in range(s):
        Xi = combiner.stage_state(x, K, h, i)
        ki = f(Xi, t + tab.c[i] * h, params)
        set_stage(K, i, ki)
        Xs.append(Xi)
    return Xs, K


def rk_step(f: VectorField, tab: ButcherTableau, x, t, h, params,
            combiner: Optional[StageCombiner] = None,
            with_error: Optional[bool] = None):
    """One explicit RK step: returns (x_next, err_estimate_or_None).

    ``with_error=False`` skips the embedded error estimate (the fixed-grid
    drivers pass it; there is no controller to consume the estimate).  The
    default (None) computes it whenever the tableau has error weights.
    """
    combiner = combiner or get_combiner(tab)
    if with_error is None:
        with_error = tab.b_err is not None
    _, K = rk_stages(f, tab, x, t, h, params, combiner)
    if not (with_error and tab.b_err is not None):
        return combiner.solution(x, K, h), None
    if tab.err_uses_fsal:
        # the error weights reference k_{s+1} = f(x_{n+1}); the solution must
        # come first, then one extra evaluation extends the slope buffer.
        x_next = combiner.solution(x, K, h)
        K_err = append_stage(K, f(x_next, t + h, params))
        return x_next, combiner.error(x, K_err, h)
    # both rows (b, b_err) combine the same s slopes: fuse into ONE pass.
    return combiner.solution_and_error(x, K, h)


# ---------------------------------------------------------------------------
# Adaptive controller pieces.
# ---------------------------------------------------------------------------

ON_FAILURE_POLICIES = ("nan", "ignore", "raise")


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    rtol: float = 1e-6
    atol: float = 1e-8
    max_steps: int = 256          # checkpoint bound (accepted steps)
    max_attempts: int = 4096      # total trial-step bound
    safety: float = 0.9
    min_factor: float = 0.2
    max_factor: float = 10.0
    initial_step: float = 0.01
    # what a solve does with x_final when the controller exits via the
    # max_steps / max_attempts budget without reaching t1:
    #   "nan"    — poison every floating leaf with NaN  [default]
    #   "ignore" — return the truncated state as-is
    #   "raise"  — raise RuntimeError
    on_failure: str = "nan"

    def __post_init__(self):
        if self.on_failure not in ON_FAILURE_POLICIES:
            raise ValueError(f"on_failure {self.on_failure!r} not in "
                             f"{ON_FAILURE_POLICIES}")


def _tol_like(v, leaf):
    """Cast a TENSOR tolerance to the leaf dtype; Python floats pass
    through (they never promote the scale computation)."""
    return v.to(leaf.dtype) if isinstance(v, torch.Tensor) else v


def _error_norm(err, x, x_next, rtol, atol) -> torch.Tensor:
    """RMS of err / (atol + rtol max(|x|, |x_next|)) over all leaves, as a
    0-dim device tensor."""
    leaves = zip(pytree.tree_leaves(err), pytree.tree_leaves(x),
                 pytree.tree_leaves(x_next))
    total, count = 0.0, 0
    for e, a, b in leaves:
        scale = _tol_like(atol, a) \
            + _tol_like(rtol, a) * torch.maximum(a.abs(), b.abs())
        # accumulate in >= f32 but NEVER below the state dtype: an f32 norm
        # quantizes the accept/reject decisions of an f64 solve.
        r = (e / scale).to(torch.promote_types(e.dtype, torch.float32))
        total = total + torch.sum(r * r)
        count += r.numel()
    return torch.sqrt(total / count)


def _time_resolution(t0, t1, dtype):
    """Smallest meaningful |t1 - t| for the termination test: a few ulps of
    max(|t0|, |t1|, |t1 - t0|) in the working dtype."""
    eps = torch.finfo(dtype).eps
    scale = torch.maximum((t1 - t0).abs(),
                          torch.maximum(t0.abs(), t1.abs()))
    return 4.0 * eps * torch.clamp_min(scale, eps)


# ---------------------------------------------------------------------------
# Solution tuples (what finalize() returns).
# ---------------------------------------------------------------------------

class FixedSolution(NamedTuple):
    x_final: Pytree
    xs: List[Pytree]            # checkpoints x_0..x_{N-1}
    ts: List[torch.Tensor]      # t_0..t_{N-1}
    h: torch.Tensor             # scalar step size


class AdaptiveSolution(NamedTuple):
    x_final: Pytree
    xs: List[Pytree]            # accepted checkpoints x_n (n < n_accepted)
    ts: List[torch.Tensor]      # their t_n
    hs: List[torch.Tensor]      # their h_n
    n_accepted: int
    n_fevals: int
    succeeded: bool             # reached t1 within the budgets
    h_final: torch.Tensor       # UNclamped controller step at exit
    n_attempts: int             # total trial steps (acc + rej)


# ---------------------------------------------------------------------------
# SolverState: the full between-steps state of an adaptive solve.
# ---------------------------------------------------------------------------

class SolverState(NamedTuple):
    """Everything an adaptive solve carries between attempted steps.

    t0, t1, t, h — 0-dim device tensors in the time dtype; h is the
                   controller's UNCLAMPED step carry.
    x            — the state pytree.
    n_accepted, n_attempts, n_fevals — controller counters (host ints).
    xs, ts, hs   — the accepted checkpoints of Algorithm 1.
    active       — the host's copy of "the solve goes on": the clock is
                   short of t1, the budgets are not spent, and h is finite.
    """
    t0: torch.Tensor
    t1: torch.Tensor
    t: torch.Tensor
    x: Pytree
    h: torch.Tensor
    n_accepted: int
    n_attempts: int
    n_fevals: int
    xs: List[Pytree]
    ts: List[torch.Tensor]
    hs: List[torch.Tensor]
    active: bool


@dataclasses.dataclass(frozen=True)
class AdaptiveStepper:
    """The PI-controlled adaptive solver as an explicit state machine.

    Controller rules: each trial uses h_eff = min(|h|, |t1 - t|) so the
    solve lands exactly on t1, but the carried h stays unclamped — an
    accepted clamped step keeps h, a rejected one retries from h * factor —
    so a tiny landing step cannot collapse the step size; termination uses
    a dtype-aware resolution of t1; a non-finite h ends the solve.
    """
    f: VectorField
    tab: ButcherTableau
    cfg: AdaptiveConfig
    combine_backend: str = "auto"

    def __post_init__(self):
        if self.tab.b_err is None:
            raise ValueError(
                f"tableau {self.tab.name} has no embedded error estimate")

    @property
    def combiner(self) -> StageCombiner:
        return get_combiner(self.tab, self.combine_backend)

    # -- lifecycle ----------------------------------------------------------
    def init_state(self, x0, t0, t1, h0=None) -> SolverState:
        """Fresh state at t0.  ``h0`` seeds the controller with a step
        MAGNITUDE, falling back to ``cfg.initial_step`` when absent or
        zero."""
        cfg = self.cfg
        dtype, device = time_dtype(x0), _device_of(x0)
        t0 = as_time(t0, dtype, device)
        t1 = as_time(t1, dtype, device)
        direction = torch.sign(t1 - t0)
        h0_abs = as_time(cfg.initial_step if h0 is None else h0, dtype,
                         device).abs()
        h = direction * torch.where(h0_abs > 0, h0_abs,
                                    as_time(cfg.initial_step, dtype, device))
        state = SolverState(t0=t0, t1=t1, t=t0, x=x0, h=h, n_accepted=0,
                            n_attempts=0, n_fevals=0, xs=[], ts=[], hs=[],
                            active=True)
        return state._replace(
            active=self._budget_left(state)
            and bool(self._clock_live(state, state.t, state.h)))

    def _budget_left(self, state: SolverState) -> bool:
        return state.n_accepted < self.cfg.max_steps \
            and state.n_attempts < self.cfg.max_attempts

    @staticmethod
    def _clock_live(state: SolverState, t, h) -> torch.Tensor:
        """Device bool: t is short of t1 by more than the resolution, and
        the step carry is finite."""
        direction = torch.sign(state.t1 - state.t0)
        t_res = _time_resolution(state.t0, state.t1, t.dtype)
        return (direction * (state.t1 - t) > t_res) & torch.isfinite(h)

    def is_done(self, state: SolverState) -> bool:
        return not state.active

    def advance(self, state: SolverState, params) -> SolverState:
        """ONE attempted step: trial at the clamped step, error norm,
        accept/reject, commit of an accepted checkpoint, controller update.
        An inactive state passes through untouched."""
        if not state.active:
            return state
        cfg, tab = self.cfg, self.tab
        err_exp = -1.0 / (tab.err_order + 1.0)
        direction = torch.sign(state.t1 - state.t0)
        t, x, h = state.t, state.x, state.h
        # clamp the TRIAL step so we land exactly on t1; the carried h
        # stays unclamped.
        gap = (state.t1 - t).abs()
        clamped = h.abs() > gap
        h_eff = direction * torch.minimum(h.abs(), gap)
        x_next, err = rk_step(self.f, tab, x, t, h_eff, params,
                              self.combiner, with_error=True)
        enorm = _error_norm(_detach(err), _detach(x), _detach(x_next),
                            cfg.rtol, cfg.atol)
        accept = enorm <= 1.0
        factor = torch.clamp(
            cfg.safety * torch.pow(torch.clamp_min(enorm, 1e-10), err_exp),
            cfg.min_factor, cfg.max_factor)
        # clamped landing steps never contaminate the carried step: an
        # ACCEPTED one keeps the natural h, a REJECTED one shrinks from the
        # unclamped h (not from h_eff).
        h = torch.where(accept & clamped, h, h * factor)
        t_new = torch.where(accept, t + h_eff, t)
        # the one device-to-host read of the attempt
        ok, live = torch.stack(
            [accept, self._clock_live(state, t_new, h)]).tolist()
        fevals = tab.s + (1 if tab.err_uses_fsal else 0)
        state = state._replace(h=h, n_attempts=state.n_attempts + 1,
                               n_fevals=state.n_fevals + fevals)
        if ok:
            state = state._replace(
                t=t_new, x=x_next, n_accepted=state.n_accepted + 1,
                xs=state.xs + [x], ts=state.ts + [t], hs=state.hs + [h_eff])
        return state._replace(active=live and self._budget_left(state))

    def run(self, state: SolverState, params) -> SolverState:
        """Drive ``advance`` until ``is_done``."""
        while state.active:
            state = self.advance(state, params)
        return state

    def succeeded(self, state: SolverState) -> bool:
        direction = torch.sign(state.t1 - state.t0)
        t_res = _time_resolution(state.t0, state.t1, state.t.dtype)
        return not bool(direction * (state.t1 - state.t) > t_res)

    def finalize(self, state: SolverState) -> AdaptiveSolution:
        """Freeze a state into the solution tuple the drivers return."""
        return AdaptiveSolution(state.x, state.xs, state.ts, state.hs,
                                state.n_accepted, state.n_fevals,
                                self.succeeded(state), state.h,
                                state.n_attempts)


# ---------------------------------------------------------------------------
# Fixed-grid stepper.
# ---------------------------------------------------------------------------

class FixedSolverState(NamedTuple):
    """Between-steps state of an N-equal-steps fixed-grid solve: the clock
    is ``(t0, h, n)`` (t_n = t0 + n*h is derived, never accumulated)."""
    t0: torch.Tensor
    h: torch.Tensor
    n: int                      # steps taken so far
    x: Pytree
    xs: List[Pytree]            # checkpoints x_0..x_{n-1}
    ts: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FixedStepper:
    """N equal steps as a state machine."""
    f: VectorField
    tab: ButcherTableau
    n_steps: int
    combine_backend: str = "auto"

    @property
    def combiner(self) -> StageCombiner:
        return get_combiner(self.tab, self.combine_backend)

    def init_state(self, x0, t0, t1) -> FixedSolverState:
        dtype, device = time_dtype(x0), _device_of(x0)
        t0 = as_time(t0, dtype, device)
        t1 = as_time(t1, dtype, device)
        h = (t1 - t0) / self.n_steps
        return FixedSolverState(t0=t0, h=h, n=0, x=x0, xs=[], ts=[])

    def is_done(self, state: FixedSolverState) -> bool:
        return state.n >= self.n_steps

    def advance(self, state: FixedSolverState, params) -> FixedSolverState:
        """One fixed step: checkpoint the pre-step state, step without the
        embedded error estimate (no controller to consume it)."""
        t = state.t0 + state.n * state.h
        x_next, _ = rk_step(self.f, self.tab, state.x, t, state.h, params,
                            self.combiner, with_error=False)
        return state._replace(x=x_next, n=state.n + 1,
                              xs=state.xs + [state.x], ts=state.ts + [t])

    def run(self, state: FixedSolverState, params) -> FixedSolverState:
        while not self.is_done(state):
            state = self.advance(state, params)
        return state

    def finalize(self, state: FixedSolverState) -> FixedSolution:
        return FixedSolution(state.x, state.xs, state.ts, state.h)
