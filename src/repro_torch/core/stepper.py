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

Lane-batched states (``solve(..., batch_axis=0)``, ``init_state(...,
lanes=B)``): every leaf carries B independent trajectories on its leading
axis, and t, h, the counters and liveness are (B,) tensors on the device.
Each lane has its own error norm, accept/reject and accepted grid; an
attempt evaluates f ONCE per stage over all lanes (``torch.func.vmap`` of
the single-trajectory field, so f must be ``torch.func``-safe) and combines
with one coefficient row per lane.  The checkpoints go into preallocated
(max_steps + 1, B, ...) buffers: a lane that accepts writes row
n_accepted[b], every other lane writes the scratch row max_steps.  The host
reads ONE value per attempt: whether any lane is still live.  Every
controller rule is the single-trajectory one applied per lane, so lane b of
a batched solve takes the accepted grid of its own single solve.
``advance_in_place`` is the same attempt with no host read, written into
the state's own tensors: the serve engine (``repro_torch.serve``) drives it
and reads liveness itself, once per eviction sweep.

Tolerances may be data: ``init_state(..., rtol=, atol=)`` puts them into
the state (0-dim, or one per lane), cast to each leaf's dtype in the error
norm, so a solve at tolerances as data takes the same steps, bit for bit,
as one at the config's Python floats.

A stepper built with ``checkpoints=False`` records none of them (no lists,
no buffers): the continuous adjoint's solves need only the final state, and
its augmented backward state is as large as the parameters (per lane in the
lane-batched form), so a record of it would cost O(N L) or O(max_steps B L).

This module also owns the step-level primitives the steppers are built from
(``rk_step``, ``rk_stages``, the error norms, ``AdaptiveConfig`` and the
solution tuples).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.ref import lane_bcast
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


def lane_count(x0: Pytree) -> int:
    """Lane count B of a lane-batched state: every leaf must carry the same
    leading lane axis (``solve(..., batch_axis=0)``)."""
    leaves = pytree.tree_leaves(x0)
    if not leaves:
        raise ValueError("batched solve needs a non-empty state pytree")
    sizes = set()
    for l in leaves:
        if l.dim() < 1:
            raise ValueError(
                "batch_axis=0 requires every state leaf to carry a leading "
                f"lane axis; got a rank-0 leaf {l!r}")
        sizes.add(l.shape[0])
    if len(sizes) != 1:
        raise ValueError(
            "batch_axis=0 requires every state leaf to share the same "
            f"leading lane-axis size; got sizes {sorted(sizes)}")
    return sizes.pop()


def lane_field(f: VectorField) -> VectorField:
    """``f`` over lane-batched states: ONE evaluation over all lanes, each
    lane seeing its own state (lane axis removed) and its own time, and the
    shared params — the JAX package's ``vmap`` of the field."""
    return torch.func.vmap(f, in_dims=(0, 0, None))


# ---------------------------------------------------------------------------
# One explicit RK step (stage states, slopes, embedded error).
# ---------------------------------------------------------------------------

def rk_stages(f: VectorField, tab: ButcherTableau, x, t, h, params,
              combiner: Optional[StageCombiner] = None,
              last_slope: bool = True):
    """Compute all stage states X_i and slopes k_i for one step.

    Returns (Xs, K): ``Xs`` is a list of s stage-state pytrees, ``K`` the
    stacked slope buffer (leading stage dim s per leaf), a fresh buffer
    whose rows are each written once.  Purely forward; the symplectic
    backward pass re-runs this from a checkpoint (Alg. 2 lines 3-7) with
    ``last_slope=False``: it needs the stage states only, and X_{s-1}
    reads k_0 .. k_{s-2}, so the last field evaluation is skipped (K's
    last row is then left unwritten).
    """
    combiner = combiner or get_combiner(tab)
    s = tab.s
    K = alloc_stages(s, x)
    Xs = []
    for i in range(s):
        Xi = combiner.stage_state(x, K, h, i)
        Xs.append(Xi)
        if i < s - 1 or last_slope:
            set_stage(K, i, f(Xi, t + tab.c[i] * h, params))
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
    """A TENSOR tolerance (0-dim, or (B,) per lane) cast to the leaf dtype
    and shaped to broadcast over the leaf's lane axis 0, so tolerances as
    data reproduce the closed Python floats bit for bit; Python floats
    pass through (they never promote the scale computation)."""
    if isinstance(v, torch.Tensor):
        return lane_bcast(v.to(leaf.dtype), leaf)
    return v


def _scaled_sq(e, a, b, rtol, atol) -> torch.Tensor:
    """(err / (atol + rtol max(|x|, |x_next|)))^2 for one leaf, accumulated
    in >= f32 but NEVER below the state dtype: an f32 norm quantizes the
    accept/reject decisions of an f64 solve."""
    scale = _tol_like(atol, a) \
        + _tol_like(rtol, a) * torch.maximum(a.abs(), b.abs())
    r = (e / scale).to(torch.promote_types(e.dtype, torch.float32))
    return r * r


def _error_norm(err, x, x_next, rtol, atol) -> torch.Tensor:
    """RMS of err / (atol + rtol max(|x|, |x_next|)) over all leaves, as a
    0-dim device tensor."""
    leaves = zip(pytree.tree_leaves(err), pytree.tree_leaves(x),
                 pytree.tree_leaves(x_next))
    total, count = 0.0, 0
    for e, a, b in leaves:
        r2 = _scaled_sq(e, a, b, rtol, atol)
        total = total + torch.sum(r2)
        count += r2.numel()
    return torch.sqrt(total / count)


def _error_norm_lanes(err, x, x_next, rtol, atol) -> torch.Tensor:
    """Per-lane error norms of lane-batched states, shape (B,): lane b's is
    ``_error_norm`` of lane b alone — the same per-leaf scale and the same
    element-count weighting across leaves, never pooled over the batch.
    ``rtol``/``atol`` are Python floats (shared) or (B,) tensors (one
    tolerance per lane)."""
    leaves = zip(pytree.tree_leaves(err), pytree.tree_leaves(x),
                 pytree.tree_leaves(x_next))
    total, count = 0.0, 0
    for e, a, b in leaves:
        r2 = _scaled_sq(e, a, b, rtol, atol)
        total = total + r2.reshape(r2.shape[0], -1).sum(1)
        count += r2[0].numel()
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


class BatchedAdaptiveSolution(NamedTuple):
    """Per-lane results of a lane-batched adaptive solve (lane count B),
    all on the solve's device.  The checkpoint buffers keep the step axis
    LEADING — ``xs`` leaves are (max_steps + 1, B, ...), ``ts``/``hs`` are
    (max_steps + 1, B); row n of lane b is its n-th accepted checkpoint for
    n < n_accepted[b], and the last row is scratch — so the symplectic
    backward walks step rows as the single-trajectory one does, masking
    each lane by its own n_accepted."""
    x_final: Pytree             # per-lane final states (lane axis 0)
    xs: Pytree
    ts: torch.Tensor
    hs: torch.Tensor
    n_accepted: torch.Tensor    # (B,) int32
    n_fevals: torch.Tensor      # (B,) int32
    succeeded: torch.Tensor     # (B,) bool: lane reached t1 within budgets
    h_final: torch.Tensor       # (B,) unclamped controller step at exit
    n_attempts: torch.Tensor    # (B,) int32: per-lane trial steps


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
    rtol, atol   — optional 0-dim tolerances in the time dtype (tolerances
                   as data); None takes the AdaptiveConfig's Python floats.
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
    rtol: Optional[torch.Tensor] = None
    atol: Optional[torch.Tensor] = None


class BatchedSolverState(NamedTuple):
    """The between-attempts state of a lane-batched adaptive solve: every
    field but ``active`` is a device tensor, and the time-like fields and
    counters are per lane.

    t0, t1, t, h — (B,) in the time dtype; h is each lane's UNCLAMPED step.
    x            — the lane-batched state pytree (lane axis 0).
    n_accepted, n_attempts, n_fevals — (B,) int32 counters.
    xs, ts, hs   — (max_steps + 1, B, ...) checkpoint buffers; the last row
                   is where lanes that do not commit write.
    lanes        — arange(B), the lane index of the buffers' commit.
    live         — (B,) bool: the lane goes on (``lanes_active``).
    active       — the host's copy of live.any(), read once per attempt
                   (``advance_in_place`` leaves it as it is).
    rtol, atol   — optional (B,) tolerances in the time dtype, one per lane
                   (tolerances as data); None takes the AdaptiveConfig's.

    The fields of a state from ``init_state`` share no storage with one
    another, so ``advance_in_place`` may write each of them.
    """
    t0: torch.Tensor
    t1: torch.Tensor
    t: torch.Tensor
    x: Pytree
    h: torch.Tensor
    n_accepted: torch.Tensor
    n_attempts: torch.Tensor
    n_fevals: torch.Tensor
    xs: Pytree
    ts: torch.Tensor
    hs: torch.Tensor
    lanes: torch.Tensor
    live: torch.Tensor
    active: bool
    rtol: Optional[torch.Tensor] = None
    atol: Optional[torch.Tensor] = None


def _commit_lanes(buf: torch.Tensor, val: torch.Tensor, row: torch.Tensor,
                  lanes: torch.Tensor) -> None:
    """Write lane b of ``val`` into row ``row[b]`` of the (max_steps + 1,
    B, ...) buffer, in place: one indexed write per buffer, no read.  The
    caller points lanes that do not commit at the scratch row."""
    buf[row, lanes] = val.detach().to(buf.dtype)


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
    # False: record no checkpoints (xs/ts/hs stay empty, or None for a
    # lane-batched state) — for drivers that need only the final state
    checkpoints: bool = True

    def __post_init__(self):
        if self.tab.b_err is None:
            raise ValueError(
                f"tableau {self.tab.name} has no embedded error estimate")

    @property
    def combiner(self) -> StageCombiner:
        return get_combiner(self.tab, self.combine_backend)

    # -- lifecycle ----------------------------------------------------------
    def init_state(self, x0, t0, t1, h0=None, *, lanes: Optional[int] = None,
                   rtol=None, atol=None) -> SolverState:
        """Fresh state at t0.  ``h0`` seeds the controller with a step
        MAGNITUDE, falling back to ``cfg.initial_step`` when absent or
        zero.  ``lanes=B`` builds a lane-batched state (x0 leaves carry lane
        axis 0; t0, t1 and h0 may be scalars or (B,)).  ``rtol``/``atol``
        (scalars, or (B,) with lanes) put the tolerances into the state as
        data, in place of the config's Python floats."""
        if lanes is not None:
            return self._init_lanes(x0, t0, t1, h0, lanes, rtol, atol)
        cfg = self.cfg
        dtype, device = time_dtype(x0), _device_of(x0)
        t0 = as_time(t0, dtype, device)
        t1 = as_time(t1, dtype, device)
        direction = torch.sign(t1 - t0)
        h0_abs = as_time(cfg.initial_step if h0 is None else h0, dtype,
                         device).abs()
        h = direction * torch.where(h0_abs > 0, h0_abs,
                                    as_time(cfg.initial_step, dtype, device))
        state = SolverState(
            t0=t0, t1=t1, t=t0, x=x0, h=h, n_accepted=0, n_attempts=0,
            n_fevals=0, xs=[], ts=[], hs=[], active=True,
            rtol=None if rtol is None else as_time(rtol, dtype, device),
            atol=None if atol is None else as_time(atol, dtype, device))
        return state._replace(
            active=self._budget_left(state)
            and bool(self._clock_live(state, state.t, state.h)))

    def _init_lanes(self, x0, t0, t1, h0, B: int, rtol,
                    atol) -> BatchedSolverState:
        cfg = self.cfg
        dtype, device = time_dtype(x0), _device_of(x0)

        def per_lane(v):
            v = v.to(dtype=dtype, device=device) \
                if isinstance(v, torch.Tensor) else \
                torch.full((), float(v), dtype=dtype, device=device)
            return v.expand(B).contiguous()

        t0, t1 = per_lane(t0), per_lane(t1)
        h0_abs = per_lane(cfg.initial_step if h0 is None else h0).abs()
        h = torch.sign(t1 - t0) * torch.where(
            h0_abs > 0, h0_abs, as_time(cfg.initial_step, dtype, device))
        rows = cfg.max_steps + 1

        def counter():
            return torch.zeros(B, dtype=torch.int32, device=device)
        xs = ts = hs = None
        if self.checkpoints:
            xs = pytree.tree_map(
                lambda l: torch.zeros((rows,) + tuple(l.shape),
                                      dtype=l.dtype, device=device), x0)
            ts = torch.zeros((rows, B), dtype=dtype, device=device)
            hs = torch.zeros((rows, B), dtype=dtype, device=device)
        state = BatchedSolverState(
            t0=t0, t1=t1, t=t0.clone(), x=x0, h=h, n_accepted=counter(),
            n_attempts=counter(), n_fevals=counter(), xs=xs, ts=ts, hs=hs,
            lanes=torch.arange(B, device=device), live=None, active=True,
            rtol=None if rtol is None else per_lane(rtol),
            atol=None if atol is None else per_lane(atol))
        # no host read here: if no lane is live, the first attempt leaves
        # every lane as it is and reads that back
        return state._replace(live=self.lanes_active(state))

    def lanes_active(self, state: BatchedSolverState) -> torch.Tensor:
        """Per-lane liveness, (B,) bool on the device: a lane goes on until
        it lands within the dtype-aware resolution of t1, exhausts a
        budget, or its h carry goes non-finite (a NaN-poisoned lane costs
        one doomed trial, then drops out)."""
        cfg = self.cfg
        return self._clock_live(state, state.t, state.h) \
            & (state.n_accepted < cfg.max_steps) \
            & (state.n_attempts < cfg.max_attempts)

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

    def _trial(self, state, params, f, error_norm):
        """The controller arithmetic of one attempt, the same for one
        trajectory and per lane: the trial step at h_eff = min(|h|, |t1 -
        t|) (so the solve lands exactly on t1), its error norm, and the
        PI-updated carry.  Returns (x_next, h_eff, accept, h_new)."""
        cfg, tab = self.cfg, self.tab
        err_exp = -1.0 / (tab.err_order + 1.0)
        direction = torch.sign(state.t1 - state.t0)
        t, x, h = state.t, state.x, state.h
        gap = (state.t1 - t).abs()
        clamped = h.abs() > gap
        h_eff = direction * torch.minimum(h.abs(), gap)
        x_next, err = rk_step(f, tab, x, t, h_eff, params, self.combiner,
                              with_error=True)
        rtol = cfg.rtol if state.rtol is None else state.rtol
        atol = cfg.atol if state.atol is None else state.atol
        enorm = error_norm(_detach(err), _detach(x), _detach(x_next),
                           rtol, atol)
        accept = enorm <= 1.0
        factor = torch.clamp(
            cfg.safety * torch.pow(torch.clamp_min(enorm, 1e-10), err_exp),
            cfg.min_factor, cfg.max_factor)
        # clamped landing steps never contaminate the carried step: an
        # ACCEPTED one keeps the natural h, a REJECTED one shrinks from the
        # unclamped h (not from h_eff).
        return x_next, h_eff, accept, torch.where(accept & clamped, h,
                                                  h * factor)

    def advance(self, state: SolverState, params) -> SolverState:
        """ONE attempted step: trial at the clamped step, error norm,
        accept/reject, commit of an accepted checkpoint, controller update.
        An inactive state passes through untouched; in a lane-batched state
        so does every inactive lane."""
        if not state.active:
            return state
        if isinstance(state, BatchedSolverState):
            return self._advance_lanes(state, params)
        t, x = state.t, state.x
        x_next, h_eff, accept, h = self._trial(state, params, self.f,
                                               _error_norm)
        t_new = torch.where(accept, t + h_eff, t)
        # the one device-to-host read of the attempt
        ok, live = torch.stack(
            [accept, self._clock_live(state, t_new, h)]).tolist()
        fevals = self.tab.s + (1 if self.tab.err_uses_fsal else 0)
        state = state._replace(h=h, n_attempts=state.n_attempts + 1,
                               n_fevals=state.n_fevals + fevals)
        if ok:
            state = state._replace(t=t_new, x=x_next,
                                   n_accepted=state.n_accepted + 1)
            if self.checkpoints:
                state = state._replace(xs=state.xs + [x], ts=state.ts + [t],
                                       hs=state.hs + [h_eff])
        return state._replace(active=live and self._budget_left(state))

    def _advance_lanes(self, state: BatchedSolverState,
                       params) -> BatchedSolverState:
        """The lane-batched attempt and its one host read: whether any lane
        is live."""
        state = self._attempt_lanes(state, params)
        live = self.lanes_active(state)
        return state._replace(live=live, active=bool(live.any()))

    @torch.no_grad()
    def advance_in_place(self, state: BatchedSolverState, params) -> None:
        """One lane-batched attempt written into the state's own tensors
        (t, x, h, the counters, ``live``; checkpoints as always), with no
        host read and no autograd: the serve engine's step, whose slot
        tensors keep their storage across attempts.  It runs whatever the
        host flag ``active`` says, so a lane written into a finished state
        steps; ``active`` is left as it is, and an attempt in which no lane
        is live leaves every lane as it is.  The x0 given to ``init_state``
        is the state's x, and is written too."""
        new = self._attempt_lanes(state, params)
        for dst, src in zip(self._attempt_fields(state),
                            self._attempt_fields(new)):
            dst.copy_(src)
        state.live.copy_(self.lanes_active(state))

    @staticmethod
    def _attempt_fields(state: BatchedSolverState) -> List[torch.Tensor]:
        return [state.t, state.h, state.n_accepted, state.n_attempts,
                state.n_fevals] + pytree.tree_leaves(state.x)

    def _attempt_lanes(self, state: BatchedSolverState,
                       params) -> BatchedSolverState:
        """The lane-batched attempt without a host read: every lane steps
        from its own (t, h), f once per stage over all lanes, and the lanes
        that are live and accept commit.  Returns the state with new t, x,
        h and counters (``live`` as it was)."""
        t, x, active = state.t, state.x, state.live
        x_next, h_eff, accept, h_new = self._trial(
            state, params, lane_field(self.f), _error_norm_lanes)
        h = torch.where(active, h_new, state.h)  # inactive lanes keep theirs
        do = active & accept
        n_acc = state.n_accepted
        if self.checkpoints:
            row = torch.where(do, n_acc, self.cfg.max_steps)
            with torch.no_grad():
                for buf, val in zip(pytree.tree_leaves(state.xs),
                                    pytree.tree_leaves(x)):
                    _commit_lanes(buf, val, row, state.lanes)
                _commit_lanes(state.ts, t, row, state.lanes)
                _commit_lanes(state.hs, h_eff, row, state.lanes)
        x = pytree.tree_map(
            lambda a, b: torch.where(lane_bcast(do, a), b, a), x, x_next)
        fevals = self.tab.s + (1 if self.tab.err_uses_fsal else 0)
        return state._replace(
            t=torch.where(do, t + h_eff, t), x=x, h=h,
            n_accepted=n_acc + do.int(),
            n_attempts=state.n_attempts + active.int(),
            n_fevals=state.n_fevals + active.int() * fevals)

    def run(self, state: SolverState, params) -> SolverState:
        """Drive ``advance`` until ``is_done``."""
        while state.active:
            state = self.advance(state, params)
        return state

    def succeeded(self, state: SolverState):
        """Whether the clock reached t1: a host bool, or a (B,) bool tensor
        on the device for a lane-batched state."""
        direction = torch.sign(state.t1 - state.t0)
        t_res = _time_resolution(state.t0, state.t1, state.t.dtype)
        short = direction * (state.t1 - state.t) > t_res
        if isinstance(state, BatchedSolverState):
            return ~short
        return not bool(short)

    def finalize(self, state: SolverState):
        """Freeze a state into the solution tuple the drivers return
        (``BatchedAdaptiveSolution`` for a lane-batched state)."""
        cls = BatchedAdaptiveSolution \
            if isinstance(state, BatchedSolverState) else AdaptiveSolution
        return cls(state.x, state.xs, state.ts, state.hs, state.n_accepted,
                   state.n_fevals, self.succeeded(state), state.h,
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
    checkpoints: bool = True      # False: xs/ts stay empty

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
        if not self.checkpoints:
            return state._replace(x=x_next, n=state.n + 1)
        return state._replace(x=x_next, n=state.n + 1,
                              xs=state.xs + [state.x], ts=state.ts + [t])

    def run(self, state: FixedSolverState, params) -> FixedSolverState:
        while not self.is_done(state):
            state = self.advance(state, params)
        return state

    def finalize(self, state: FixedSolverState) -> FixedSolution:
        return FixedSolution(state.x, state.xs, state.ts, state.h)
