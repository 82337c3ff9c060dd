"""Explicit Runge-Kutta integration over arbitrary pytree states.

Three drivers, all thin loops over the stepper state machine in
core/stepper.py (``init_state -> advance* -> finalize``):

  * ``rk_solve_fixed``    — N equal steps (``FixedStepper``); autograd can
                            differentiate straight through it
                            (DirectBackprop).
  * ``rk_solve_adaptive`` — PI-controlled adaptive stepping
                            (``AdaptiveStepper``), keeping the accepted
                            checkpoints.
  * ``rk_solve_adaptive_batched`` — B independent trajectories (lane axis
                            0 of every leaf), each with its own controller,
                            in one loop.

SaveAt support (observations at user times ``ts``): the segmented adaptive
drivers ``rk_solve_adaptive_saveat_stacked`` / ``..._batched_saveat_
stacked`` (one sub-solve per observation segment, the controller's step
threaded across the boundaries) and ``hermite_observe`` (cubic-Hermite
dense output of one unsegmented solve).

Both record the step checkpoints {x_n, t_n, h_n} that Algorithm 1 of the
paper retains; which computation graphs survive is the gradient strategy's
business (core/api.py).  Every stage linear combination goes through the
StageCombiner (core/combine.py).  The fixed-grid driver never computes the
embedded error estimate (there is no step controller to consume it).
"""
from __future__ import annotations

import functools
import operator

import torch
from torch.utils import _pytree as pytree

from .combine import get_combiner
from .tableau import ButcherTableau
from .stepper import (  # noqa: F401  (re-exports: the step-level surface)
    ON_FAILURE_POLICIES, AdaptiveConfig, AdaptiveSolution, AdaptiveStepper,
    BatchedAdaptiveSolution, FixedSolution, FixedStepper, Pytree,
    VectorField, as_time, lane_bcast, lane_count, lane_field, rk_stages,
    rk_step)


def rk_solve_fixed(f: VectorField, tab: ButcherTableau, x0, t0, t1,
                   n_steps: int, params, combine_backend: str = "auto", *,
                   checkpoints: bool = True) -> FixedSolution:
    """N equal steps on [t0, t1]; ``checkpoints=False`` records no
    checkpoints (``xs``/``ts`` come back empty)."""
    stepper = FixedStepper(f, tab, n_steps, combine_backend, checkpoints)
    state = stepper.run(stepper.init_state(x0, t0, t1), params)
    return stepper.finalize(state)


def rk_solve_adaptive(f: VectorField, tab: ButcherTableau, x0, t0, t1,
                      params, cfg: AdaptiveConfig,
                      combine_backend: str = "auto",
                      h0=None, *, checkpoints: bool = True
                      ) -> AdaptiveSolution:
    """PI-controlled adaptive solve on [t0, t1].

    ``h0`` (optional) seeds the controller with a step MAGNITUDE and falls
    back to ``cfg.initial_step`` when absent or zero.  The controller rules
    live in ``AdaptiveStepper.advance``.  ``checkpoints=False`` records no
    accepted checkpoints (``xs``/``ts``/``hs`` come back empty).
    """
    stepper = AdaptiveStepper(f, tab, cfg, combine_backend, checkpoints)
    state = stepper.init_state(x0, t0, t1, h0)
    return stepper.finalize(stepper.run(state, params))


def apply_on_failure(x_final: Pytree, succeeded: bool,
                     on_failure: str) -> Pytree:
    """Apply an AdaptiveConfig.on_failure policy to a solver result."""
    if succeeded or on_failure == "ignore":
        return x_final
    if on_failure == "raise":
        raise RuntimeError(
            "solve: adaptive solver exhausted max_steps/max_attempts "
            "without reaching t1 (AdaptiveConfig(on_failure='raise'))")

    def poison(l):
        # a where, not a fresh tensor: the graph (zero gradient) survives
        if not l.is_floating_point():
            return l
        keep = torch.zeros((), dtype=torch.bool, device=l.device)
        return torch.where(keep, l, torch.full_like(l, float("nan")))

    return pytree.tree_map(poison, x_final)


def apply_on_failure_lanes(x_final: Pytree, succeeded: torch.Tensor,
                           on_failure: str) -> Pytree:
    """``apply_on_failure`` per lane: ``succeeded`` is (B,) bool on the
    device and lane axis 0 of every leaf indexes the trajectories.  "nan"
    poisons exactly the failed lanes (no host read); "raise" reads whether
    every lane succeeded and raises if not."""
    if on_failure == "ignore":
        return x_final
    if on_failure == "raise":
        if not bool(succeeded.all()):
            raise RuntimeError(
                "solve: adaptive solver exhausted max_steps/max_attempts "
                "without reaching t1 in some lane "
                "(AdaptiveConfig(on_failure='raise'))")
        return x_final

    def poison(l):
        if not l.is_floating_point():
            return l
        return torch.where(lane_bcast(succeeded, l), l,
                           torch.full_like(l, float("nan")))

    return pytree.tree_map(poison, x_final)


def rk_solve_adaptive_batched(f: VectorField, tab: ButcherTableau, x0, t0,
                              t1, params, cfg: AdaptiveConfig,
                              combine_backend: str = "auto",
                              h0=None, *, checkpoints: bool = True
                              ) -> BatchedAdaptiveSolution:
    """Adaptive solve of B independent trajectories in ONE loop.

    ``x0`` is lane-batched (lane axis 0 of every leaf).  Each lane carries
    its own (t, h, n_accepted, n_attempts), its own error norm (never
    pooled across the batch) and its own accept/reject; finished and
    rejected lanes are masked on commit, so no lane's stiffness perturbs
    another's accepted grid.  The loop runs until every lane lands or
    exhausts its budgets; each attempt evaluates f once per stage over the
    whole batch, so lanes that are already done spend wasted slots.  Every
    controller rule is ``rk_solve_adaptive``'s, per lane.  ``t0``/``t1``/
    ``h0`` may be scalars (shared) or (B,) tensors.  ``checkpoints=False``
    allocates no checkpoint buffers (``xs``/``ts``/``hs`` come back None).
    """
    stepper = AdaptiveStepper(f, tab, cfg, combine_backend, checkpoints)
    state = stepper.init_state(x0, t0, t1, h0, lanes=lane_count(x0))
    return stepper.finalize(stepper.run(state, params))


# ---------------------------------------------------------------------------
# SaveAt support: segmented adaptive solves + Hermite dense output.
# ---------------------------------------------------------------------------

def tree_stack(trees) -> Pytree:
    """Stack a list of same-structure pytrees along a new leading axis."""
    return pytree.tree_map(lambda *ls: torch.stack(ls), *trees)


def segment_starts(t0, ts: torch.Tensor) -> torch.Tensor:
    """Left endpoints of the observation segments: [t0, ts[0], ...,
    ts[-2]].  Zipped with ``ts`` these are the (start, end) pairs every
    SaveAt driver walks."""
    t0 = as_time(t0, ts.dtype, ts.device).reshape(1)
    return torch.cat([t0, ts[:-1]])


def rk_solve_adaptive_saveat_stacked(f: VectorField, tab: ButcherTableau,
                                     x0, t0, ts: torch.Tensor, params,
                                     cfg: AdaptiveConfig,
                                     combine_backend: str = "auto"):
    """Adaptive solve observed at the times ``ts`` by segmenting the solve.

    One adaptive sub-solve per segment [t0, ts[0]], [ts[0], ts[1]], ...;
    the controller state threads across segments (each segment seeds its
    step from the previous segment's unclamped ``h_final``, the first
    from ``cfg.initial_step``), so landing on an observation time costs
    one clamped step, not a restart.  A failed segment poisons its state
    per ``cfg.on_failure`` and the poison propagates to every later
    observation (a NaN state bails after one trial per later segment).

    Returns (obs, sols): ``obs`` the stacked observations (leading axis
    len(ts) per leaf), ``sols`` the list of per-segment
    ``AdaptiveSolution``s, each ``x_final`` the (possibly poisoned)
    observation.  The JAX package's stacked driver returns every field
    stacked over the segments (one ``lax.scan``), and its
    ``rk_solve_adaptive_saveat`` unstacks them into this list: here each
    segment's accepted checkpoints are a list of its own length, so the
    list is what the driver returns.
    """
    x, h = x0, None
    sols = []
    for a, b in zip(segment_starts(t0, ts), ts):
        sol = rk_solve_adaptive(f, tab, x, a, b, params, cfg,
                                combine_backend, h0=h)
        x = apply_on_failure(sol.x_final, sol.succeeded, cfg.on_failure)
        sols.append(sol._replace(x_final=x))
        h = sol.h_final
    return tree_stack([s.x_final for s in sols]), sols



def counters(sol):
    """(stats, succeeded) of one adaptive solution: its counters under the
    names ``solve`` reports."""
    return ({"n_steps": sol.n_accepted, "n_fevals": sol.n_fevals,
             "n_attempts": sol.n_attempts}, sol.succeeded)


def segment_stats(per_segment):
    """(stats, succeeded) of a segmented solve from each segment's (stats,
    succeeded): the counters summed, success AND-ed — host ints and
    bools, 0-dim tensors, or per-lane (B,) tensors alike."""
    per_segment = list(per_segment)
    stats = {k: sum(st[k] for st, _ in per_segment)
             for k in per_segment[0][0]}
    return stats, functools.reduce(operator.and_,
                                   (ok for _, ok in per_segment))


def rk_solve_adaptive_batched_saveat_stacked(
        f: VectorField, tab: ButcherTableau, x0, t0, ts: torch.Tensor,
        params, cfg: AdaptiveConfig, combine_backend: str = "auto"):
    """Lane-batched ``rk_solve_adaptive_saveat_stacked``: one lane-batched
    sub-solve per segment, each lane's unclamped step threading across
    every observation boundary in its own (B,) carry.  The observation
    times are shared by the lanes.  A lane whose segment fails is poisoned
    per ``cfg.on_failure`` without touching its batchmates, and the poison
    propagates to that lane's later observations.

    Each segment keeps only the checkpoint rows its lanes used: rows
    [0, max(n_accepted)) of the (max_steps + 1, B, ...) buffers, cloned
    (one host read per segment), so ``len(ts)`` segments cost the rows
    they accepted, not ``len(ts)`` whole buffers.  Returns (obs, sols):
    stacked observations (leading axis len(ts), then the lanes) and the
    list of per-segment ``BatchedAdaptiveSolution``s.
    """
    x, h = x0, None
    sols = []
    for a, b in zip(segment_starts(t0, ts), ts):
        sol = rk_solve_adaptive_batched(f, tab, x, a, b, params, cfg,
                                        combine_backend, h0=h)
        x = apply_on_failure_lanes(sol.x_final, sol.succeeded,
                                   cfg.on_failure)
        rows = int(sol.n_accepted.max())
        # rebinding ``sol`` frees the whole buffers before the next segment
        # allocates its own
        sol = sol._replace(
            x_final=x, xs=pytree.tree_map(lambda l: l[:rows].clone(),
                                          sol.xs),
            ts=sol.ts[:rows].clone(), hs=sol.hs[:rows].clone())
        sols.append(sol)
        h = sol.h_final
    return tree_stack([s.x_final for s in sols]), sols


def hermite_observe(f: VectorField, tab: ButcherTableau,
                    sol: AdaptiveSolution, params, taus: torch.Tensor,
                    combine_backend: str = "auto") -> Pytree:
    """Dense-output observation of ONE adaptive solve at the times ``taus``.

    Cubic-Hermite interpolation over the accepted step containing each tau
    (``StageCombiner.interpolate``): the step endpoints come from the
    checkpoints (x_{n+1} is the next checkpoint, or ``x_final`` after the
    last step), their slopes are recomputed — 2 field evaluations per
    observation, all in ONE lane-batched field call (``lane_field``: f must
    be ``torch.func``-safe) — and every observation is a lane of ONE
    combine.  The step controller never sees the observation times; taus
    outside the integrated span clamp to the nearest step (theta clipped
    to [0, 1]).  A solve that accepted no step returns ``x_final`` at
    every tau.  Returns the observations stacked over taus.
    """
    m = taus.shape[0]
    n_acc = sol.n_accepted
    if n_acc == 0:      # the state never moved
        return pytree.tree_map(
            lambda xf: xf[None].expand((m,) + tuple(xf.shape)), sol.x_final)
    ts, hs = torch.stack(sol.ts), torch.stack(sol.hs)
    direction = torch.sign(hs[0])
    n = torch.searchsorted(direction * ts, direction * taus, right=True) - 1
    n = n.clamp(0, n_acc - 1)
    t_n, h_n = ts[n], hs[n]
    xs = tree_stack(sol.xs)
    x_n = pytree.tree_map(lambda b: b[n], xs)
    # x_{n+1}: the next checkpoint, or x_final for the last accepted step
    x_n1 = pytree.tree_map(lambda b, xf: torch.cat([b[1:], xf[None]])[n],
                           xs, sol.x_final)
    theta = ((taus - t_n) / torch.where(h_n == 0, torch.ones_like(h_n),
                                        h_n)).clamp(0.0, 1.0)
    # both endpoints' slopes of every observation: 2 m lanes, one call
    slopes = lane_field(f)(
        pytree.tree_map(lambda a, b: torch.cat([a, b]), x_n, x_n1),
        torch.cat([t_n, t_n + h_n]), params)
    f0 = pytree.tree_map(lambda s: s[:m], slopes)
    f1 = pytree.tree_map(lambda s: s[m:], slopes)
    combiner = get_combiner(tab, combine_backend)
    return combiner.interpolate(x_n, x_n1, f0, f1, h_n, theta)
