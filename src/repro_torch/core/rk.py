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

Both record the step checkpoints {x_n, t_n, h_n} that Algorithm 1 of the
paper retains; which computation graphs survive is the gradient strategy's
business (core/api.py).  Every stage linear combination goes through the
StageCombiner (core/combine.py).  The fixed-grid driver never computes the
embedded error estimate (there is no step controller to consume it).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .tableau import ButcherTableau
from .stepper import (  # noqa: F401  (re-exports: the step-level surface)
    ON_FAILURE_POLICIES, AdaptiveConfig, AdaptiveSolution, AdaptiveStepper,
    BatchedAdaptiveSolution, FixedSolution, FixedStepper, Pytree,
    VectorField, lane_bcast, lane_count, rk_stages, rk_step)


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
