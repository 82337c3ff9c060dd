"""Explicit Runge-Kutta integration over arbitrary pytree states.

Two drivers, both thin loops over the stepper state machine in
core/stepper.py (``init_state -> advance* -> finalize``):

  * ``rk_solve_fixed``    — N equal steps (``FixedStepper``); autograd can
                            differentiate straight through it
                            (DirectBackprop).
  * ``rk_solve_adaptive`` — PI-controlled adaptive stepping
                            (``AdaptiveStepper``), keeping the accepted
                            checkpoints.

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
    FixedSolution, FixedStepper, Pytree, VectorField, rk_stages, rk_step)


def rk_solve_fixed(f: VectorField, tab: ButcherTableau, x0, t0, t1,
                   n_steps: int, params,
                   combine_backend: str = "auto") -> FixedSolution:
    stepper = FixedStepper(f, tab, n_steps, combine_backend)
    state = stepper.run(stepper.init_state(x0, t0, t1), params)
    return stepper.finalize(state)


def rk_solve_adaptive(f: VectorField, tab: ButcherTableau, x0, t0, t1,
                      params, cfg: AdaptiveConfig,
                      combine_backend: str = "auto",
                      h0=None) -> AdaptiveSolution:
    """PI-controlled adaptive solve on [t0, t1].

    ``h0`` (optional) seeds the controller with a step MAGNITUDE and falls
    back to ``cfg.initial_step`` when absent or zero.  The controller rules
    live in ``AdaptiveStepper.advance``.
    """
    stepper = AdaptiveStepper(f, tab, cfg, combine_backend)
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
