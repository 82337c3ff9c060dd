"""Continuous adjoint method (Chen et al. 2018 baseline).

The backward pass integrates the augmented system

    d/dt [x, lambda, lambda_theta] =
        [f(x, t, theta), -(df/dx)^T lambda, -(df/dtheta)^T lambda]

backward in time, from (x_N, dL/dx_N, 0) at t1 to t0.  In discrete time
this is NOT the exact gradient of the discrete forward map (Remark 1 of
the paper fails after discretization): the error is O(h^p), and the tests
measure it against the symplectic adjoint.  Memory is O(L) in the step
count: the forward keeps only x(t1) and the params, and neither solve
records its steps (the steppers' ``checkpoints=False``) — a record of the
augmented state, as large as the parameters (per lane in the lane-batched
form), would cost O(N L) or O(max_steps B L).

Three drivers, each an ``autograd.Function`` over the flattened leaves of
(x0, params); times are not differentiated:

  * ``odeint_adjoint``                  — fixed grid; the backward solve
    takes ``n_steps * steps_multiplier`` equal steps.
  * ``odeint_adjoint_adaptive``         — adaptive forward, and an adaptive
    backward solve under its own config (``bwd_cfg``); a truncated
    backward solve is poisoned (or raises) by ``bwd_cfg.on_failure``.
  * ``odeint_adjoint_adaptive_batched`` — B independent trajectories (lane
    axis 0): both solves run under masked per-lane step control, and the
    augmented state carries a per-lane parameter-gradient accumulator,
    leaves (B,) + param shape, summed over the lanes at the end: O(B L)
    backward memory.  A lane whose backward solve fails poisons its own
    lambda row and, through the sum, the parameter gradient.

The value and the stats of an adaptive solve come from the forward's one
run.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree

from .rk import (AdaptiveConfig, VectorField, apply_on_failure,
                 apply_on_failure_lanes, counters, lane_count, rk_solve_adaptive,
                 rk_solve_adaptive_batched, rk_solve_fixed)
from .symplectic import _Problem, _value_and_vjp
from .tableau import ButcherTableau

Pytree = Any


def _neg(tree: Pytree) -> Pytree:
    return pytree.tree_map(torch.neg, tree)


def aug_dynamics(f: VectorField) -> VectorField:
    """The augmented field of one trajectory: (f(x), -(df/dx)^T lambda,
    -(df/dtheta)^T lambda) from one graph built and freed per call."""
    def aug(state, t, params):
        x, lam, _ = state
        fx, xbar, thbar = _value_and_vjp(f, x, t, params, lam)
        return (pytree.tree_map(lambda o: o.detach(), fx), _neg(xbar),
                _neg(thbar))
    return aug


def aug_dynamics_lanes(f: VectorField) -> VectorField:
    """The augmented field through ``torch.func.vjp``: safe under the lane
    stepper's ``vmap``, where each lane gets its OWN parameter cotangent
    (never summed here)."""
    def aug(state, t, params):
        x, lam, _ = state
        fx, vjp_fn = torch.func.vjp(lambda xx, th: f(xx, t, th), x, params)
        xbar, thbar = vjp_fn(lam)
        return fx, _neg(xbar), _neg(thbar)
    return aug


class _AdjointSolve(torch.autograd.Function):
    """x_final of a fixed (int stepping), adaptive (AdaptiveConfig) or
    lane-batched adaptive solve, with the augmented backward solve.  The
    residuals are x_final and the params."""

    @staticmethod
    def forward(ctx, prob: _Problem, *leaves):
        x0, params = prob.split(leaves)
        f, tab, backend = prob.f, prob.tab, prob.backend
        if prob.lanes:
            cfg = prob.stepping
            sol = rk_solve_adaptive_batched(f, tab, x0, prob.t0, prob.t1,
                                            params, cfg, backend,
                                            checkpoints=False)
            x_final = apply_on_failure_lanes(sol.x_final, sol.succeeded,
                                             cfg.on_failure)
        elif isinstance(prob.stepping, AdaptiveConfig):
            cfg = prob.stepping
            sol = rk_solve_adaptive(f, tab, x0, prob.t0, prob.t1, params,
                                    cfg, backend, checkpoints=False)
            x_final = apply_on_failure(sol.x_final, sol.succeeded,
                                       cfg.on_failure)
        else:
            sol = rk_solve_fixed(f, tab, x0, prob.t0, prob.t1,
                                 prob.stepping, params, backend,
                                 checkpoints=False)
            x_final = sol.x_final
        if not isinstance(prob.stepping, int):
            prob.stats, prob.succeeded = counters(sol)
        out = pytree.tree_leaves(x_final)
        ctx.prob = prob
        ctx.save_for_backward(*out, *leaves[prob.n_x:])
        ctx.out_meta = [(o.shape, o.dtype, o.device) for o in out]
        return tuple(out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        prob = ctx.prob
        saved = ctx.saved_tensors
        x_n, params = prob.split(saved)
        lam = pytree.tree_unflatten(
            [torch.zeros(s, dtype=d, device=v) if g is None else g
             for g, (s, d, v) in zip(grads, ctx.out_meta)], prob.x_spec)
        f, tab, backend, bwd = prob.f, prob.tab, prob.backend, prob.bwd
        # integrate backward: t goes t1 -> t0 (negative steps)
        if prob.lanes:
            B = lane_count(x_n)
            g0 = pytree.tree_map(
                lambda p: torch.zeros((B,) + tuple(p.shape), dtype=p.dtype,
                                      device=p.device), params)
            sol = rk_solve_adaptive_batched(
                aug_dynamics_lanes(f), tab, (x_n, lam, g0), prob.t1,
                prob.t0, params, bwd, backend, checkpoints=False)
            _, lam0, g_lanes = apply_on_failure_lanes(
                sol.x_final, sol.succeeded, bwd.on_failure)
            gtheta = pytree.tree_map(lambda g: g.sum(0), g_lanes)
        else:
            g0 = pytree.tree_map(torch.zeros_like, params)
            aug = aug_dynamics(f)
            if isinstance(bwd, AdaptiveConfig):
                sol = rk_solve_adaptive(aug, tab, (x_n, lam, g0), prob.t1,
                                        prob.t0, params, bwd, backend,
                                        checkpoints=False)
                # a truncated backward solve is a silently wrong gradient:
                # poison it (or raise) by the backward config's policy
                _, lam0, gtheta = apply_on_failure(
                    sol.x_final, sol.succeeded, bwd.on_failure)
            else:
                sol = rk_solve_fixed(aug, tab, (x_n, lam, g0), prob.t1,
                                     prob.t0, bwd, params, backend,
                                     checkpoints=False)
                _, lam0, gtheta = sol.x_final
        return (None, *pytree.tree_leaves(lam0), *pytree.tree_leaves(gtheta))


def _solve(f, tab, stepping, bwd, backend, x0, t0, t1, params, lanes=False):
    x_leaves, x_spec = pytree.tree_flatten(x0)
    p_leaves, p_spec = pytree.tree_flatten(params)
    prob = _Problem(f, tab, stepping, backend, t0, t1, x_spec,
                    len(x_leaves), p_spec)
    prob.bwd, prob.lanes = bwd, lanes
    out = _AdjointSolve.apply(prob, *x_leaves, *p_leaves)
    return pytree.tree_unflatten(list(out), x_spec), prob


def odeint_adjoint(f: VectorField, tab: ButcherTableau, n_steps: int,
                   steps_multiplier: int, combine_backend: str,
                   x0, t0, t1, params):
    """x(t1) on N equal steps; gradient by the augmented backward solve on
    ``n_steps * steps_multiplier`` equal steps."""
    return _solve(f, tab, n_steps, n_steps * steps_multiplier,
                  combine_backend, x0, t0, t1, params)[0]


def odeint_adjoint_adaptive(f: VectorField, tab: ButcherTableau,
                            cfg: AdaptiveConfig, bwd_cfg: AdaptiveConfig,
                            combine_backend: str, x0, t0, t1, params):
    """x(t1) of an adaptive solve; gradient by an adaptive augmented
    backward solve under ``bwd_cfg``.  Returns (x_final, stats,
    succeeded): the forward controller's counters of the same run."""
    x, prob = _solve(f, tab, cfg, bwd_cfg, combine_backend, x0, t0, t1,
                     params)
    return x, prob.stats, prob.succeeded


def odeint_adjoint_adaptive_batched(f: VectorField, tab: ButcherTableau,
                                    cfg: AdaptiveConfig,
                                    bwd_cfg: AdaptiveConfig,
                                    combine_backend: str, x0, t0, t1,
                                    params):
    """x(t1) of a lane-batched adaptive solve (lane axis 0); gradient by a
    lane-batched adaptive augmented backward solve, each lane on its own
    backward grid.  Returns (x_final, stats, succeeded) with per-lane (B,)
    stats and success on the device."""
    x, prob = _solve(f, tab, cfg, bwd_cfg, combine_backend, x0, t0, t1,
                     params, lanes=True)
    return x, prob.stats, prob.succeeded


__all__ = ["aug_dynamics", "aug_dynamics_lanes", "odeint_adjoint",
           "odeint_adjoint_adaptive", "odeint_adjoint_adaptive_batched"]
