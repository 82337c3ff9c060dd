"""The symplectic adjoint method (the paper's contribution).

Forward (Algorithm 1): integrate with any explicit Runge-Kutta tableau
under ``no_grad``, retaining ONLY the step checkpoints {x_n, t_n, h_n} — no
stage computation graph survives the forward pass.

Backward (Algorithm 2 + Eq. (7)/(8)): for each step n = N-1..0,
  1. recompute the stage states X_{n,i} from the checkpoint x_n without a
     graph (lines 3-7),
  2. run the symplectic-partner stage recursion i = s..1 (lines 8-13):

        Lambda_{n,i} = lambda_{n+1} - h * sum_{j>i} btilde_j (a_{j,i}/b_i) l_j   (i not in I0)
        Lambda_{n,i} = - sum_{j>i} btilde_j a_{j,i} l_j                          (i in I0)
        l_{n,i}      = -(df/dx(X_{n,i}))^T Lambda_{n,i}
        btilde_i     = b_i  (i not in I0),   h_n  (i in I0 = {i: b_i = 0})

     each l_{n,i} is ONE ``torch.autograd.grad`` through ONE network
     evaluation on detached copies of (X_{n,i}, params), and
  3. lambda_n = lambda_{n+1} - h * sum_i btilde_i l_{n,i};
     grad_theta += h * sum_i btilde_i (df/dtheta(X_{n,i}))^T Lambda_{n,i}.

Because the partitioned pair (forward RK, Eq. (7)) is symplectic, the bilinear
invariant lambda^T delta is conserved exactly in discrete time (Theorem 2), so
lambda_0 equals the EXACT gradient of the discrete forward map — verified
against autograd through the solver to rounding error in the tests.

Memory: each stage's graph is built inside its own ``autograd.grad`` call
and freed when the call returns, so one stage graph is live at a time and
live memory is O(N + s + L), not O(N * s * L).

The adjoint slopes l_{n,i} live in a stacked buffer, and both the Lambda
recursion and the lambda_n update are row combines through the
StageCombiner (core/combine.py) — the same fused primitive the forward
solve uses, with the h-dependent Eq. (7)/(8) rows computed on the device.

The drivers are ``torch.autograd.Function``s whose inputs are the
flattened leaves of (x0, params); times are not differentiated.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from .combine import StageCombiner, alloc_stages, get_combiner, set_stage
from .rk import (AdaptiveConfig, VectorField, apply_on_failure,
                 rk_solve_adaptive, rk_solve_fixed, rk_stages)
from .tableau import ButcherTableau

Pytree = Any


def _tree_add(a, b):
    return pytree.tree_map(torch.add, a, b)


def _stage_vjp(f: VectorField, X: Pytree, t, params: Pytree,
               cot: Pytree):
    """(d f(X, t, params) / d(X, params))^T cot, from one graph that is
    built and freed inside this call.  Returns (xbar, thbar) pytrees."""
    x_leaves, x_spec = pytree.tree_flatten(X)
    p_leaves, p_spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        xd = [l.detach().requires_grad_() for l in x_leaves]
        pd = [l.detach().requires_grad_() for l in p_leaves]
        out = f(pytree.tree_unflatten(xd, x_spec), t,
                pytree.tree_unflatten(pd, p_spec))
        pairs = [(o, c) for o, c in zip(pytree.tree_leaves(out),
                                        pytree.tree_leaves(cot))
                 if o.requires_grad]
        inputs = xd + pd
        grads = torch.autograd.grad(
            [o for o, _ in pairs], inputs, [c for _, c in pairs],
            allow_unused=True) if pairs else [None] * len(inputs)
    grads = [torch.zeros_like(i) if g is None else g
             for g, i in zip(grads, inputs)]
    return (pytree.tree_unflatten(grads[:len(xd)], x_spec),
            pytree.tree_unflatten(grads[len(xd):], p_spec))


@torch.no_grad()
def symplectic_step_adjoint(f: VectorField, tab: ButcherTableau,
                            x_n, t_n, h, params, lam_next,
                            combiner: Optional[StageCombiner] = None):
    """One backward step of Algorithm 2. Returns (lambda_n, grad_theta_step)."""
    combiner = combiner or get_combiner(tab)
    s = tab.s
    b, c = tab.b, tab.c
    # --- Alg.2 lines 3-7: recompute stages from the checkpoint ----------
    Xs, _K = rk_stages(f, tab, x_n, t_n, h, params, combiner)
    del _K
    L = alloc_stages(s, lam_next)   # stacked adjoint slopes l_{n,i}
    gtheta = None
    for i in reversed(range(s)):
        # --- Eq. (7): Lambda_{n,i} from the slope-buffer suffix L[i+1:] --
        Lam_i = combiner.lambda_stage(lam_next, L, h, i)
        # --- Alg.2 lines 10-12: one VJP of one network evaluation -------
        xbar, thbar = _stage_vjp(f, Xs[i], t_n + c[i] * h, params, Lam_i)
        set_stage(L, i, pytree.tree_map(torch.neg, xbar))
        # Eq. (8): h_n replaces vanishing weights.
        if b[i] == 0.0:
            contrib = pytree.tree_map(lambda g: h.to(g.dtype) * g, thbar)
        else:
            contrib = pytree.tree_map(lambda g: b[i] * g, thbar)
        gtheta = contrib if gtheta is None else _tree_add(gtheta, contrib)
    # --- lambda_n = lambda_{n+1} - h sum_i btilde_i l_{n,i} --------------
    lam_n = combiner.lambda_update(lam_next, L, h)
    # grad_theta step contribution: + h sum_i btilde_i (df/dtheta)^T Lambda_i
    gtheta = pytree.tree_map(lambda g: h.to(g.dtype) * g, gtheta)
    return lam_n, gtheta


@torch.no_grad()
def _algorithm2(f, tab, combiner, xs, ts, hs, params, lam):
    """Reverse sweep over the checkpoints; returns (lambda_0, grad_theta)."""
    gtheta = pytree.tree_map(torch.zeros_like, params)
    for n in reversed(range(len(xs))):
        lam, gstep = symplectic_step_adjoint(f, tab, xs[n], ts[n], hs[n],
                                             params, lam, combiner)
        gtheta = _tree_add(gtheta, gstep)
    return lam, gtheta


class _Problem:
    """The static half of one symplectic solve: the field, tableau,
    stepping and backend, the times, and the pytree structure of (x0,
    params).  After the forward it also carries the controller's counters
    (``stats``, ``succeeded``), so value and stats come from one run."""

    def __init__(self, f, tab, stepping, backend, t0, t1, x_spec, n_x,
                 p_spec):
        self.f, self.tab, self.stepping = f, tab, stepping
        self.backend, self.t0, self.t1 = backend, t0, t1
        self.x_spec, self.n_x, self.p_spec = x_spec, n_x, p_spec
        self.stats = None
        self.succeeded = True

    def split(self, leaves):
        x0 = pytree.tree_unflatten(list(leaves[:self.n_x]), self.x_spec)
        params = pytree.tree_unflatten(list(leaves[self.n_x:]), self.p_spec)
        return x0, params


class _SymplecticSolve(torch.autograd.Function):
    """x_final of a fixed (int stepping) or adaptive (AdaptiveConfig)
    solve, with the Algorithm 2 backward."""

    @staticmethod
    def forward(ctx, prob: _Problem, *leaves):
        x0, params = prob.split(leaves)
        if isinstance(prob.stepping, AdaptiveConfig):
            cfg = prob.stepping
            sol = rk_solve_adaptive(prob.f, prob.tab, x0, prob.t0, prob.t1,
                                    params, cfg, prob.backend)
            ctx.hs = sol.hs
            prob.stats = {"n_steps": sol.n_accepted,
                          "n_fevals": sol.n_fevals,
                          "n_attempts": sol.n_attempts}
            prob.succeeded = sol.succeeded
            x_final = apply_on_failure(sol.x_final, sol.succeeded,
                                       cfg.on_failure)
        else:
            sol = rk_solve_fixed(prob.f, prob.tab, x0, prob.t0, prob.t1,
                                 prob.stepping, params, prob.backend)
            ctx.hs = [sol.h] * len(sol.xs)
            x_final = sol.x_final
        # Algorithm 1's checkpoints are the only residuals.
        ctx.prob, ctx.xs, ctx.ts = prob, sol.xs, sol.ts
        ctx.save_for_backward(*leaves[prob.n_x:])
        out = pytree.tree_leaves(x_final)
        ctx.out_meta = [(o.shape, o.dtype, o.device) for o in out]
        return tuple(out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        prob = ctx.prob
        params = pytree.tree_unflatten(list(ctx.saved_tensors), prob.p_spec)
        lam = pytree.tree_unflatten(
            [torch.zeros(s, dtype=d, device=v) if g is None else g
             for g, (s, d, v) in zip(grads, ctx.out_meta)], prob.x_spec)
        combiner = get_combiner(prob.tab, prob.backend)
        lam0, gtheta = _algorithm2(prob.f, prob.tab, combiner, ctx.xs,
                                   ctx.ts, ctx.hs, params, lam)
        return (None, *pytree.tree_leaves(lam0), *pytree.tree_leaves(gtheta))


def _solve(f, tab, stepping, backend, x0, t0, t1, params):
    x_leaves, x_spec = pytree.tree_flatten(x0)
    p_leaves, p_spec = pytree.tree_flatten(params)
    prob = _Problem(f, tab, stepping, backend, t0, t1, x_spec,
                    len(x_leaves), p_spec)
    out = _SymplecticSolve.apply(prob, *x_leaves, *p_leaves)
    return pytree.tree_unflatten(list(out), x_spec), prob


def odeint_symplectic(f: VectorField, tab: ButcherTableau, n_steps: int,
                      combine_backend: str, x0, t0, t1, params):
    """x(t1) on N equal steps; gradient by Algorithm 2."""
    return _solve(f, tab, n_steps, combine_backend, x0, t0, t1, params)[0]


def odeint_symplectic_adaptive(f: VectorField, tab: ButcherTableau,
                               cfg: AdaptiveConfig, combine_backend: str,
                               x0, t0, t1, params):
    """x(t1) of an adaptive solve; gradient by Algorithm 2 replaying the
    accepted grid.  Returns (x_final, stats, succeeded): the controller's
    counters of the same run."""
    x, prob = _solve(f, tab, cfg, combine_backend, x0, t0, t1, params)
    return x, prob.stats, prob.succeeded
