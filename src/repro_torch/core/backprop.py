"""Differentiate-through-the-solver gradient modes (the paper's baselines).

  * ``backprop``     — plain autograd through the solver loop: autograd
                       retains every stage activation, memory O(M N s L)
                       (the paper's "naive backpropagation").
  * ``remat_step``   — one rematerialization per step: the forward keeps
                       only each step's input {x_n} (and the params), and
                       the backward re-runs one step's s stages with a graph
                       and backpropagates through it: memory O(M N + s L),
                       the ANODE/ACA checkpointing scheme.
  * ``remat_solve``  — one rematerialization of the whole solve: the forward
                       keeps only x0 and the params, the backward re-runs
                       the forward with a graph and backpropagates through
                       it: memory O(M) after the forward, O(N s L) inside
                       the backward — the paper's "baseline scheme".

Both remat modes are one ``autograd.Function`` (``_Replay``) whose forward
runs without a graph and whose backward replays the same computation under
``enable_grad``; the gradient is autograd's through the solver, so it equals
``backprop``'s to rounding.  ``torch.utils.checkpoint`` is not used: the
CNF's field calls ``torch.autograd.grad`` inside itself (its Hutchinson
VJP), and under a non-reentrant checkpoint each such inner call unpacks the
checkpoint's placeholders, which recomputes the step from its start during
the forward (5x the field evaluations of a plain dopri5 step).

The stage combines stay differentiable on the kernel path through the
``autograd.Function`` wrappers in core/combine.py.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from .rk import VectorField, rk_solve_fixed, rk_step
from .stepper import FixedStepper
from .tableau import ButcherTableau

Pytree = Any


def odeint_backprop(f: VectorField, tab: ButcherTableau, n_steps: int,
                    x0, t0, t1, params, combine_backend: str = "auto"):
    return rk_solve_fixed(f, tab, x0, t0, t1, n_steps, params,
                          combine_backend).x_final


class _Replay(torch.autograd.Function):
    """``fn(*leaves)`` -> a tuple of tensors, computed without a graph; the
    backward replays ``fn`` on the saved inputs with a graph and
    backpropagates the output cotangents through it.  The saved inputs
    are the only residuals."""

    @staticmethod
    def forward(ctx, fn: Callable[..., Sequence[torch.Tensor]], *leaves):
        ctx.fn = fn
        ctx.save_for_backward(*leaves)
        out = tuple(fn(*leaves))
        ctx.out_meta = [(o.shape, o.dtype, o.device) for o in out]
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [l.detach().requires_grad_(n)
                      for l, n in zip(ctx.saved_tensors, needs)]
            out = ctx.fn(*inputs)
        pairs = [(o, g) for o, g in zip(out, grads)
                 if g is not None and o.requires_grad]
        wrt = [i for i in inputs if i.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs and wrt else [None] * len(wrt))
        res = []
        for i in inputs:
            g = next(got) if i.requires_grad else None
            res.append(torch.zeros_like(i) if g is None and i.requires_grad
                       else g)
        return (None, *res)


def _replayed(fn: Callable[[Pytree, Pytree], Pytree], x, params):
    """``fn(x, params)`` through ``_Replay``, over the flattened leaves."""
    x_leaves, x_spec = pytree.tree_flatten(x)
    p_leaves, p_spec = pytree.tree_flatten(params)
    n_x = len(x_leaves)

    def flat(*leaves):
        out = fn(pytree.tree_unflatten(list(leaves[:n_x]), x_spec),
                 pytree.tree_unflatten(list(leaves[n_x:]), p_spec))
        return pytree.tree_leaves(out)

    out = _Replay.apply(flat, *x_leaves, *p_leaves)
    return pytree.tree_unflatten(list(out), x_spec)


def odeint_remat_step(f: VectorField, tab: ButcherTableau, n_steps: int,
                      x0, t0, t1, params, combine_backend: str = "auto"):
    """x(t1) on N equal steps, each step one ``_Replay``: the forward keeps
    the N step inputs, the backward re-runs one step at a time."""
    stepper = FixedStepper(f, tab, n_steps, combine_backend)
    state = stepper.init_state(x0, t0, t1)
    h, combiner = state.h, stepper.combiner
    x = x0
    for n in range(n_steps):
        t = state.t0 + n * h        # derived, as FixedStepper.advance does

        def step(xn, p, t=t):
            return rk_step(f, tab, xn, t, h, p, combiner,
                           with_error=False)[0]

        x = _replayed(step, x, params)
    return x


def odeint_remat_solve(f: VectorField, tab: ButcherTableau, n_steps: int,
                       x0, t0, t1, params, combine_backend: str = "auto"):
    """x(t1) on N equal steps as one ``_Replay``: the forward keeps x0 and
    the params, the backward re-runs the whole solve with a graph."""
    def whole(x, p):
        return rk_solve_fixed(f, tab, x, t0, t1, n_steps, p,
                              combine_backend, checkpoints=False).x_final

    return _replayed(whole, x0, params)
