"""Differentiate-through-the-solver gradient mode (the paper's baseline).

  * ``backprop`` — plain autograd through the solver loop: autograd retains
                   every stage activation, memory O(M N s L) (the paper's
                   "naive backpropagation").

The stage combines stay differentiable on the kernel path through the
``autograd.Function`` wrappers in core/combine.py.  Per-step and
whole-solve rematerialization (``remat_step``, ``remat_solve``) are not
ported yet (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

from typing import Any

from .rk import VectorField, rk_solve_fixed
from .tableau import ButcherTableau

Pytree = Any


def odeint_backprop(f: VectorField, tab: ButcherTableau, n_steps: int,
                    x0, t0, t1, params, combine_backend: str = "auto"):
    return rk_solve_fixed(f, tab, x0, t0, t1, n_steps, params,
                          combine_backend).x_final
