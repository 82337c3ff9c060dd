"""Memory-bound rule: the paper's Table-1 ordering, held on live bytes (the
JAX package's ``repro.analysis.memory``).

For each registered strategy the rule runs one fixed-grid t1 loss and its
gradient in float64 (small state, wide hidden layer, so the network term L
dominates the per-step checkpoints) at N and 8N steps under an
``OpRecorder``, reads its peak of live bytes (``traversal``: storages the
call allocated, freed when their last tensor dies), and asserts the scaling
the paper proves:

  symplectic   peak O(N + s + L): FLAT in N within a small constant; the
               N-dependence is only the checkpoints {x_n}, negligible
               against the one live stage-VJP graph.
  remat_step   peak O(N + s L): flat for the same reason (one step's graph
               replayed at a time).
  adjoint      peak O(L): flat (one augmented backward solve that records
               no steps; approximate gradient).
  backprop     peak O(N s L): ~LINEAR in N, autograd keeps every stage's
               activations.
  remat_solve  O(N) forward but O(N s L) inside the backward replay:
               ~linear, the paper's baseline scheme.

Where the JAX package counts define-to-last-use liveness over a jaxpr, the
port counts what the run really holds: the same quantity without XLA's
fusion, so its bytes differ from the JAX table's while its classes (flat /
linear) and ordering are the paper's.  The thresholds are loose on purpose
(flat <= FLAT_MAX, linear >= LINEAR_MIN at 8x steps).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import solve
from repro_torch.core.api import GRADIENT_REGISTRY
from repro_torch.core.tableau import get_tableau
from .cases import mlp_field, mlp_params
from .rules import ERROR, Finding
from .traversal import record

__all__ = ["MemoryRow", "memory_rows", "memory_findings",
           "memory_table_markdown", "growth_class", "grad_loss",
           "grad_peak_bytes", "MEMORY_METHODS", "N_SMALL", "N_BIG", "DIM", "HIDDEN",
           "FLAT_MAX", "LINEAR_MIN", "LINEAR_MIN_S1", "ORDER_MARGIN",
           "PAPER_BOUNDS", "FLAT_STRATEGIES", "LINEAR_STRATEGIES"]

MEMORY_METHODS: Tuple[str, ...] = ("dopri5", "bosh3")
N_SMALL, N_BIG = 8, 64            # an 8x growth in steps
DIM, HIDDEN = 4, 256              # small state, wide net: L >> N * state

FLAT_MAX = 1.5                    # "flat within a small constant"
LINEAR_MIN = 3.0                  # "~linear" at 8x steps (loose on purpose)
LINEAR_MIN_S1 = 2.0               # single-stage methods (euler): the fixed
#                                   graph term L dilutes the N-slope, so the
#                                   linear floor is lower but still > FLAT_MAX
ORDER_MARGIN = 2.0                # symplectic must beat backprop by >= 2x

FLAT_STRATEGIES = ("symplectic", "remat_step", "adjoint")
LINEAR_STRATEGIES = ("backprop", "remat_solve")

# the Table-1 mapping (docs/gradients.md notation: N steps, s stages, L
# network-evaluation graph)
PAPER_BOUNDS: Dict[str, str] = {
    "symplectic": "O(N + s + L) — Table 1, proposed method",
    "backprop": "O(N s L) — Table 1, naive backprop",
    "remat_step": "O(N + s L) — ACA/ANODE per-step remat",
    "remat_solve": "O(N) fwd / O(N s L) bwd — Table 1 baseline scheme",
    "adjoint": "O(L) — Table 1 adjoint (approximate gradient)",
}


@dataclasses.dataclass(frozen=True)
class MemoryRow:
    strategy: str
    method: str
    n_small: int
    peak_small: int
    n_big: int
    peak_big: int

    @property
    def growth(self) -> float:
        return self.peak_big / max(self.peak_small, 1)


def _linear_min(method: str) -> float:
    return LINEAR_MIN if len(get_tableau(method).b) >= 3 else LINEAR_MIN_S1


def growth_class(growth: float, method: str) -> str:
    """"flat" (<= FLAT_MAX), "linear" (>= the method's linear floor) or
    "between"."""
    if growth <= FLAT_MAX:
        return "flat"
    return "linear" if growth >= _linear_min(method) else "between"


def grad_loss(strategy: str, method: str, n_steps: int, *, dim: int = DIM,
              hidden: int = HIDDEN, device="cuda", backend: str = "auto"):
    """(fn, args) of one fixed-grid t1 loss+gradient in float64 (every
    strategy supports this cell): ``fn(*args)`` returns the gradient."""
    x0, params = mlp_params(dim, hidden, device=device)
    x0 = x0.requires_grad_()
    params = pytree.tree_map(lambda l: l.requires_grad_(), params)
    leaves = [x0] + pytree.tree_leaves(params)

    def fn(x0, params):
        sol = solve(mlp_field, x0, params, method=method, gradient=strategy,
                    stepping=n_steps, backend=backend)
        return torch.autograd.grad(torch.sum(torch.sin(sol.ys) ** 2), leaves)
    return fn, (x0, params)


def grad_peak_bytes(strategy: str, method: str, n_steps: int,
                    **kw) -> int:
    """The recorder's peak live bytes of ``grad_loss``'s call."""
    fn, args = grad_loss(strategy, method, n_steps, **kw)
    return record(fn, *args, records=False)[1].peak_bytes


def memory_rows(methods: Tuple[str, ...] = MEMORY_METHODS,
                n_small: int = N_SMALL, n_big: int = N_BIG,
                **kw) -> List[MemoryRow]:
    rows = []
    for method in methods:
        for name in sorted(GRADIENT_REGISTRY):
            rows.append(MemoryRow(
                name, method, n_small,
                grad_peak_bytes(name, method, n_small, **kw),
                n_big, grad_peak_bytes(name, method, n_big, **kw)))
    return rows


def memory_findings(rows: List[MemoryRow]) -> List[Finding]:
    """The machine-checked Table-1 ordering."""
    out = []
    by = {(r.strategy, r.method): r for r in rows}
    for method in sorted({r.method for r in rows}):
        for name in FLAT_STRATEGIES:
            r = by.get((name, method))
            if r and r.growth > FLAT_MAX:
                out.append(Finding(
                    "memory-bound", ERROR, f"{name}/{method}",
                    f"peak grew {r.growth:.2f}x at {r.n_big // r.n_small}x "
                    f"steps ({r.peak_small} -> {r.peak_big} B) but "
                    f"{PAPER_BOUNDS[name]} requires flat (<= {FLAT_MAX}x)"))
        linear_min = _linear_min(method)
        for name in LINEAR_STRATEGIES:
            r = by.get((name, method))
            if r and r.growth < linear_min:
                out.append(Finding(
                    "memory-bound", ERROR, f"{name}/{method}",
                    f"peak grew only {r.growth:.2f}x at "
                    f"{r.n_big // r.n_small}x steps ({r.peak_small} -> "
                    f"{r.peak_big} B): expected ~linear growth "
                    f"(>= {linear_min}x, {PAPER_BOUNDS[name]}): autograd "
                    "no longer holds the steps' activations"))
        sym = by.get(("symplectic", method))
        bp = by.get(("backprop", method))
        if sym and bp and sym.peak_big * ORDER_MARGIN > bp.peak_big:
            out.append(Finding(
                "memory-bound", ERROR, f"symplectic/{method}",
                f"Table-1 ordering violated at N={sym.n_big}: symplectic "
                f"peak {sym.peak_big} B is not <= backprop "
                f"{bp.peak_big} B / {ORDER_MARGIN}"))
    return out


def _fmt_bytes(b: int) -> str:
    if b >= 1 << 20:
        return f"{b / 2**20:.2f} MiB"
    return f"{b / 2**10:.1f} KiB"


def memory_table_markdown(rows: List[MemoryRow]) -> str:
    """The generated docs table (docs/analysis_torch.md)."""
    lines = [
        "| strategy | method | peak @ N="
        f"{rows[0].n_small} | peak @ N={rows[0].n_big} | growth "
        "| paper bound |",
        "|----------|--------|------------|-------------|--------"
        "|-------------|",
    ]
    for r in rows:
        lines.append(
            f"| `{r.strategy}` | {r.method} | {_fmt_bytes(r.peak_small)} "
            f"| {_fmt_bytes(r.peak_big)} | {r.growth:.2f}x "
            f"| {PAPER_BOUNDS.get(r.strategy, '—')} |")
    return "\n".join(lines)
