"""Per-sample adaptive solving, shared by the model workloads.

The model nets (CNF concatsquash, HNN energy net) are written against a
``(batch, ...)`` state layout, so giving every sample its OWN step
controller (``solve(..., batch_axis=0)``) wraps each batch element as a
lane holding a singleton batch: ``(B, ...)`` becomes ``(B, 1, ...)``, the
net still sees a batch axis per lane under the driver's per-lane
``torch.func.vmap``, and the observed ``ys`` drop the singleton axis on the
way out.  This module is the one place that wrap/unwrap axis arithmetic
lives.
"""
from __future__ import annotations

from torch.utils import _pytree as pytree

from repro_torch.core import SaveAt, solve


def per_sample_mode(cfg) -> bool:
    """True when ``cfg`` asks for per-sample lanes AND adaptive stepping —
    on a fixed grid every sample takes the identical grid already, so
    per-sample control changes nothing."""
    return bool(cfg.per_sample and cfg.adaptive)


def model_solve_ys(field, state, params, *, per_sample: bool,
                   saveat: SaveAt, **solve_kw):
    """``solve(...).ys`` with optional per-sample step control.

    ``state`` leaves are ``(B, ...)`` with the model's data batch leading.
    ``per_sample=False`` is a plain (lockstep) solve; ``per_sample=True``
    wraps each element as a ``(B, 1, ...)`` singleton-batch lane, solves
    under ``batch_axis=0`` (the field must be ``torch.func``-safe), and
    removes the singleton axis from ``ys`` (axis 1 for ``SaveAt(t1=...)``;
    axis 2, after the leading ``len(ts)`` axis, for ``SaveAt(ts=...)``).
    """
    if not per_sample:
        return solve(field, state, params, saveat=saveat, **solve_kw).ys
    wrapped = pytree.tree_map(lambda l: l[:, None], state)
    sol = solve(field, wrapped, params, saveat=saveat, batch_axis=0,
                **solve_kw)
    axis = 1 if saveat.kind == "t1" else 2
    return pytree.tree_map(lambda l: l.squeeze(axis), sol.ys)
