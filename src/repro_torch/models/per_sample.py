"""Per-sample adaptive solving, shared by the model workloads.

In the JAX package ``per_sample=True`` gives every sample its own step
controller (``solve(..., batch_axis=0)``).  Lane batching is not ported yet
(ROADMAP queue 1 item 10), so here only the lockstep solve exists and
``per_sample=True`` raises.
"""
from __future__ import annotations

from repro_torch.core import NOT_PORTED, SaveAt, solve


def per_sample_mode(cfg) -> bool:
    """True when ``cfg`` asks for per-sample lanes AND adaptive stepping —
    on a fixed grid every sample takes the identical grid already, so
    per-sample control changes nothing."""
    return bool(cfg.per_sample and cfg.adaptive)


def model_solve_ys(field, state, params, *, per_sample: bool,
                   saveat: SaveAt, **solve_kw):
    """``solve(...).ys``: a plain (lockstep) solve of the batch."""
    if per_sample:
        raise ValueError(
            "per_sample=True needs per-lane batched solving, which is not "
            f"ported to PyTorch yet ({NOT_PORTED['batch_axis']})")
    return solve(field, state, params, saveat=saveat, **solve_kw).ys
