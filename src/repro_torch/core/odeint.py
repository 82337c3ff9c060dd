"""Legacy ``odeint`` front-end: a thin compat shim over ``solve`` (the JAX
package's ``repro.core.odeint``).

DEPRECATED: use the composable API in core/api.py instead

    from repro_torch.core import SaveAt, SymplecticAdjoint, solve
    sol = solve(f, x0, params, saveat=SaveAt(t1=1.0),
                gradient=SymplecticAdjoint(), stepping=16)

Both entry points only translate the old string kwargs onto ``solve`` and
emit a ``DeprecationWarning`` whose text starts with ``odeint-style entry
point`` (the pytest configuration turns it into an error for internal
callers).  The mapping:

    grad_mode="symplectic"            -> gradient=SymplecticAdjoint()
    grad_mode="backprop"              -> gradient=DirectBackprop()
    grad_mode="remat_step"            -> gradient=RematStep()
    grad_mode="remat_solve"           -> gradient=RematSolve()
    grad_mode="adjoint",
      adjoint_steps_multiplier=k,
      adjoint_adaptive_cfg=cfg        -> gradient=ContinuousAdjoint(
                                             steps_multiplier=k,
                                             bwd_adaptive=cfg)
    t1=..., ts=...                    -> saveat=SaveAt(t1=...) / SaveAt(ts=...)
    ts_mode="dense"                   -> saveat=SaveAt(ts=..., dense=True)
    n_steps=N / adaptive=cfg          -> stepping=N / stepping=cfg
    combine_backend=...               -> backend=...

``odeint`` returns ``Solution.ys``; ``odeint_with_stats`` returns
``(Solution.ys, stats_dict)`` with the historical key set (fixed grids:
n_steps/n_fevals; adaptive: + n_attempts/succeeded) and the historical
no-poisoning behavior (failures are reported in ``stats["succeeded"]``,
never NaN-poisoned or raised).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

from .api import ContinuousAdjoint, DirectBackprop, SaveAt, as_gradient, solve
from .rk import AdaptiveConfig, VectorField
from .tableau import ButcherTableau

__all__ = ["odeint", "odeint_with_stats", "GRAD_MODES", "TS_MODES"]

GRAD_MODES = ("symplectic", "backprop", "remat_step", "remat_solve",
              "adjoint")
TS_MODES = ("auto", "segment", "dense")


def _warn(name: str) -> None:
    warnings.warn(
        f"odeint-style entry point {name}() is deprecated: use "
        "repro_torch.core.solve(f, x0, params, saveat=SaveAt(...), "
        "gradient=<strategy>, stepping=<n_steps|AdaptiveConfig>) instead",
        DeprecationWarning, stacklevel=3)


def _gradient_of(grad_mode: str, adjoint_steps_multiplier: int,
                 adjoint_adaptive_cfg: Optional[AdaptiveConfig]):
    if grad_mode == "adjoint":
        return ContinuousAdjoint(steps_multiplier=adjoint_steps_multiplier,
                                 bwd_adaptive=adjoint_adaptive_cfg)
    # historical behavior: the adjoint-only kwargs are silently ignored by
    # every other mode
    return as_gradient(grad_mode)


def odeint(f: VectorField, x0, params, *, t0=0.0, t1=None,
           ts=None, ts_mode: str = "auto",
           method: Union[str, ButcherTableau] = "dopri5",
           grad_mode: str = "symplectic",
           n_steps: int = 16,
           adaptive: Optional[AdaptiveConfig] = None,
           adjoint_adaptive_cfg: Optional[AdaptiveConfig] = None,
           adjoint_steps_multiplier: int = 1,
           combine_backend: str = "auto",
           batch_axis: Optional[int] = None):
    """DEPRECATED compat shim: translate old kwargs onto ``solve``."""
    _warn("odeint")
    if ts_mode not in TS_MODES:
        raise ValueError(f"ts_mode {ts_mode!r} not in {TS_MODES}")
    if ts is not None:
        if t1 is not None:
            # SaveAt would catch this too; raise here to keep the exact
            # historical message
            raise ValueError(
                "pass EITHER t1 or ts: with observation times the solve "
                "ends at ts[-1] (include the end time in ts)")
        saveat = SaveAt(ts=ts, dense=(ts_mode == "dense"))
    else:
        saveat = SaveAt(t1=1.0 if t1 is None else t1)
    sol = solve(f, x0, params, saveat=saveat, method=method,
                gradient=_gradient_of(grad_mode, adjoint_steps_multiplier,
                                      adjoint_adaptive_cfg),
                stepping=n_steps if adaptive is None else adaptive,
                backend=combine_backend, t0=t0, batch_axis=batch_axis)
    return sol.ys


def odeint_with_stats(f: VectorField, x0, params, *, t0=0.0, t1=None,
                      ts=None,
                      method: Union[str, ButcherTableau] = "dopri5",
                      n_steps: int = 16,
                      adaptive: Optional[AdaptiveConfig] = None,
                      combine_backend: str = "auto",
                      batch_axis: Optional[int] = None):
    """DEPRECATED compat shim: a DirectBackprop solve + stats dict.

    With ``ts`` and an adaptive config the observation scheme is Hermite
    dense output (ONE unsegmented solve), as before; failure is reported in
    ``stats["succeeded"]`` instead of the config's on_failure policy (the
    policy is overridden to "ignore")."""
    _warn("odeint_with_stats")
    if ts is not None and t1 is not None:
        raise ValueError("pass EITHER t1 or ts (the solve ends at ts[-1])")
    if ts is not None:
        saveat = SaveAt(ts=ts, dense=(adaptive is not None))
    else:
        saveat = SaveAt(t1=1.0 if t1 is None else t1)
    if adaptive is None:
        stepping = n_steps
    else:
        stepping = dataclasses.replace(adaptive, on_failure="ignore")
    sol = solve(f, x0, params, saveat=saveat, method=method,
                gradient=DirectBackprop(), stepping=stepping,
                backend=combine_backend, t0=t0, batch_axis=batch_axis)
    if adaptive is None:
        stats = {"n_steps": sol.stats["n_steps"],
                 "n_fevals": sol.stats["n_fevals"]}
    else:
        stats = dict(sol.stats)
        stats["succeeded"] = sol.success
    return sol.ys, stats
