"""Continuous-time physical systems (the paper's Table 4 workload, HNN++).

Learn the energy functional H(u) of a 1-D periodic PDE with a neural net
(one conv layer + two FC, as in Matsubara et al. 2020), and evolve

    du/dt = G (dH/du)     with  G = d/dx   (KdV, skew-adjoint)
                               G = d^2/dx^2 (Cahn-Hilliard)

Periodic central differences discretize G.  Training interpolates successive
snapshots: loss = MSE(solve(u_k -> dt).ys, u_{k+1}) — the paper's setting
where dopri8 (12 stages) shines and the symplectic adjoint's per-stage
checkpoint advantage is largest.  ``rollout`` observes a whole snapshot
trajectory through one ``SaveAt(ts=...)`` solve.

The field differentiates the energy net itself.  The lockstep mode takes
dH/du with ``torch.autograd.grad`` (with ``create_graph`` when the caller
builds a graph through the evaluation: the symplectic backward's stage
VJPs, DirectBackprop); per-sample mode (``per_sample=True``, adaptive
only) takes it with ``torch.func.grad``, which is safe under the lane
stepper's ``torch.func.vmap``.

Parameters are a dict of tensors laid out as the JAX package's
(``conv_w`` (3, 1, channels), ``conv_b``, ``fc1``, ``fc1_b``, ``fc2``);
``params_from_jax`` turns the JAX package's parameters (as numpy arrays)
into them.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import AdaptiveConfig, SaveAt, as_gradient
from repro_torch.models.cnf import params_from_jax  # noqa: F401
from repro_torch.models.per_sample import model_solve_ys, per_sample_mode
from repro_torch.nn.common import dense_init


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    grid: int = 64                 # spatial points
    dx: float = 0.5
    channels: int = 16
    hidden: int = 64
    system: str = "kdv"            # "kdv" | "cahn_hilliard"
    method: str = "dopri8"
    # a registered strategy name OR a GradientStrategy instance (core/api.py)
    grad_mode: object = "symplectic"
    combine_backend: str = "auto"  # stage-combine dispatch (core/combine.py)
    n_steps: int = 4
    dt: float = 0.1                # snapshot interval
    adaptive: bool = False         # PI-controlled stepping instead of n_steps
    rtol: float = 1e-6
    atol: float = 1e-8
    max_steps: int = 64            # per snapshot segment
    # per-trajectory adaptive step control (solve(..., batch_axis=0)): each
    # trajectory keeps its own accepted grid (adaptive solves only)
    per_sample: bool = False


def init_energy_net(cfg: PhysicsConfig, *, seed: int = 0, device="cuda",
                    dtype: torch.dtype = torch.float32):
    """Random energy-net params from ``seed`` (keys in sorted order, as JAX
    flattens a dict)."""
    gen = torch.Generator().manual_seed(seed)
    ksize = 3
    return {
        "conv_b": torch.zeros((cfg.channels,), dtype=dtype, device=device),
        "conv_w": dense_init((ksize, 1, cfg.channels), dtype, gen, device),
        "fc1": dense_init((cfg.channels, cfg.hidden), dtype, gen, device),
        "fc1_b": torch.zeros((cfg.hidden,), dtype=dtype, device=device),
        "fc2": dense_init((cfg.hidden, 1), dtype, gen, device),
    }


def energy(params, u):
    """u: (B, grid) -> scalar energy per sample (B,).  Periodic conv as
    the sum of three shifted matmuls."""
    G = u.shape[-1]
    x = u[..., None]                                  # (B, G, 1)
    k = params["conv_w"].shape[0]
    pad = k // 2
    xp = torch.cat([x[:, -pad:], x, x[:, :pad]], dim=1)
    h = sum(xp[:, i:i + G] @ params["conv_w"][i] for i in range(k))
    h = torch.tanh(h + params["conv_b"])
    h = torch.tanh(h @ params["fc1"] + params["fc1_b"])
    e = h @ params["fc2"]                             # (B, G, 1)
    return torch.sum(e[..., 0], dim=-1)               # integrate over grid


def _dx_op(v, dx):
    return (torch.roll(v, -1, dims=-1) - torch.roll(v, 1, dims=-1)) \
        / (2 * dx)


def _lap_op(v, dx):
    return (torch.roll(v, -1, dims=-1) - 2 * v + torch.roll(v, 1, dims=-1)) \
        / (dx * dx)


def _grad_energy(params, u, func: bool):
    """dH/du at u.  ``func=True`` takes ``torch.func.grad``; otherwise
    ``torch.autograd.grad`` on a leaf made here, differentiable exactly
    when the caller builds a graph through this evaluation."""
    def total(uu):
        return torch.sum(energy(params, uu))
    if func:
        return torch.func.grad(total)(u)
    graph = torch.is_grad_enabled() and (
        u.requires_grad
        or any(p.requires_grad for p in pytree.tree_leaves(params)))
    with torch.enable_grad():
        uu = u if u.requires_grad else u.detach().requires_grad_()
        (g,) = torch.autograd.grad(total(uu), uu, create_graph=graph)
    return g if graph else g.detach()


@functools.lru_cache(maxsize=None)
def hnn_field(system: str, dx: float, func: bool = False):
    """Vector field du/dt = G dH/du (G = d/dx for KdV, d^2/dx^2 for
    Cahn-Hilliard, periodic); ``func=True`` for per-sample mode."""
    def field(u, t, params):
        gradH = _grad_energy(params, u, func) / dx
        if system == "kdv":
            return _dx_op(gradH, dx)
        return _lap_op(gradH, dx)
    return field


def _solve_kw(cfg: PhysicsConfig):
    stepping = AdaptiveConfig(rtol=cfg.rtol, atol=cfg.atol,
                              max_steps=cfg.max_steps) \
        if cfg.adaptive else cfg.n_steps
    return dict(per_sample=per_sample_mode(cfg), method=cfg.method,
                gradient=as_gradient(cfg.grad_mode), stepping=stepping,
                backend=cfg.combine_backend)


def _field(cfg: PhysicsConfig):
    return hnn_field(cfg.system, cfg.dx, per_sample_mode(cfg))


def predict_next(params, u, cfg: PhysicsConfig):
    """One snapshot interval; u: (B, grid) -> (B, grid).  With
    ``cfg.per_sample`` (adaptive only) each trajectory runs under its own
    step controller (models/per_sample.py)."""
    return model_solve_ys(_field(cfg), u, params, saveat=SaveAt(t1=cfg.dt),
                          **_solve_kw(cfg))


def rollout(params, u0, cfg: PhysicsConfig, horizon: int):
    """Evolve u0 for ``horizon`` snapshot intervals in ONE solve, observed
    at dt, 2dt, ..., horizon*dt through ``SaveAt(ts=...)``: the same
    discrete map as ``horizon`` chained ``predict_next`` calls, without
    re-integrating from t=0 per snapshot.  With ``cfg.per_sample`` each
    trajectory threads its OWN controller across every snapshot boundary.
    Returns (horizon, B, grid)."""
    ts = cfg.dt * np.arange(1, horizon + 1)
    return model_solve_ys(_field(cfg), u0, params, saveat=SaveAt(ts=ts),
                          **_solve_kw(cfg))


def physics_loss(params, u_k, u_k1, cfg: PhysicsConfig):
    pred = predict_next(params, u_k, cfg)
    return torch.mean((pred - u_k1) ** 2)


def rollout_loss(params, u_traj, cfg: PhysicsConfig):
    """Multi-snapshot interpolation loss over one trajectory batch.

    ``u_traj``: (K+1, B, grid) consecutive snapshots; the loss compares a
    single K-observation solve from u_traj[0] against snapshots 1..K.
    """
    pred = rollout(params, u_traj[0], cfg, u_traj.shape[0] - 1)
    return torch.mean((pred - u_traj[1:]) ** 2)
