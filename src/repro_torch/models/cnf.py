"""Continuous normalizing flow (FFJORD) — the paper's Table 2 workload.

M stacked neural-ODE components; each integrates the augmented state
(x, logp_delta, eps) where d(logp_delta)/dt = -Tr(df/dx), estimated by the
Hutchinson estimator eps^T (df/dx) eps (eps fixed per solve, carried in the
state with zero dynamics so every gradient mode — including the symplectic
adjoint — sees a plain augmented ODE).  ``trace="exact"`` uses the exact
jacobian trace for small dims (tests).

Dynamics network: concatsquash MLP (FFJORD's layer: W x * sigmoid(gate(t))
+ bias(t)), tanh nonlinearities.

Parameters are a pytree of tensors laid out as the JAX package's:
``{"components": [layer, ...]}`` with ``layer = {"w", "b", "wt_gate",
"wt_bias"}`` and a leading ``n_components`` axis on every leaf.
``params_from_jax`` turns the JAX package's parameters (as numpy arrays)
into this layout, so both packages can run on the same weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import AdaptiveConfig, SaveAt, as_gradient
from repro_torch.models.per_sample import model_solve_ys, per_sample_mode
from repro_torch.nn.common import dense_init


@dataclasses.dataclass(frozen=True)
class CNFConfig:
    dim: int
    hidden: Tuple[int, ...] = (64, 64)
    n_components: int = 1            # M in the paper
    t1: float = 1.0
    trace: str = "hutchinson"        # "hutchinson" | "exact"
    method: str = "dopri5"
    # a registered strategy name OR a GradientStrategy instance (core/api.py)
    grad_mode: Any = "symplectic"
    combine_backend: str = "auto"    # stage-combine dispatch (core/combine.py)
    n_steps: int = 16
    adaptive: bool = False
    rtol: float = 1e-6
    atol: float = 1e-8
    max_steps: int = 64
    # per-sample adaptive step control: not ported yet (models/per_sample.py)
    per_sample: bool = False


def init_cnf(cfg: CNFConfig, *, seed: int = 0, device="cuda",
             dtype: torch.dtype = torch.float32):
    """Random component params from ``seed``, stacked over components: every
    leaf carries a leading ``n_components`` axis."""
    gen = torch.Generator().manual_seed(seed)
    dims = (cfg.dim,) + tuple(cfg.hidden) + (cfg.dim,)
    layers = []
    for i in range(len(dims) - 1):
        M, dout = cfg.n_components, dims[i + 1]
        layer = {
            "w": dense_init((M, dims[i], dout), dtype, gen, device,
                            in_axis=1),
            "b": torch.zeros((M, dout), dtype=dtype, device=device),
            "wt_gate": dense_init((M, 1, dout), dtype, gen, device,
                                  in_axis=1),
            "wt_bias": dense_init((M, 1, dout), dtype, gen, device,
                                  in_axis=1),
        }
        # keys in sorted order, as JAX flattens a dict: the leaves of both
        # packages' params then come in the same order
        layers.append({k: layer[k] for k in sorted(layer)})
    return {"components": layers}


def params_from_jax(np_tree, device="cuda", dtype: torch.dtype = None):
    """The JAX package's ``init_cnf`` params (dicts and lists of arrays,
    e.g. after ``tree_map(np.asarray, params)``) as this package's params:
    the same structure with tensors on ``device`` (dtype kept unless
    ``dtype`` is given)."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device, dtype)
                for k, v in np_tree.items()}
    if isinstance(np_tree, (list, tuple)):
        return type(np_tree)(params_from_jax(v, device, dtype)
                             for v in np_tree)
    return torch.as_tensor(np.array(np_tree), dtype=dtype, device=device)


def component(params, m: int):
    """The m-th component's layer list (views into the stacked leaves)."""
    return [{k: v[m] for k, v in layer.items()}
            for layer in params["components"]]


def _dynamics(net, x, t):
    """concatsquash MLP; x: (B, dim) -> (B, dim)."""
    # the time embedding rides in the STATE dtype: a hardcoded f32 here
    # would demote every gate/bias product of an f64 solve
    tt = t.reshape(1, 1).to(x.dtype)
    h = x
    for i, lp in enumerate(net):
        h = h @ lp["w"] * torch.sigmoid(tt @ lp["wt_gate"]) + \
            lp["b"] + tt @ lp["wt_bias"]
        if i < len(net) - 1:
            h = torch.tanh(h)
    return h


def _differentiated(x, net) -> bool:
    """True when the caller builds a graph through this field evaluation
    (the symplectic backward's per-stage VJP, or DirectBackprop): the
    inner derivative must then itself be differentiable."""
    return torch.is_grad_enabled() and (
        x.requires_grad
        or any(p.requires_grad for p in pytree.tree_leaves(net)))


def _aug_field_hutch(state, t, net):
    x, _, eps = state
    e = eps.detach()
    graph = _differentiated(x, net)
    with torch.enable_grad():  # the trace needs a VJP even under no_grad
        xx = x if x.requires_grad else x.detach().requires_grad_()
        fx = _dynamics(net, xx, t)
        (etJ,) = torch.autograd.grad(fx, xx, e, create_graph=graph)
    if not graph:
        fx, etJ = fx.detach(), etJ.detach()
    tr_est = torch.sum(etJ * e, dim=-1)           # eps^T J eps per sample
    return (fx, -tr_est, torch.zeros_like(eps))


def _aug_field_exact(state, t, net):
    x, _, eps = state
    graph = _differentiated(x, net)
    with torch.enable_grad():
        xx = x if x.requires_grad else x.detach().requires_grad_()
        fx = _dynamics(net, xx, t)
        tr = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for j in range(x.shape[-1]):              # column j of the jacobian
            (gj,) = torch.autograd.grad(fx[:, j].sum(), xx,
                                        create_graph=graph,
                                        retain_graph=True)
            tr = tr + gj[:, j]
    if not graph:
        fx, tr = fx.detach(), tr.detach()
    return (fx, -tr, torch.zeros_like(eps))


def cnf_forward(params, u, eps, cfg: CNFConfig):
    """u: (B, dim) data; eps: (B, dim) Hutchinson noise.
    Returns (z, delta_logp) with log p(u) = log N(z) - delta_logp."""
    field = _aug_field_hutch if cfg.trace == "hutchinson" else \
        _aug_field_exact
    # dlp rides in the solve state: it must share u's dtype, or a mixed
    # f64/f32 state corrupts the adaptive error norm.
    dlp = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    adaptive = AdaptiveConfig(rtol=cfg.rtol, atol=cfg.atol,
                              max_steps=cfg.max_steps) \
        if cfg.adaptive else None
    x = u
    for m in range(cfg.n_components):
        x, dlp_m, _ = model_solve_ys(
            field, (x, torch.zeros_like(dlp), eps), component(params, m),
            per_sample=per_sample_mode(cfg),
            saveat=SaveAt(t1=cfg.t1), method=cfg.method,
            gradient=as_gradient(cfg.grad_mode),
            stepping=adaptive if adaptive is not None else cfg.n_steps,
            backend=cfg.combine_backend)
        dlp = dlp + dlp_m
    return x, dlp


def cnf_nll(params, u, eps, cfg: CNFConfig):
    """Mean negative log-likelihood in nats."""
    z, dlp = cnf_forward(params, u, eps, cfg)
    logpz = -0.5 * torch.sum(z ** 2, -1) - \
        0.5 * cfg.dim * math.log(2 * math.pi)
    return -torch.mean(logpz - dlp)
