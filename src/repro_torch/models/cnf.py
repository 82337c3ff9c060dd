"""Continuous normalizing flow (FFJORD) — the paper's Table 2 workload.

M stacked neural-ODE components; each integrates the augmented state
(x, logp_delta, eps) where d(logp_delta)/dt = -Tr(df/dx), estimated by the
Hutchinson estimator eps^T (df/dx) eps (eps fixed per solve, carried in the
state with zero dynamics so every gradient mode — including the symplectic
adjoint — sees a plain augmented ODE).  ``trace="exact"`` uses the exact
jacobian trace for small dims (tests).

``per_sample=True`` (adaptive only) gives every sample its own step
controller (``solve(..., batch_axis=0)``, models/per_sample.py).  The
lane-batched driver evaluates the field under ``torch.func.vmap``, where a
leaf cannot be made to require grad, so that mode takes the fields' inner
VJP with ``torch.func.vjp``; the lockstep mode takes it with
``torch.autograd.grad``, which costs the host less (``_field_vjp``).

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
import functools
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
    # per-sample adaptive step control (solve(..., batch_axis=0)): each data
    # point gets its own accepted grid, error norm and accept/reject, so one
    # hard sample does not drag the whole batch's f-eval count, and each
    # sample's likelihood is tolerance-controlled on its own.  Adaptive
    # solves only.
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


def _field_vjp(net, x, t, func: bool):
    """(f(x), vjp_fn) of the dynamics at (x, t), as ``torch.func.vjp``
    returns them.  ``func=True`` takes ``torch.func.vjp`` itself: safe under
    ``torch.func`` transforms (the lane-batched driver's vmap).  Otherwise
    ``torch.autograd.grad`` on a leaf made here, which costs the host less
    per call (the lockstep solves are host-bound); f and the
    cotangents are then differentiable exactly when the caller builds a
    graph through this evaluation (the symplectic backward's per-stage VJP,
    or DirectBackprop), and the VJP runs even under no_grad."""
    fn = functools.partial(_dynamics, net, t=t)
    if func:
        return torch.func.vjp(fn, x)
    graph = torch.is_grad_enabled() and (
        x.requires_grad
        or any(p.requires_grad for p in pytree.tree_leaves(net)))
    with torch.enable_grad():
        xx = x if x.requires_grad else x.detach().requires_grad_()
        fx = fn(xx)

    def vjp_fn(v):
        with torch.enable_grad():
            g = torch.autograd.grad(fx, xx, v, create_graph=graph,
                                    retain_graph=True)
        return g if graph else tuple(gi.detach() for gi in g)
    return (fx if graph else fx.detach()), vjp_fn


def _aug_field_hutch(state, t, net, func: bool = False):
    x, _, eps = state
    e = eps.detach()
    fx, vjp_fn = _field_vjp(net, x, t, func)
    (etJ,) = vjp_fn(e)
    tr_est = torch.sum(etJ * e, dim=-1)           # eps^T J eps per sample
    return (fx, -tr_est, torch.zeros_like(eps))


def _aug_field_exact(state, t, net, func: bool = False):
    x, _, eps = state
    fx, vjp_fn = _field_vjp(net, x, t, func)
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    tr = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):                  # column j of the jacobian
        (gj,) = vjp_fn(eye[j].expand_as(fx))
        tr = tr + gj[:, j]
    return (fx, -tr, torch.zeros_like(eps))


def cnf_field(cfg: CNFConfig):
    """The augmented field ``cnf_forward`` solves for ``cfg``: the
    Hutchinson or the exact trace, with the ``torch.func`` VJP in
    per-sample mode."""
    field = _aug_field_hutch if cfg.trace == "hutchinson" else \
        _aug_field_exact
    return functools.partial(field, func=True) if per_sample_mode(cfg) \
        else field


def cnf_forward(params, u, eps, cfg: CNFConfig):
    """u: (B, dim) data; eps: (B, dim) Hutchinson noise.
    Returns (z, delta_logp) with log p(u) = log N(z) - delta_logp."""
    per_sample = per_sample_mode(cfg)
    field = cnf_field(cfg)
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
            per_sample=per_sample,
            saveat=SaveAt(t1=cfg.t1), method=cfg.method,
            gradient=as_gradient(cfg.grad_mode),
            stepping=adaptive if adaptive is not None else cfg.n_steps,
            backend=cfg.combine_backend)
        dlp = dlp + dlp_m
    return x, dlp


def cnf_flow_path(params, u, eps, cfg: CNFConfig, ts):
    """Observe the flow (x(t), delta_logp(t)) along the likelihood path.

    ``ts``: observation times within (0, cfg.t1]; ts[-1] should be cfg.t1
    so each component hands its successor the fully transported state (the
    solve ends at ts[-1]).  Returns (xs, dlps) stacked over
    n_components * len(ts) path points: xs[k] is the state after the
    (k // len(ts))-th component has flowed to ts[k % len(ts)], and dlps is
    the CUMULATIVE log-density change up to that point — one
    multi-observation solve per component instead of len(ts) restarts.
    """
    per_sample = per_sample_mode(cfg)
    field = cnf_field(cfg)
    dlp = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    adaptive = AdaptiveConfig(rtol=cfg.rtol, atol=cfg.atol,
                              max_steps=cfg.max_steps) \
        if cfg.adaptive else None
    x, xs_path, dlp_path = u, [], []
    for m in range(cfg.n_components):
        xo, dlpo, _ = model_solve_ys(
            field, (x, torch.zeros_like(dlp), eps), component(params, m),
            per_sample=per_sample,
            saveat=SaveAt(ts=ts), method=cfg.method,
            gradient=as_gradient(cfg.grad_mode),
            stepping=adaptive if adaptive is not None else cfg.n_steps,
            backend=cfg.combine_backend)
        xs_path.append(xo)
        dlp_path.append(dlp[None] + dlpo)
        x, dlp = xo[-1], dlp + dlpo[-1]
    # M x (len(ts), ...) -> (M * len(ts), ...)
    return torch.cat(xs_path), torch.cat(dlp_path)


def cnf_nll(params, u, eps, cfg: CNFConfig):
    """Mean negative log-likelihood in nats."""
    z, dlp = cnf_forward(params, u, eps, cfg)
    logpz = -0.5 * torch.sum(z ** 2, -1) - \
        0.5 * cfg.dim * math.log(2 * math.pi)
    return -torch.mean(logpz - dlp)
