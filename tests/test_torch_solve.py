"""PyTorch port: solve() forward, stats and gradients against the JAX package.

Float64 on the CPU, a two-leaf MLP field, the same inputs for both
packages.  Forward values must agree to rounding and the integer solver
stats exactly; the symplectic gradients must agree with JAX's; and inside
torch the symplectic gradient must equal autograd through the solver
(DirectBackprop on a fixed grid, an unrolled replay of the accepted grid on
an adaptive solve) — the paper's exactness claim.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import repro.core as J
import repro_torch.core as T
from repro_torch.core.rk import rk_solve_adaptive, rk_step

RTOL_X = 1e-12                      # forward state, float64
RTOL_G, ATOL_G = 1e-10, 1e-12       # gradients, float64
RTOL_EXACT = 1e-10                  # symplectic vs autograd, float64


def _problem(seed=0, d=4, hidden=6):
    rng = np.random.default_rng(seed)
    params = {"w1": rng.normal(size=(hidden, d)) * 0.6,
              "b1": rng.normal(size=hidden),
              "w2": rng.normal(size=(d, hidden)) * 0.6,
              "b2": rng.normal(size=d),
              "c": rng.normal(size=(3,)) * 0.5}
    x0 = (rng.normal(size=d), rng.normal(size=(2, 3)))
    return x0, params


def field_jax(state, t, p):
    x, v = state
    h = jnp.tanh(p["w1"] @ x + p["b1"] + t)
    return (p["w2"] @ h + p["b2"], -v * p["c"] + jnp.sin(t) * x[:3])


def field_torch(state, t, p):
    x, v = state
    h = torch.tanh(p["w1"] @ x + p["b1"] + t)
    return (p["w2"] @ h + p["b2"], -v * p["c"] + torch.sin(t) * x[:3])


def _stats(sol):
    return {k: int(v) for k, v in sol.stats.items()}, bool(sol.success)


def _cfg(mod, **kw):
    base = dict(rtol=1e-7, atol=1e-9, max_steps=64, initial_step=0.1)
    base.update(kw)
    return mod.AdaptiveConfig(**base)


STEPPINGS = {"fixed": lambda mod: 3, "adaptive": lambda mod: _cfg(mod)}


def _loss_jax(x0, p, **kw):
    sol = J.solve(field_jax, x0, p, backend="jnp", **kw)
    x, v = sol.ys
    return jnp.sum(jnp.tanh(x) ** 2) + jnp.sum(v ** 3), sol


def _loss_torch(x0, p, **kw):
    sol = T.solve(field_torch, x0, p, **kw)
    x, v = sol.ys
    return torch.sum(torch.tanh(x) ** 2) + torch.sum(v ** 3), sol


def _torch_inputs(x0, params):
    xt = tuple(torch.tensor(l, requires_grad=True) for l in x0)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    return xt, pt


@functools.lru_cache(maxsize=None)
def _jax_grads(seed, stepping):
    """JAX's symplectic loss and gradients (computed once per case: the
    port's backends share them)."""
    x0, params = _problem(seed)
    loss = functools.partial(_loss_jax, method="dopri5",
                             gradient="symplectic",
                             stepping=STEPPINGS[stepping](J))
    # jitted: one compile of the whole loss is cheaper than eager dispatch
    (val, _), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True))(
        tuple(jnp.asarray(l) for l in x0),
        {k: jnp.asarray(v) for k, v in params.items()})
    return val, list(g[0]) + [g[1][k] for k in sorted(params)]


@functools.lru_cache(maxsize=None)
def _jax_solve(seed, method, stepping):
    return _jax_solution(seed, method, STEPPINGS[stepping](J))


def _jax_solution(seed, method, stepping):
    x0, params = _problem(seed)
    sol = jax.jit(functools.partial(J.solve, field_jax, method=method,
                                    stepping=stepping, backend="jnp"))(
        tuple(jnp.asarray(l) for l in x0),
        {k: jnp.asarray(v) for k, v in params.items()})
    return sol.ys, _stats(sol)


def _torch_grads(x0, params, **kw):
    xt, pt = _torch_inputs(x0, params)
    val, sol = _loss_torch(xt, pt, **kw)
    g = torch.autograd.grad(val, list(xt) + [pt[k] for k in sorted(pt)])
    return val, sol, list(g)




@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("stepping", sorted(STEPPINGS))
@pytest.mark.parametrize("method", ["dopri5", "bosh3"])
def test_forward_and_stats_match_jax(method, stepping, backend):
    x0, params = _problem()
    ys_j, stats_j = _jax_solve(0, method, stepping)
    st = T.solve(field_torch, tuple(torch.tensor(l) for l in x0),
                 {k: torch.tensor(v) for k, v in params.items()},
                 method=method, stepping=STEPPINGS[stepping](T),
                 backend=backend)
    for a, b in zip(st.ys, ys_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_X)
    assert _stats(st) == stats_j
    if stepping == "adaptive":
        assert _stats(st)[0]["n_attempts"] > _stats(st)[0]["n_steps"] > 3


@pytest.mark.parametrize("policy", ["nan", "ignore", "raise"])
def test_exhausted_budget_matches_jax(policy):
    """max_steps too small to reach t1: success is False, the stats equal
    JAX's, and on_failure decides what x_final is.

    The truncated state sits at t_2 = h_0 + h_1, and h_1 = h_0 * factor
    comes from the embedded error estimate, a cancellation whose last bits
    differ between XLA and PyTorch (~1e-11 relative in h).  A small
    initial step makes the first factor hit max_factor in both, so t_2 is
    exact and the truncated states compare at the forward tolerance."""
    x0, params = _problem(1)
    xt = tuple(torch.tensor(l) for l in x0)
    pt = {k: torch.tensor(v) for k, v in params.items()}
    cfg = _cfg(T, max_steps=2, on_failure=policy, initial_step=1e-3)
    if policy == "raise":
        with pytest.raises(RuntimeError, match="max_steps"):
            T.solve(field_torch, xt, pt, stepping=cfg)
        return
    st = T.solve(field_torch, xt, pt, stepping=cfg)
    ys_j, stats_j = _jax_solution(
        1, "dopri5", _cfg(J, max_steps=2, on_failure=policy,
                          initial_step=1e-3))
    assert not bool(st.success)
    assert _stats(st) == stats_j
    for a, b in zip(st.ys, ys_j):
        if policy == "nan":
            assert torch.isnan(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_X)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("stepping", sorted(STEPPINGS))
def test_symplectic_gradients_match_jax(stepping, backend):
    x0, params = _problem(2)
    vj, gj = _jax_grads(2, stepping)
    vt, _, gt = _torch_grads(x0, params, stepping=STEPPINGS[stepping](T),
                             backend=backend, method="dopri5",
                             gradient="symplectic")
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=RTOL_X)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_G,
                                   atol=ATOL_G)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("method", ["dopri5", "bosh3", "rk4", "dopri8"])
def test_symplectic_equals_backprop_fixed(method, backend):
    """Exactness inside torch: Algorithm 2 == autograd through the solver,
    including tableaus with b_i = 0 stages (dopri5, bosh3: Eq. 8)."""
    x0, params = _problem(3)
    kw = dict(method=method, stepping=4, backend=backend)
    _, _, g_sym = _torch_grads(x0, params, gradient="symplectic", **kw)
    _, _, g_bp = _torch_grads(x0, params, gradient="backprop", **kw)
    for a, b in zip(g_sym, g_bp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL_EXACT,
                                   atol=1e-13)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_adaptive_symplectic_equals_grid_replay(backend):
    """Adaptive forward + symplectic backward == autograd through an
    unrolled replay of the recorded accepted steps {t_n, h_n}."""
    x0, params = _problem(4)
    tab = T.get_tableau("dopri5")
    cfg = _cfg(T)
    with torch.no_grad():
        sol = rk_solve_adaptive(field_torch, tab,
                                tuple(torch.tensor(l) for l in x0), 0.0, 1.0,
                                {k: torch.tensor(v) for k, v in
                                 params.items()}, cfg, backend)
    assert 3 < sol.n_accepted < cfg.max_steps and sol.succeeded

    xt, pt = _torch_inputs(x0, params)
    x = xt
    for t, h in zip(sol.ts, sol.hs):
        x, _ = rk_step(field_torch, tab, x, t, h, pt)
    replay = torch.sum(torch.tanh(x[0]) ** 2) + torch.sum(x[1] ** 3)
    g_ref = torch.autograd.grad(replay, list(xt) + [pt[k] for k in
                                                    sorted(pt)])
    val, st, g_sym = _torch_grads(x0, params, gradient="symplectic",
                                  stepping=cfg, backend=backend)
    np.testing.assert_allclose(float(val.detach()), float(replay.detach()),
                               rtol=RTOL_X)
    assert int(st.stats["n_steps"]) == sol.n_accepted
    # autograd through the same adaptive solve agrees too: the controller's
    # accepted grid is data to autograd (core/stepper.py).
    _, _, g_bp = _torch_grads(x0, params, gradient="backprop", stepping=cfg,
                              backend=backend)
    for a, b, c in zip(g_sym, g_ref, g_bp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL_EXACT,
                                   atol=1e-13)
        np.testing.assert_allclose(c.numpy(), b.numpy(), rtol=RTOL_EXACT,
                                   atol=1e-13)


def test_unported_cells_name_their_roadmap_item():
    x0, params = _problem()
    xt = tuple(torch.tensor(l) for l in x0)
    pt = {k: torch.tensor(v) for k, v in params.items()}
    for name in ("remat_step", "remat_solve", "adjoint"):
        with pytest.raises(ValueError, match="ROADMAP queue 1 item 7"):
            T.solve(field_torch, xt, pt, gradient=name)
    with pytest.raises(ValueError, match="item 9"):
        T.solve(field_torch, xt, pt, saveat=T.SaveAt(ts=[0.5, 1.0]))
    with pytest.raises(ValueError, match="item 10"):
        T.solve(field_torch, xt, pt, batch_axis=0)
    with pytest.raises(ValueError, match="unknown gradient strategy"):
        T.solve(field_torch, xt, pt, gradient="nope")
    # every cell the port offers is one the JAX package offers
    jm, tm = J.capability_matrix(), T.capability_matrix()
    for name, cells in tm.items():
        for cell, ok in cells.items():
            assert not ok or jm[name][cell], (name, cell)
    assert tm["symplectic"][("fixed", "t1")]
    assert tm["backprop"][("adaptive", "t1")]


def test_symplectic_forward_keeps_no_stage_graph():
    """Algorithm 1: the forward saves only {x_n, t_n, h_n}; the output's
    graph is the one autograd.Function node, not the solver's stages."""
    x0, params = _problem(5)
    xt, pt = _torch_inputs(x0, params)
    sol = T.solve(field_torch, xt, pt, stepping=5)
    fn = sol.ys[0].grad_fn
    assert type(fn).__name__ == "_SymplecticSolveBackward"
    assert len(fn.xs) == 5 and len(fn.ts) == 5
    assert all(not l.requires_grad for x in fn.xs[1:] for l in x)
