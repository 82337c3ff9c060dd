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
    """No cell of the JAX package's table is left unported: the port's
    capability matrix equals JAX's on every cell (t1, ts and dense), and
    an illegal cell fails with the uniform message naming the legal
    ones."""
    x0, params = _problem()
    xt = tuple(torch.tensor(l) for l in x0)
    pt = {k: torch.tensor(v) for k, v in params.items()}
    names = ("symplectic", "backprop", "remat_step", "remat_solve",
             "adjoint")
    jm, tm = J.capability_matrix(), T.capability_matrix()
    assert sorted(tm) == sorted(names)
    assert tm == jm
    assert tm["remat_step"][("fixed", "ts")]
    assert not tm["remat_solve"][("adaptive", "t1")]
    assert tm["adjoint"][("adaptive", "ts")]
    dense = T.SaveAt(ts=[0.5, 1.0], dense=True)
    for name in names:
        if name == "backprop":
            continue
        with pytest.raises(ValueError, match="legal.*combinations"):
            T.solve(field_torch, xt, pt, gradient=name, saveat=dense,
                    stepping=_cfg(T))
    with pytest.raises(ValueError, match="unknown gradient strategy"):
        T.solve(field_torch, xt, pt, gradient="nope")
    assert "item 9" not in T.solve.__doc__ + T.SaveAt.__doc__


def test_symplectic_forward_keeps_no_stage_graph():
    """Algorithm 1: the forward saves only {x_n, t_n, h_n}; the output's
    graph is the one autograd.Function node (the t1 solve is its one
    segment), not the solver's stages."""
    x0, params = _problem(5)
    xt, pt = _torch_inputs(x0, params)
    sol = T.solve(field_torch, xt, pt, stepping=5)
    fn = sol.ys[0].grad_fn
    assert type(fn).__name__ == "_SymplecticSaveAtBackward"
    (xs, ts, hs), = fn.segs
    assert len(xs) == 5 and len(ts) == 5
    assert all(not l.requires_grad for x in xs[1:] for l in x)


# ---------------------------------------------------------------------------
# parameter leaves a stage does not use: None through Algorithm 2, zeros
# made once at the end
# ---------------------------------------------------------------------------

def _unit_problem(seed=6, d=4, R=3):
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=d)
    params = {"units": [rng.normal(size=(d, d)) * 0.5 for _ in range(R)],
              "b": rng.normal(size=d),
              "unused": rng.normal(size=(2, 3))}
    return x0, params


def unit_field(x, t, p):
    """Runs one of R units per evaluation, picked by t (as the LM's depth
    field does); never reads ``p["unused"]``."""
    R = len(p["units"])
    w = p["units"][min(int(float(t) * R), R - 1)]
    return torch.tanh(w @ x + p["b"])


UNIT_SAVEATS = {"t1": lambda: T.SaveAt(t1=1.0),
                "ts": lambda: T.SaveAt(ts=torch.tensor([0.4, 1.0],
                                                       dtype=torch.float64))}


def _unit_grads(gradient, stepping, saveat):
    x0, params = _unit_problem()
    x = torch.tensor(x0, requires_grad=True)
    p = {"units": [torch.tensor(u, requires_grad=True)
                   for u in params["units"]],
         "b": torch.tensor(params["b"], requires_grad=True),
         "unused": torch.tensor(params["unused"], requires_grad=True)}
    sol = T.solve(unit_field, x, p, gradient=gradient, method="dopri5",
                  stepping=stepping, saveat=UNIT_SAVEATS[saveat]())
    loss = torch.sum(torch.tanh(sol.ys) ** 2)
    leaves = [x, *p["units"], p["b"], p["unused"]]
    # DirectBackprop's graph never reaches the unused leaf: its None is
    # materialised; the symplectic Function returns a tensor for every leaf
    bp = gradient == "backprop"
    return leaves, torch.autograd.grad(loss, leaves, allow_unused=bp,
                                       materialize_grads=bp)


@pytest.mark.parametrize("saveat", sorted(UNIT_SAVEATS))
@pytest.mark.parametrize("stepping", sorted(STEPPINGS))
def test_unused_parameter_leaf_gets_an_exact_zero(stepping, saveat):
    """A field that never reads one leaf and runs one unit per evaluation:
    Algorithm 2 carries the untouched leaves' cotangents as None, and the
    gradient of the unused leaf is an exact zero like the leaf; every other
    leaf equals DirectBackprop through the same solve."""
    stepping = STEPPINGS[stepping](T)
    leaves, g_sym = _unit_grads("symplectic", stepping, saveat)
    _, g_bp = _unit_grads("backprop", stepping, saveat)
    unused = g_sym[-1]
    assert (unused.shape, unused.dtype, unused.device) == \
        (leaves[-1].shape, leaves[-1].dtype, leaves[-1].device)
    assert torch.count_nonzero(unused) == 0
    for a, b in zip(g_sym[:-1], g_bp[:-1]):
        assert float(b.abs().max()) > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL_EXACT,
                                   atol=1e-13)


def test_symplectic_step_adjoint_returns_a_dense_tree():
    """The public one-step backward keeps its contract: a gradient tensor
    for every parameter leaf, zeros (like the leaf) where the step's stages
    used none, and the same numbers as the internal step."""
    from repro_torch.core.symplectic import _step_adjoint
    x0, params = _unit_problem()
    x = torch.tensor(x0)
    p = {"units": [torch.tensor(u) for u in params["units"]],
         "b": torch.tensor(params["b"]), "unused": torch.tensor(
             params["unused"])}
    tab = T.get_tableau("dopri5")
    t, h = torch.tensor(0.1, dtype=torch.float64), \
        torch.tensor(0.05, dtype=torch.float64)
    lam = torch.tensor(np.random.default_rng(7).normal(size=x.shape))
    lam_n, g = T.symplectic_step_adjoint(unit_field, tab, x, t, h, p, lam)
    with torch.no_grad():
        lam_s, g_s = _step_adjoint(unit_field, tab, x, t, h, p, lam,
                                   T.get_combiner(tab))
    assert g_s["unused"] is None and g_s["units"][2] is None
    assert torch.equal(lam_n, lam_s)
    for name, leaf, got, sparse in zip(
            ["units0", "units1", "units2", "b", "unused"],
            [*p["units"], p["b"], p["unused"]],
            [*g["units"], g["b"], g["unused"]],
            [*g_s["units"], g_s["b"], g_s["unused"]]):
        assert isinstance(got, torch.Tensor), name
        assert (got.shape, got.dtype) == (leaf.shape, leaf.dtype), name
        if sparse is None:
            assert torch.count_nonzero(got) == 0, name
        else:
            assert torch.equal(got, sparse), name
    assert float(g["units"][0].abs().max()) > 0
