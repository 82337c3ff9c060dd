"""PyTorch port: SaveAt (observations at user times) against the JAX package.

Float64 on the CPU, the JAX package's ``tests/test_saveat.py`` problems
(``linear``, ``mlp_field``, ``TS3``) with numpy-seeded inputs, through
``repro.core.solve`` (``backend="jnp"``, jitted) and
``repro_torch.core.solve``.  Bounds:

  * values and gradients against JAX: rtol 1e-10, atol 1e-12 (the earlier
    slices' gradient bound); integer stats exactly equal;
  * the port's symplectic ``ts`` gradient against autograd through its own
    DirectBackprop: rtol 1e-10, atol 1e-12 (``test_saveat.py``'s bound);
  * a zero-length interval is the identity map: value and gradient to
    1e-15 / 1e-12 (``test_saveat.py``).

JAX cannot reverse-differentiate its adaptive DirectBackprop (a
``lax.while_loop``), so the port's is held against JAX's symplectic
gradient, which is exact for the same threaded grid.  The dense cell's
gradient is held against ``jax.grad`` of the JAX package's
``hermite_observe`` over a replay of the accepted grid: JAX's forward mode
through the while loop would also differentiate the controller's step
sizes, which both packages treat as data.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import repro.core as J
from repro.core.api import _as_ts as j_as_ts
import repro_torch.core as T
from repro_torch.core.api import _as_ts as t_as_ts
from repro_torch.core.rk import (hermite_observe, rk_solve_adaptive,
                                 rk_solve_adaptive_saveat_stacked)

RTOL, ATOL = 1e-10, 1e-12
TS3 = (0.25, 0.5, 0.875)
MODES = ("symplectic", "backprop", "remat_step", "remat_solve", "adjoint")
ADAPTIVE_MODES = ("symplectic", "backprop", "adjoint")


def linear(mod):
    def f(x, t, p):
        return p["lam"] * x
    return f


def mlp_field(mod):
    tanh = jnp.tanh if mod is J else torch.tanh

    def f(x, t, p):
        h = tanh(p["w1"] @ x + p["b1"] + t)
        return p["w2"] @ h + p["b2"]
    return f


def _problem(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "linear":
        return rng.normal(size=3), {"lam": np.asarray(-0.7)}
    return rng.normal(size=4), {"w1": rng.normal(size=(6, 4)) * 0.5,
                                "b1": rng.normal(size=6) * 0.1,
                                "w2": rng.normal(size=(4, 6)) * 0.5,
                                "b2": rng.normal(size=4) * 0.1}


FIELDS = {"linear": linear, "mlp": mlp_field}


def _cfg(mod, **kw):
    base = dict(rtol=1e-7, atol=1e-9, max_steps=64, initial_step=0.1)
    base.update(kw)
    return mod.AdaptiveConfig(**base)


def _stepping(mod, kind, **kw):
    return 5 if kind == "fixed" else _cfg(mod, **kw)


def _loss(mod, ys):
    w = np.arange(1.0, 1.0 + ys.shape[0])
    if mod is J:
        return jnp.sum(jnp.asarray(w)[:, None] * jnp.sin(ys) ** 2)
    return torch.sum(torch.tensor(w)[:, None] * torch.sin(ys) ** 2)


@functools.lru_cache(maxsize=None)
def _jax_case(problem, mode, kind, ts=TS3, t0=0.0, method="dopri5"):
    """JAX's observations, stats, loss gradient (x0 first, then params by
    sorted key) for one cell: one jit."""
    x0, params = _problem(problem)
    saveat = J.SaveAt(ts=jnp.asarray(ts))

    def loss(x, p):
        sol = J.solve(FIELDS[problem](J), x, p, saveat=saveat, t0=t0,
                      method=method, gradient=mode,
                      stepping=_stepping(J, kind), backend="jnp")
        return _loss(J, sol.ys), sol

    (_, sol), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True))(
        jnp.asarray(x0), {k: jnp.asarray(v) for k, v in params.items()})
    return (np.asarray(sol.ys), {k: int(v) for k, v in sol.stats.items()},
            bool(sol.success),
            [np.asarray(g[0])] + [np.asarray(g[1][k]) for k in sorted(g[1])])


def _torch_case(problem, mode, kind, ts=TS3, t0=0.0, method="dopri5",
                **cfg_kw):
    x0, params = _problem(problem)
    x = torch.tensor(x0, requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    sol = T.solve(FIELDS[problem](T), x, p, saveat=T.SaveAt(ts=list(ts)),
                  t0=t0, method=method, gradient=mode,
                  stepping=_stepping(T, kind, **cfg_kw))
    g = torch.autograd.grad(_loss(T, sol.ys), [x] + [p[k] for k in sorted(p)])
    return sol, [a.numpy() for a in g]


def _stats(sol):
    return {k: int(v) for k, v in sol.stats.items()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# every strategy's cells on the MLP field; the linear field through the
# symplectic adjoint's
CELLS = [(m, "fixed", "mlp") for m in MODES] + \
    [(m, "adaptive", "mlp") for m in ADAPTIVE_MODES] + \
    [("symplectic", k, "linear") for k in ("fixed", "adaptive")]


@pytest.mark.parametrize("mode,kind,problem", CELLS)
def test_saveat_cells_match_jax(mode, kind, problem):
    """Every strategy's ts cell: observations, stats and the gradient of a
    loss over all three observations against the JAX package's same
    strategy (its symplectic gradient for the adaptive DirectBackprop)."""
    jmode = "symplectic" if (mode, kind) == ("backprop", "adaptive") \
        else mode
    ys_j, stats_j, ok_j, g_j = _jax_case(problem, jmode, kind)
    sol, g = _torch_case(problem, mode, kind)
    assert sol.ys.shape == (3,) + ys_j.shape[1:]
    np.testing.assert_allclose(sol.ys.detach().numpy(), ys_j, rtol=RTOL,
                               atol=ATOL)
    assert torch.equal(sol.final_state, sol.ys[-1])
    assert _stats(sol) == stats_j and bool(sol.success) == ok_j
    _close(g, g_j)


@pytest.mark.parametrize("method", ["dopri5", "bosh3"])
@pytest.mark.parametrize("kind", ["fixed", "adaptive"])
def test_symplectic_ts_gradient_equals_port_backprop(kind, method):
    """Exactness inside torch: the segmented Algorithm 2 equals autograd
    through the same (threaded) segmented solve."""
    sol_s, g_s = _torch_case("mlp", "symplectic", kind, method=method)
    sol_b, g_b = _torch_case("mlp", "backprop", kind, method=method)
    assert _stats(sol_s) == _stats(sol_b)
    assert torch.equal(sol_s.ys, sol_b.ys)
    _close(g_s, g_b)


@pytest.mark.parametrize("kind", ["fixed", "adaptive"])
def test_reverse_repeated_and_zero_length_segments(kind):
    """One solve backwards from t0 = 1 through ts = (1, 0.6, 0.6, 0): a
    zero-length first segment (ts[0] == t0), reverse time and a repeated
    observation time.  Values, stats and the symplectic gradient against
    JAX, and against the port's DirectBackprop.  The zero-length segment
    observes x0 and the repeated time the same state twice."""
    ts, t0 = (1.0, 0.6, 0.6, 0.0), 1.0
    ys_j, stats_j, _, g_j = _jax_case("mlp", "symplectic", kind, ts, t0)
    sol, g = _torch_case("mlp", "symplectic", kind, ts, t0)
    np.testing.assert_allclose(sol.ys.detach().numpy(), ys_j, rtol=RTOL,
                               atol=ATOL)
    assert _stats(sol) == stats_j
    _close(g, g_j)
    _, g_b = _torch_case("mlp", "backprop", kind, ts, t0)
    _close(g, g_b)
    assert torch.equal(sol.ys[1], sol.ys[2])
    x0, _ = _problem("mlp")
    np.testing.assert_allclose(sol.ys[0].detach().numpy(), x0, rtol=0,
                               atol=1e-15)


@pytest.mark.parametrize("mode", MODES)
def test_zero_length_saveat_is_identity(mode):
    """t0 == every observation time: the map is the identity, its gradient
    the ones vector (test_saveat.py's zero-length rule, through SaveAt)."""
    x0, params = _problem("mlp")
    x = torch.tensor(x0, requires_grad=True)
    p = {k: torch.tensor(v) for k, v in params.items()}
    steppings = [4] + ([_cfg(T)] if mode in ADAPTIVE_MODES else [])
    for stepping in steppings:
        sol = T.solve(mlp_field(T), x, p, saveat=T.SaveAt(ts=[0.5, 0.5]),
                      t0=0.5, gradient=mode, stepping=stepping)
        np.testing.assert_allclose(sol.ys.detach().numpy(),
                                   np.stack([x0, x0]), rtol=0, atol=1e-15)
        (g,) = torch.autograd.grad(sol.ys[-1].sum(), x)
        np.testing.assert_allclose(g.numpy(), np.ones(4), rtol=1e-12,
                                   atol=1e-12)


def test_controller_threading_and_restart_rule():
    """The symplectic adjoint and DirectBackprop thread the controller's
    step across the observation boundaries; the continuous adjoint restarts
    it in every segment (the JAX package's rule).  Read through the stats:
    each equals JAX's exactly, and a tiny initial step costs the restarting
    strategy its doublings again in the second segment."""
    ts = (0.5, 1.0)
    kw = dict(initial_step=1e-4, rtol=1e-6, atol=1e-8)
    stats = {}
    x0, params = _problem("linear")
    for mode in ADAPTIVE_MODES:
        sol_t = T.solve(linear(T), torch.tensor(x0),
                        {"lam": torch.tensor(params["lam"])},
                        saveat=T.SaveAt(ts=list(ts)), gradient=mode,
                        stepping=_cfg(T, **kw))
        stats[mode] = _stats(sol_t)
    # JAX's forward of one threading and one restarting strategy
    for mode in ("symplectic", "adjoint"):
        sol_j = J.solve(linear(J), jnp.asarray(x0),
                        {"lam": jnp.asarray(params["lam"])},
                        saveat=J.SaveAt(ts=jnp.asarray(ts)), gradient=mode,
                        stepping=_cfg(J, **kw), backend="jnp")
        assert stats[mode] == {k: int(v) for k, v in sol_j.stats.items()}
    assert stats["symplectic"] == stats["backprop"]
    assert stats["adjoint"]["n_steps"] > stats["symplectic"]["n_steps"]
    # per segment: the threaded second segment continues at the grown step
    _, sols = rk_solve_adaptive_saveat_stacked(
        linear(T), T.get_tableau("dopri5"), torch.ones(2, dtype=torch.float64),
        0.0, torch.tensor(ts, dtype=torch.float64),
        {"lam": torch.tensor(-0.7, dtype=torch.float64)}, _cfg(T, **kw))
    assert all(s.succeeded for s in sols)
    assert sols[1].n_accepted <= sols[0].n_accepted // 2


TAUS = (0.1, 0.37, 0.52, 0.81, 1.0)
DENSE_KW = dict(rtol=1e-8, atol=1e-10, max_steps=256, initial_step=0.02)


def test_dense_output_matches_jax_and_exact():
    """SaveAt(ts, dense=True) with DirectBackprop: one unsegmented solve
    whose stats equal the unobserved solve's plus 2 f-evals per
    observation, values against JAX and the closed form, and the gradient
    against jax.grad of JAX's Hermite observation of the replayed grid."""
    from repro.core.rk import hermite_observe as j_hermite
    from repro.core.rk import rk_solve_adaptive as j_solve
    from repro.core.rk import rk_step as j_step
    x0 = np.array([1.0, -2.0])
    lam = -0.7
    taus, cfg_j = jnp.asarray(TAUS), J.AdaptiveConfig(**DENSE_KW)
    sol_j = J.solve(linear(J), jnp.asarray(x0), {"lam": jnp.asarray(lam)},
                    saveat=J.SaveAt(ts=taus, dense=True),
                    gradient="backprop", stepping=cfg_j, backend="jnp")
    tab_j = J.get_tableau("dopri5")
    grid = j_solve(linear(J), tab_j, jnp.asarray(x0), 0.0, 1.0,
                   {"lam": jnp.asarray(lam)}, cfg_j, "jnp")
    n = int(grid.n_accepted)

    def replay(x, l):
        def step(x, th):
            return j_step(linear(J), tab_j, x, th[0], th[1], {"lam": l})[0], x
        x, xs = jax.lax.scan(step, x, (grid.ts[:n], grid.hs[:n]))
        buf = jnp.zeros_like(grid.xs).at[:n].set(xs)
        ys = j_hermite(linear(J), tab_j, grid._replace(xs=buf, x_final=x),
                       {"lam": l}, taus, "jnp")
        return jnp.sum(jnp.sin(ys))

    jx, jl = jax.jit(jax.grad(replay, argnums=(0, 1)))(jnp.asarray(x0),
                                                       jnp.asarray(lam))
    x = torch.tensor(x0, requires_grad=True)
    lt = torch.tensor(lam, dtype=torch.float64, requires_grad=True)
    sol = T.solve(linear(T), x, {"lam": lt},
                  saveat=T.SaveAt(ts=list(TAUS), dense=True),
                  gradient="backprop", stepping=T.AdaptiveConfig(**DENSE_KW))
    assert bool(sol.success)
    assert _stats(sol) == {k: int(v) for k, v in sol_j.stats.items()}
    np.testing.assert_allclose(sol.ys.detach().numpy(), np.asarray(sol_j.ys),
                               rtol=RTOL, atol=ATOL)
    exact = x0 * np.exp(lam * np.asarray(TAUS))[:, None]
    np.testing.assert_allclose(sol.ys.detach().numpy(), exact, rtol=1e-6)
    plain = T.solve(linear(T), x, {"lam": lt}, saveat=T.SaveAt(t1=1.0),
                    gradient="backprop", stepping=T.AdaptiveConfig(**DENSE_KW))
    assert int(sol.stats["n_steps"]) == int(plain.stats["n_steps"])
    assert int(sol.stats["n_fevals"]) == \
        int(plain.stats["n_fevals"]) + 2 * len(TAUS)
    gx, gl = torch.autograd.grad(torch.sum(torch.sin(sol.ys)), [x, lt])
    _close([gx.numpy(), gl.numpy()], [np.asarray(jx), np.asarray(jl)])


def test_dense_output_endpoints_and_degenerate_solve():
    """At the accepted steps' start times the interpolant returns the
    checkpoints (theta 0); a solve that accepts no step returns x_final at
    every tau."""
    tab = T.get_tableau("dopri5")
    p = {"lam": torch.tensor(-0.7, dtype=torch.float64)}
    x0 = torch.tensor([0.3, 1.7], dtype=torch.float64)
    cfg = T.AdaptiveConfig(rtol=1e-6, atol=1e-8, max_steps=64,
                           initial_step=0.1)
    sol = rk_solve_adaptive(linear(T), tab, x0, 0.0, 1.0, p, cfg)
    n = sol.n_accepted
    assert n > 3
    taus = torch.stack(sol.ts[1:n])
    ys = hermite_observe(linear(T), tab, sol, p, taus)
    np.testing.assert_allclose(ys.numpy(), torch.stack(sol.xs[1:n]).numpy(),
                               rtol=1e-12, atol=1e-14)
    still = rk_solve_adaptive(linear(T), tab, x0, 0.5, 0.5, p, cfg)
    assert still.n_accepted == 0
    ys = hermite_observe(linear(T), tab, still, p,
                         torch.tensor([0.5, 0.5], dtype=torch.float64))
    assert torch.equal(ys, torch.stack([x0, x0]))


def test_as_ts_validation_matches_jax():
    """_as_ts: the same errors (text) as the JAX package's, the cast to the
    state's time dtype, and duplicates and reverse time legal."""
    bad = [(np.zeros((2, 2)), None, "non-empty 1-D"),
           (np.zeros((0,)), None, "non-empty 1-D"),
           (np.array([0.2, 0.1, 0.3]), None, "monotone"),
           (np.array([0.5, 1.0]), 0.7, "monotone")]
    for ts, t0, msg in bad:
        with pytest.raises(ValueError, match=msg) as ej:
            j_as_ts(ts, jnp.float64, t0)
        with pytest.raises(ValueError, match=msg) as et:
            t_as_ts(ts, torch.float64, "cpu", t0)
        assert str(ej.value).split(";")[0] == str(et.value).split(";")[0]
    for ts, t0 in (([0.5, 0.5, 1.0], 0.0), ([0.6, 0.3, 0.0], 1.0)):
        got = t_as_ts(ts, torch.float64, "cpu", t0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ts))
    assert t_as_ts([0.1], torch.float32, "cpu").dtype == torch.float32
    # Python floats are read as float64 before the cast (torch's default
    # float32 would move 0.4 by 6e-9)
    assert float(t_as_ts([0.4], torch.float64, "cpu")) == 0.4
    with pytest.raises(ValueError, match="EITHER t1 or ts"):
        T.SaveAt(t1=1.0, ts=[0.5])
    with pytest.raises(ValueError, match="dense"):
        T.SaveAt(t1=1.0, dense=True)


def test_capability_matrices_equal_jax_on_every_cell():
    assert T.capability_matrix() == J.capability_matrix()
    assert T.batched_capability_matrix() == J.batched_capability_matrix()
    x0, params = _problem("linear")
    x, p = torch.tensor(x0), {"lam": torch.tensor(params["lam"])}
    dense = T.SaveAt(ts=list(TS3), dense=True)
    with pytest.raises(ValueError, match="dense"):
        T.solve(linear(T), x, p, saveat=dense, gradient="symplectic",
                stepping=_cfg(T))
    with pytest.raises(ValueError, match="dense"):
        T.solve(linear(T), x, p, saveat=dense, gradient="backprop",
                stepping=4)


def test_symplectic_saveat_keeps_only_segment_checkpoints():
    """Algorithm 1 per segment: the forward keeps each segment's
    checkpoints (n_steps per fixed segment, the accepted steps of an
    adaptive one) and the params; the output's graph is the one
    autograd.Function node."""
    x0, params = _problem("mlp")
    x = torch.tensor(x0, requires_grad=True)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    sol = T.solve(mlp_field(T), x, p, saveat=T.SaveAt(ts=list(TS3)),
                  stepping=4)
    fn = sol.ys.grad_fn
    assert type(fn).__name__ == "_SymplecticSaveAtBackward"
    assert [len(xs) for xs, _, _ in fn.segs] == [4, 4, 4]
    assert len(fn.saved_tensors) == len(p)
    sol = T.solve(mlp_field(T), x, p, saveat=T.SaveAt(ts=list(TS3)),
                  stepping=_cfg(T))
    assert sum(len(xs) for xs, _, _ in sol.ys.grad_fn.segs) == \
        int(sol.stats["n_steps"])
