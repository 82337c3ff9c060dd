"""PyTorch port: the paper's baseline gradient strategies against the JAX
package — ``RematStep``, ``RematSolve`` and ``ContinuousAdjoint`` (fixed,
adaptive, lane-batched).

Float64 on the CPU, the inputs of ``tests/test_torch_solve.py`` (a two-leaf
MLP field) and of ``tests/test_torch_batch.py`` (the lane oscillator),
through ``repro.core.solve`` (``backend="jnp"``, jitted) and
``repro_torch.core.solve``.  Bounds:

  * remat vs the port's DirectBackprop: rtol 1e-12, atol 1e-14 (the JAX
    package's ``test_remat_modes_gradient_exact``): both are autograd
    through the same solver arithmetic;
  * every strategy vs the JAX package's same strategy: rtol 1e-10, atol
    1e-12 (``test_torch_solve.py``'s gradient bound); adaptive integer
    stats exactly equal;
  * the lane-batched adjoint per lane vs single-lane adjoint solves: 1e-9
    (``test_torch_batch.py``'s LOOP_TOL).

The adjoint's adaptive backward solve takes its own accepted grid, and
the controllers of the two libraries agree in their step sizes only to
~1e-11 relative (ROADMAP queue 3): the adaptive cases use rtol 1e-7 /
atol 1e-9 forward and 1e-9 / 1e-11 for the tighter backward config, where
no error norm of either solve lies within that of the accept edge.
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
from repro_torch.core import adjoint as tadjoint

from test_torch_batch import (B, LOOP_TOL, osc_jax, osc_torch,
                              _cfg as _osc_cfg, _problem as _osc_problem,
                              _stats as _lane_stats)
from test_torch_solve import (_cfg, _problem, _stats, _torch_grads,
                              field_jax, field_torch)

RTOL_REMAT, ATOL_REMAT = 1e-12, 1e-14   # remat vs DirectBackprop
RTOL_G, ATOL_G = 1e-10, 1e-12           # vs the JAX package's same strategy
BACKENDS = ("torch", "cuda")
METHODS = ("dopri5", "bosh3")
N_FIXED = 3

# the adjoint's cells: (stepping, gradient knobs) in each package
ADJOINT_CASES = {
    "fixed": (lambda mod: N_FIXED, {}),
    "fixed_x2": (lambda mod: N_FIXED, {"steps_multiplier": 2}),
    "adaptive": (lambda mod: _cfg(mod), {}),
    "adaptive_tight_bwd": (lambda mod: _cfg(mod), {
        "bwd_adaptive": lambda mod: _cfg(mod, rtol=1e-9, atol=1e-11)}),
}


def _adjoint(mod, case):
    knobs = {k: (v(mod) if callable(v) else v)
             for k, v in ADJOINT_CASES[case][1].items()}
    return mod.ContinuousAdjoint(**knobs)


def _loss_jax(x0, p, **kw):
    sol = J.solve(field_jax, x0, p, backend="jnp", **kw)
    x, v = sol.ys
    return jnp.sum(jnp.tanh(x) ** 2) + jnp.sum(v ** 3), sol.stats


@functools.lru_cache(maxsize=None)
def _jax_grads(seed, method, gradient, stepping):
    """JAX's loss, stats and gradients for one (strategy, stepping) cell,
    one jit each.  ``gradient`` is a strategy name or an ADJOINT_CASES key
    (the stepping then comes from the case)."""
    x0, params = _problem(seed)
    if gradient in ADJOINT_CASES:
        stepping = ADJOINT_CASES[gradient][0](J)
        gradient = _adjoint(J, gradient)
    loss = functools.partial(_loss_jax, method=method, gradient=gradient,
                             stepping=stepping)
    (val, stats), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                 has_aux=True))(
        tuple(jnp.asarray(l) for l in x0),
        {k: jnp.asarray(v) for k, v in params.items()})
    return (float(val), {k: int(v) for k, v in stats.items()},
            list(g[0]) + [g[1][k] for k in sorted(params)])


def _close(got, want, rtol, atol):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# RematStep / RematSolve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("mode", ["remat_step", "remat_solve"])
def test_remat_equals_backprop(mode, method, backend):
    """Rematerialization is autograd through the same solver: its gradient
    equals DirectBackprop's at the JAX package's remat bound."""
    x0, params = _problem(3)
    kw = dict(method=method, stepping=5, backend=backend)
    v_r, _, g_r = _torch_grads(x0, params, gradient=mode, **kw)
    v_b, _, g_b = _torch_grads(x0, params, gradient="backprop", **kw)
    assert float(v_r.detach()) == float(v_b.detach())
    _close(g_r, g_b, RTOL_REMAT, ATOL_REMAT)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("mode", ["remat_step", "remat_solve"])
def test_remat_matches_jax(mode, method, backend):
    vj, sj, gj = _jax_grads(2, method, mode, N_FIXED)
    x0, params = _problem(2)
    vt, sol, gt = _torch_grads(x0, params, gradient=mode, method=method,
                               stepping=N_FIXED, backend=backend)
    np.testing.assert_allclose(float(vt.detach()), vj, rtol=1e-12)
    assert _stats(sol)[0] == sj
    _close(gt, gj, RTOL_G, ATOL_G)


def test_remat_step_keeps_only_step_inputs_and_params():
    """The residuals autograd keeps after a remat_step forward are the N
    step inputs and the params (counted through saved_tensors_hooks): no
    stage activation.  remat_solve keeps x0 and the params; DirectBackprop
    keeps the stages."""
    x0, params = _problem(5)
    n = 4

    def packed(gradient):
        xt = tuple(torch.tensor(l, requires_grad=True) for l in x0)
        pt = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: (saved.append(t), t)[1], lambda t: t):
            sol = T.solve(field_torch, xt, pt, stepping=n,
                          gradient=gradient)
        return xt, pt, sol, saved

    xt, pt, sol, saved = packed("remat_step")
    n_x, n_p = len(xt), len(pt)
    assert len(saved) == n * (n_x + n_p)
    params_ptrs = {p.data_ptr() for p in pt.values()}
    per_step = [saved[i * (n_x + n_p):(i + 1) * (n_x + n_p)]
                for i in range(n)]
    for i, step in enumerate(per_step):
        assert {t.data_ptr() for t in step[n_x:]} == params_ptrs
        assert [t.shape for t in step[:n_x]] == [l.shape for l in xt]
    assert [t.data_ptr() for t in per_step[0][:n_x]] == \
        [l.data_ptr() for l in xt]
    # step n's input is step n-1's output, not a stage state
    for a, b in zip(per_step[-1][:n_x], per_step[-2][:n_x]):
        assert a.data_ptr() != b.data_ptr()

    _, pt, _, saved = packed("remat_solve")
    assert len(saved) == n_x + n_p
    assert {t.data_ptr() for t in saved[n_x:]} == \
        {p.data_ptr() for p in pt.values()}
    assert len(packed("backprop")[3]) > 10 * n * (n_x + n_p)


# ---------------------------------------------------------------------------
# ContinuousAdjoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(ADJOINT_CASES))
def test_adjoint_matches_jax(case, backend):
    vj, sj, gj = _jax_grads(4, "dopri5", case, None)
    x0, params = _problem(4)
    vt, sol, gt = _torch_grads(x0, params, gradient=_adjoint(T, case),
                               method="dopri5",
                               stepping=ADJOINT_CASES[case][0](T),
                               backend=backend)
    np.testing.assert_allclose(float(vt.detach()), vj, rtol=1e-12)
    assert _stats(sol)[0] == sj
    if case.startswith("adaptive"):
        assert sj["n_attempts"] >= sj["n_steps"] > 3
    _close(gt, gj, RTOL_G, ATOL_G)


def test_adjoint_inexact_but_converging():
    """The continuous adjoint's gradient is not that of the discrete map:
    visibly inexact at rk4 N = 4, converging by N = 16 — while the
    symplectic adjoint is exact at N = 4 (the paper's Sec. 3)."""
    x0, params = _problem(6)

    def err(gradient, n):
        kw = dict(method="rk4", stepping=n)
        _, _, g = _torch_grads(x0, params, gradient=gradient, **kw)
        _, _, g_ref = _torch_grads(x0, params, gradient="backprop", **kw)
        flat = torch.cat([a.reshape(-1) for a in g])
        ref = torch.cat([a.reshape(-1) for a in g_ref])
        return float(torch.linalg.norm(flat - ref) / torch.linalg.norm(ref))

    coarse, fine = err("adjoint", 4), err("adjoint", 16)
    assert coarse > 1e-9
    assert fine < coarse / 4
    assert err("symplectic", 4) < 1e-12


def test_adjoint_steps_multiplier_validation():
    with pytest.raises(ValueError, match="steps_multiplier"):
        T.ContinuousAdjoint(steps_multiplier=0)
    with pytest.raises(ValueError, match="steps_multiplier"):
        T.ContinuousAdjoint(steps_multiplier=-2)
    assert T.ContinuousAdjoint(steps_multiplier=2).steps_multiplier == 2
    adj = T.ContinuousAdjoint(steps_multiplier=np.int64(2))
    assert adj.steps_multiplier == 2 and type(adj.steps_multiplier) is int
    with pytest.raises(ValueError, match="steps_multiplier"):
        T.ContinuousAdjoint(steps_multiplier=np.int64(0))
    with pytest.raises(ValueError, match="steps_multiplier"):
        T.ContinuousAdjoint(steps_multiplier=True)
    with pytest.raises(ValueError, match="steps_multiplier"):
        T.ContinuousAdjoint(steps_multiplier=2.0)


@pytest.mark.parametrize("cell", ["fixed", "adaptive", "lanes"])
def test_adjoint_solves_record_no_checkpoints(cell, monkeypatch):
    """Neither adjoint solve records per-step state: every solution the
    adjoint's forward and backward solves return holds no checkpoint, and
    the backward solve's state is the augmented (x, lambda, theta-bar)."""
    sols = []
    for name in ("rk_solve_fixed", "rk_solve_adaptive",
                 "rk_solve_adaptive_batched"):
        real = getattr(tadjoint, name)

        def spy(*a, _real=real, **kw):
            sol = _real(*a, **kw)
            sols.append(sol)
            return sol
        monkeypatch.setattr(tadjoint, name, spy)
    if cell == "lanes":
        x0, params = _osc_problem()
        xt = tuple(torch.tensor(l, requires_grad=True) for l in x0)
        pt = {"w": torch.tensor(params["w"], requires_grad=True)}
        sol = T.solve(osc_torch, xt, pt, stepping=_osc_cfg(T),
                      gradient="adjoint", batch_axis=0)
        loss = torch.sum(sol.ys[0] ** 2)
    else:
        x0, params = _problem(7)
        xt = tuple(torch.tensor(l, requires_grad=True) for l in x0)
        pt = {k: torch.tensor(v, requires_grad=True)
              for k, v in params.items()}
        sol = T.solve(field_torch, xt, pt, gradient="adjoint",
                      stepping=6 if cell == "fixed" else _cfg(T))
        loss = torch.sum(sol.ys[0] ** 2) + torch.sum(sol.ys[1])
    torch.autograd.grad(loss, list(xt) + list(pt.values()))
    assert len(sols) == 2                       # forward, backward
    for s in sols:
        assert not s.xs and not s.ts
        if cell != "fixed":
            assert s.hs is None if cell == "lanes" else not s.hs
    fwd, bwd = sols
    assert len(bwd.x_final) == 3                # (x, lambda, theta-bar)
    if cell == "lanes":
        assert bwd.x_final[2]["w"].shape == (B,) + tuple(pt["w"].shape)


# ---------------------------------------------------------------------------
# The lane-batched adjoint (solve(..., batch_axis=0))
# ---------------------------------------------------------------------------

def _osc_loss_jax(x0, p, **kw):
    sol = J.solve(osc_jax, x0, p, batch_axis=0, backend="jnp", **kw)
    return (jnp.sum(jnp.tanh(sol.ys[0]) ** 2) + jnp.sum(sol.ys[0][:, 0]),
            sol)


@functools.lru_cache(maxsize=None)
def _jax_batched_adjoint():
    x0, params = _osc_problem()
    loss = functools.partial(_osc_loss_jax, stepping=_osc_cfg(J),
                             gradient="adjoint")
    (val, sol), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        tuple(jnp.asarray(l) for l in x0),
        {k: jnp.asarray(v) for k, v in params.items()})
    return float(val), sol.ys, _lane_stats(sol), list(g[0]) + [g[1]["w"]]


def _osc_grads(x0, params, **kw):
    xt = tuple(torch.tensor(l, requires_grad=True) for l in x0)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    sol = T.solve(osc_torch, xt, pt, **kw)
    y = sol.ys[0]
    loss = torch.sum(torch.tanh(y) ** 2) + torch.sum(y[..., 0])
    return loss, sol, list(torch.autograd.grad(loss, list(xt) + [pt["w"]]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_adjoint_matches_jax(backend):
    """Per-lane forward and backward grids: per-lane stats exactly, the
    value and the gradient against JAX's odeint_adjoint_adaptive_batched."""
    vj, ys_j, stats_j, g_j = _jax_batched_adjoint()
    x0, params = _osc_problem()
    val, sol, g = _osc_grads(x0, params, stepping=_osc_cfg(T),
                             gradient="adjoint", batch_axis=0,
                             backend=backend)
    assert _lane_stats(sol) == stats_j
    assert stats_j[0]["n_steps"][-1] > 4 * stats_j[0]["n_steps"][0]
    for a, b in zip(sol.ys, ys_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-12)
    np.testing.assert_allclose(float(val.detach()), vj, rtol=1e-12)
    _close(g, g_j, RTOL_G, ATOL_G)


def test_batched_adjoint_failed_lane_poisons_only_its_row():
    """A lane that exhausts max_steps under on_failure="nan": its output
    row and its own state gradient are NaN, the other lanes' rows are
    finite and their state gradients equal their single-lane adjoint
    gradients; the lane-summed parameter gradient carries the poison (a
    sum over lanes, as in the JAX package)."""
    x0, params = _osc_problem()
    tight = _osc_cfg(T, max_steps=24)
    _, sol, (g_x, g_om, g_w) = _osc_grads(x0, params, stepping=tight,
                                          gradient="adjoint", batch_axis=0)
    ok = sol.success.tolist()
    assert ok[0] and not ok[-1]
    for b in range(B):
        row = torch.cat([sol.ys[0][b], sol.ys[1][b:b + 1]])
        assert bool(torch.isnan(row).all()) != ok[b]
        assert bool(torch.isnan(g_x[b]).all()) != ok[b]
    assert torch.isnan(g_w).all()
    for b in (i for i in range(B) if ok[i]):
        _, one, (gx1, go1, _) = _osc_grads(
            (x0[0][b], x0[1][b]), params, stepping=tight,
            gradient="adjoint")
        assert bool(one.success)
        assert float((g_x[b] - gx1).abs().max()) < LOOP_TOL
        assert float((g_om[b] - go1).abs().max()) < LOOP_TOL
