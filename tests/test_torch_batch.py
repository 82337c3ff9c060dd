"""PyTorch port: lane-batched solving (``solve(..., batch_axis=0)``) against
the JAX package.

Float64 on the CPU (float32 in a subprocess with JAX's x64 off), the
JAX package's ``tests/test_batch.py`` problem: a per-lane oscillator whose
stiffness rides in the state, B = 4 lanes of ~1x..16x stiffness.  The
lane forms of the plain combines and of the StageCombiner are held against
``jax.vmap`` of the JAX package's; the batched solves' per-lane integer
stats must equal JAX's exactly, values and gradients at the bounds of
``tests/test_torch_solve.py``; inside torch the batched gradient must equal
the sum of single-lane gradients (JAX's bound, 1e-9), and a failing lane
must be flagged and poisoned alone.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import repro.core as J
from repro.core.combine import StageCombiner as JCombiner
from repro.core.rk import _error_norm_lanes as j_error_norm_lanes
from repro.core.tableau import get_tableau as jget
from repro.kernels import ref as jref
from repro.kernels.butcher_combine import butcher_combine_rows_pallas
import repro_torch.core as T
from repro_torch.core.combine import StageCombiner as TCombiner
from repro_torch.core.stepper import _error_norm, _error_norm_lanes
from repro_torch.core.tableau import get_tableau as tget
from repro_torch.kernels import ref as tref

RTOL_F64 = 1e-14                    # plain combines, as test_torch_kernels
RTOL_X = 1e-12                      # forward state, float64
RTOL_G, ATOL_G = 1e-10, 1e-12       # gradients, float64 (test_torch_solve)
LOOP_TOL = 1e-9                     # batched vs single lanes (test_batch)
B = 4
BACKENDS = ("torch", "cuda")
STAGES = (1, 7, 13)


# ---------------------------------------------------------------------------
# The lane forms of the plain combines and of the StageCombiner
# ---------------------------------------------------------------------------

def _lane_inputs(s, m=None, seed=0):
    rng = np.random.default_rng(seed + s)
    x = rng.normal(size=(B, 3, 5))
    ks = rng.normal(size=(s, B, 3, 5))
    coefs = rng.normal(size=(B, s) if m is None else (B, m, s))
    sc = rng.normal(size=(m,)) if m is not None else None
    return x, ks, coefs, sc


@pytest.mark.parametrize("s", STAGES)
def test_lane_combine_ref_matches_vmapped_jax(s):
    x, ks, coefs, _ = _lane_inputs(s)
    want = jax.vmap(lambda a, k, c: jref.butcher_combine_ref(a, k, c, 1.0),
                    in_axes=(0, 1, 0))(jnp.asarray(x), jnp.asarray(ks),
                                       jnp.asarray(coefs))
    got = tref.butcher_combine_ref(torch.tensor(x), torch.tensor(ks),
                                   torch.tensor(coefs), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL_F64, atol=0)


@pytest.mark.parametrize("oracle", ["ref", "pallas"])
@pytest.mark.parametrize("s", STAGES)
def test_lane_combine_rows_ref_matches_vmapped_jax(s, oracle):
    """The rows form against jax.vmap of the oracle and of the Pallas
    kernel in interpret mode (its batching rule puts the lane axis in the
    grid, one (m, s) row block per lane)."""
    x, ks, coefs, sc = _lane_inputs(s, m=2)
    if oracle == "ref":
        fn = functools.partial(jref.butcher_combine_rows_ref,
                               base_scale=jnp.asarray(sc), h=1.0)
    else:
        fn = functools.partial(butcher_combine_rows_pallas,
                               base_scale=jnp.asarray(sc),
                               h=jnp.asarray(1.0), interpret=True)
    want = jax.vmap(lambda a, k, c: fn(a, k, c), in_axes=(0, 1, 0),
                    out_axes=1)(jnp.asarray(x), jnp.asarray(ks),
                                jnp.asarray(coefs))
    got = tref.butcher_combine_rows_ref(torch.tensor(x), torch.tensor(ks),
                                        torch.tensor(coefs),
                                        torch.tensor(sc), 1.0)
    assert got.shape == (2, B, 3, 5)
    # relative to the summed term magnitudes: an output that cancels to
    # near zero keeps the rounding of its terms (as test_torch_cuda's
    # combine_close)
    mag = np.abs(sc)[:, None, None, None] * np.abs(x) + np.einsum(
        "bri,ibjk->rbjk", np.abs(coefs), np.abs(ks))
    assert np.all(np.abs(got.numpy() - np.asarray(want)) <= RTOL_F64 * mag)


def _state(seed, lead=()):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=lead + (3, 4)), rng.normal(size=lead + (5,)))


def _combiner_rows(c, x, K, lam, L, h, tab):
    """Every combine of a step, forward and backward."""
    s = tab.s
    Ks = tuple(l[:s] for l in K)
    out = [c.stage_state(x, Ks, h, i) for i in range(s)]
    out.append(c.solution(x, Ks, h))
    if tab.err_uses_fsal:
        out.append(c.error(x, K, h))
    else:
        out.extend(c.solution_and_error(x, Ks, h))
    out.extend(c.lambda_stage(lam, L, h, i) for i in range(s))
    out.append(c.lambda_update(lam, L, h))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", ["bosh3", "fehlberg45", "dopri5"])
def test_combiner_lane_forms_match_vmapped_jax(method, backend):
    """With a (B,) step every StageCombiner row is per lane: the port's
    lane forms (plain ops, and the kernel path's plain versions) against
    jax.vmap of the JAX package's combiner over the lanes."""
    tt, jt = tget(method), jget(method)
    s = tt.s
    x, K, lam, L = (_state(1, (B,)), _state(2, (s + 1, B)),
                    _state(3, (B,)), _state(4, (s, B)))
    h = np.array([0.173, 0.05, 0.311, 0.2])
    jc = JCombiner(jt, "jnp")
    want = jax.vmap(lambda *a: _combiner_rows(jc, *a, jt),
                    in_axes=(0, 1, 0, 1, 0))(
        *(tuple(jnp.asarray(l) for l in t) for t in (x, K, lam, L)),
        jnp.asarray(h))
    got = _combiner_rows(TCombiner(tt, backend),
                         *(tuple(torch.tensor(l) for l in t)
                           for t in (x, K, lam, L)), torch.tensor(h), tt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=RTOL_F64, atol=1e-15)


@pytest.mark.parametrize("coef_grad", [False, True])
def test_kernel_path_lane_backward_matches_autograd(coef_grad):
    """The kernel path's autograd backward with one row per lane (dK per
    lane, dhc per lane only when asked for) equals autograd through the
    plain ops."""
    tab = tget("dopri5")
    kern, plain = TCombiner(tab, "cuda"), TCombiner(tab, "torch")
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=(B, 3)), requires_grad=True)
    K = torch.tensor(rng.normal(size=(7, B, 3)), requires_grad=True)
    rows = torch.tensor(rng.normal(size=(B, 7)), requires_grad=coef_grad)
    w = torch.tensor(rng.normal(size=(2, B, 3)))
    h = torch.tensor([0.21, 0.1, 0.05, 0.3], dtype=torch.float64)
    inputs = [x, K] + ([rows] if coef_grad else [])
    grads = []
    for c in (kern, plain):
        (y,) = c.combine((x,), (K,), rows, 1.0)
        xn, err = c.solution_and_error((x,), (K,), h)
        loss = (y * w[0]).sum() + (xn[0] * w[1]).sum() + (err[0] ** 2).sum()
        grads.append(torch.autograd.grad(loss, inputs))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13,
                                   atol=1e-14)


# ---------------------------------------------------------------------------
# The test_batch.py problem, in both packages
# ---------------------------------------------------------------------------

def osc_jax(state, t, p):
    x, om = state
    h = jnp.tanh(x @ p["w"])
    dx = om[..., None] * jnp.stack(
        [x[..., 1] + h[..., 0], -x[..., 0] + h[..., 1]], axis=-1)
    return (dx, jnp.zeros_like(om))


def osc_torch(state, t, p):
    x, om = state
    h = torch.tanh(x @ p["w"])
    dx = om[..., None] * torch.stack(
        [x[..., 1] + h[..., 0], -x[..., 0] + h[..., 1]], dim=-1)
    return (dx, torch.zeros_like(om))


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, 2)), np.logspace(0.0, 1.2, B)),
            {"w": rng.normal(size=(2, 2)) * 0.4})


def _cfg(mod, **kw):
    base = dict(rtol=1e-7, atol=1e-9, max_steps=192, initial_step=0.05)
    base.update(kw)
    return mod.AdaptiveConfig(**base)


def _stats(sol):
    return ({k: np.asarray(v).tolist() for k, v in sol.stats.items()},
            np.asarray(sol.success).tolist())


def _torch_inputs(x0, params, grad=False):
    return (tuple(torch.tensor(l, requires_grad=grad) for l in x0),
            {k: torch.tensor(v, requires_grad=grad)
             for k, v in params.items()})


def _loss_jax(x0, p, **kw):
    sol = J.solve(osc_jax, x0, p, batch_axis=0, backend="jnp", **kw)
    return jnp.sum(jnp.tanh(sol.ys[0]) ** 2) + jnp.sum(sol.ys[0][:, 0]), sol


def _loss_torch(x0, p, **kw):
    sol = T.solve(osc_torch, x0, p, batch_axis=0, **kw)
    return (torch.sum(torch.tanh(sol.ys[0]) ** 2)
            + torch.sum(sol.ys[0][:, 0])), sol


@functools.lru_cache(maxsize=None)
def _jax_batched(t1, grads):
    """JAX's batched symplectic solve: (ys, stats, loss, gradients)."""
    x0, params = _problem()
    loss = functools.partial(_loss_jax, stepping=_cfg(J),
                             saveat=J.SaveAt(t1=t1))
    args = (tuple(jnp.asarray(l) for l in x0),
            {k: jnp.asarray(v) for k, v in params.items()})
    if not grads:
        val, sol = jax.jit(loss)(*args)
        return sol.ys, _stats(sol), val, None
    (val, sol), g = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(*args)
    return sol.ys, _stats(sol), val, list(g[0]) + [g[1]["w"]]


def _torch_batched(gradient, backend, t1=1.0, **kw):
    x0, params = _problem()
    xt, pt = _torch_inputs(x0, params, grad=True)
    val, sol = _loss_torch(xt, pt, stepping=_cfg(T), gradient=gradient,
                           backend=backend, saveat=T.SaveAt(t1=t1), **kw)
    g = torch.autograd.grad(val, list(xt) + [pt["w"]])
    return val, sol, list(g)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("gradient", ["symplectic", "backprop"])
def test_batched_solve_matches_jax(gradient, backend):
    """Per-lane stats and success exactly, values to RTOL_X, and the
    gradient — Algorithm 2 per lane, or autograd through the batched
    driver — against JAX's batched symplectic gradient."""
    ys_j, stats_j, val_j, g_j = _jax_batched(1.0, True)
    val, sol, g = _torch_batched(gradient, backend)
    assert sol.stats["n_steps"].shape == (B,) and sol.success.shape == (B,)
    assert _stats(sol) == stats_j
    steps = stats_j[0]["n_steps"]
    assert steps[-1] > 4 * steps[0]       # heterogeneous per-lane grids
    for a, b in zip(sol.ys, ys_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL_X)
    np.testing.assert_allclose(float(val.detach()), float(val_j),
                               rtol=RTOL_X)
    for a, b in zip(g, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_G,
                                   atol=ATOL_G)


def test_batched_reverse_time_matches_jax():
    ys_j, stats_j, _, _ = _jax_batched(-0.5, False)
    x0, params = _problem()
    xt, pt = _torch_inputs(x0, params)
    sol = T.solve(osc_torch, xt, pt, stepping=_cfg(T), batch_axis=0,
                  saveat=T.SaveAt(t1=-0.5))
    assert _stats(sol) == stats_j
    for a, b in zip(sol.ys, ys_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_X)


@pytest.mark.parametrize("gradient", ["symplectic", "backprop"])
def test_fixed_grid_batched_is_plain_solve_with_lane_stats(gradient):
    """A fixed grid does not depend on the state: batch_axis=0 is the
    plain solve with per-lane stats (and JAX's values)."""
    x0, params = _problem()
    xt, pt = _torch_inputs(x0, params)
    sol_b = T.solve(osc_torch, xt, pt, stepping=8, batch_axis=0,
                    gradient=gradient)
    sol_p = T.solve(osc_torch, xt, pt, stepping=8, gradient=gradient)
    for a, b in zip(sol_b.ys, sol_p.ys):
        assert torch.equal(a, b)
    sol_j = J.solve(osc_jax, tuple(jnp.asarray(l) for l in x0),
                    {"w": jnp.asarray(params["w"])}, stepping=8,
                    batch_axis=0, backend="jnp")
    assert _stats(sol_b) == _stats(sol_j)
    assert sol_b.stats["n_fevals"].tolist() == [8 * 7] * B
    for a, b in zip(sol_b.ys, sol_j.ys):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_X)


def _mixed_state(b=None):
    rng = np.random.default_rng(5)
    big = 1e3 * rng.normal(size=(B, 3))
    small = 1e-3 * rng.normal(size=(B, 2))
    return {"big": big, "small": small}


def _decay(mod):
    def f(state, t, p):
        return {k: -p["k"] * l * (1.0 + 0.5 * mod.tanh(l / 1e3))
                for k, l in state.items()}
    return f


def test_mixed_magnitude_batched_matches_jax():
    """Per-leaf atol scaling with element-count weighting, per lane: a
    mixed-magnitude dict state takes JAX's per-lane grids exactly."""
    x0 = _mixed_state()
    cfg = dict(rtol=1e-6, atol=1e-9, max_steps=128, initial_step=0.05)
    sol_j = J.solve(_decay(jnp), {k: jnp.asarray(v) for k, v in x0.items()},
                    {"k": jnp.asarray(1.7)}, method="bosh3",
                    stepping=J.AdaptiveConfig(**cfg), batch_axis=0,
                    backend="jnp")
    sol_t = T.solve(_decay(torch), {k: torch.tensor(v) for k, v in
                                    x0.items()},
                    {"k": torch.tensor(1.7, dtype=torch.float64)},
                    method="bosh3", stepping=T.AdaptiveConfig(**cfg),
                    batch_axis=0)
    assert _stats(sol_t) == _stats(sol_j)
    for k in x0:
        np.testing.assert_allclose(sol_t.ys[k].numpy(),
                                   np.asarray(sol_j.ys[k]), rtol=RTOL_X)


def test_error_norm_lanes_is_per_lane_norm_and_matches_jax():
    x = _mixed_state()
    xn = {k: v * 1.001 + 1e-6 for k, v in x.items()}
    err = {k: (xn[k] - x[k]) * 0.01 for k in x}
    tt = [{k: torch.tensor(v[k]) for k in v} for v in (err, x, xn)]
    lanes = _error_norm_lanes(*tt, 1e-6, 1e-8)
    assert lanes.shape == (B,)
    for b in range(B):
        one = _error_norm(*({k: v[k][b] for k in v} for v in tt), 1e-6,
                          1e-8)
        assert float(lanes[b]) == float(one)
    want = j_error_norm_lanes(*({k: jnp.asarray(v[k]) for k in v}
                                for v in (err, x, xn)), 1e-6, 1e-8)
    np.testing.assert_allclose(lanes.numpy(), np.asarray(want), rtol=1e-14)


# ---------------------------------------------------------------------------
# Inside torch: batched == single lanes; failures stay in their lane
# ---------------------------------------------------------------------------

def test_batched_gradient_matches_sum_of_single_lanes():
    x0, params = _problem()
    _, sol, g = _torch_batched("symplectic", "auto")
    g_x, g_om, g_w = [], [], 0.0
    for b in range(B):
        xt, pt = _torch_inputs((x0[0][b], x0[1][b]), params, grad=True)
        one = T.solve(osc_torch, xt, pt, stepping=_cfg(T))
        assert int(one.stats["n_steps"]) == int(sol.stats["n_steps"][b])
        val = torch.sum(torch.tanh(one.ys[0]) ** 2) + one.ys[0][0]
        gx, go, gw = torch.autograd.grad(val, list(xt) + [pt["w"]])
        g_x.append(gx)
        g_om.append(go)
        g_w = g_w + gw
    for a, b in zip(g, (torch.stack(g_x), torch.stack(g_om), g_w)):
        assert float((a - b).abs().max()) < LOOP_TOL


def test_failed_lane_is_poisoned_and_flagged_alone():
    """A step budget the stiffest lane cannot meet: that lane alone is
    flagged and NaN-poisoned, the others match their single solves, and
    the symplectic gradient of a loss over the healthy lanes is finite and
    equals the sum of their single-lane gradients."""
    x0, params = _problem()
    tight = _cfg(T, max_steps=24)
    xt, pt = _torch_inputs(x0, params, grad=True)
    sol = T.solve(osc_torch, xt, pt, stepping=tight, batch_axis=0)
    ok = sol.success.tolist()
    assert ok[0] and not ok[-1]
    assert torch.isnan(sol.ys[0][-1]).all()
    assert torch.isfinite(sol.ys[0][0]).all()
    healthy = [b for b in range(B) if ok[b]]
    loss = torch.sum(sol.ys[0][healthy] ** 2)
    g_w = torch.autograd.grad(loss, pt["w"])[0]
    assert torch.isfinite(g_w).all()
    want = 0.0
    for b in healthy:
        xb, pb = _torch_inputs((x0[0][b], x0[1][b]), params, grad=True)
        one = T.solve(osc_torch, xb, pb, stepping=tight)
        for a, c in zip(one.ys, sol.ys):
            np.testing.assert_allclose(a.detach().numpy(),
                                       c[b].detach().numpy(), rtol=RTOL_X)
        want = want + torch.autograd.grad(torch.sum(one.ys[0] ** 2),
                                          pb["w"])[0]
    assert float((g_w - want).abs().max()) < LOOP_TOL


def test_nan_lane_leaves_the_other_lanes_gradient_finite():
    """A lane whose initial state is NaN drops out after one doomed trial
    (n_accepted 0): every row of the backward is invalid for it, and the
    masked sum keeps the parameter gradient of the other lanes finite and
    equal to the batch without it."""
    x0, params = _problem()
    x_nan = (x0[0].copy(), x0[1])
    x_nan[0][2] = np.nan
    xt, pt = _torch_inputs(x_nan, params, grad=True)
    sol = T.solve(osc_torch, xt, pt, stepping=_cfg(T), batch_axis=0)
    assert sol.success.tolist() == [True, True, False, True]
    assert int(sol.stats["n_steps"][2]) == 0
    assert int(sol.stats["n_attempts"][2]) == 1
    keep = [0, 1, 3]
    g_w = torch.autograd.grad(torch.sum(sol.ys[0][keep] ** 2), pt["w"])[0]
    assert torch.isfinite(g_w).all()
    xk, pk = _torch_inputs((x0[0][keep], x0[1][keep]), params, grad=True)
    ref = T.solve(osc_torch, xk, pk, stepping=_cfg(T), batch_axis=0)
    g_ref = torch.autograd.grad(torch.sum(ref.ys[0] ** 2), pk["w"])[0]
    assert float((g_w - g_ref).abs().max()) < LOOP_TOL


def test_apply_on_failure_lanes_policies():
    x = {"a": torch.ones(3, 2), "n": torch.ones(3, dtype=torch.int32)}
    ok = torch.tensor([True, False, True])
    out = T.apply_on_failure_lanes(x, ok, "nan")
    assert torch.isfinite(out["a"][0]).all()
    assert torch.isnan(out["a"][1]).all()
    assert torch.equal(out["n"], x["n"])      # integer leaves untouched
    assert T.apply_on_failure_lanes(x, ok, "ignore") is x
    with pytest.raises(RuntimeError, match="max_steps"):
        T.apply_on_failure_lanes(x, ok, "raise")
    assert T.apply_on_failure_lanes(x, torch.ones(3, dtype=torch.bool),
                                    "raise") is x


# ---------------------------------------------------------------------------
# Capability matrix and validation
# ---------------------------------------------------------------------------

def test_batched_capability_matrix_and_missing_cells():
    """Under batch_axis=0 the port's table equals the JAX package's on
    every cell for all five strategies; the cells it lacks (the remat
    strategies' adaptive cells, dense output) fail with the uniform
    message."""
    jm, tm = J.batched_capability_matrix(), T.batched_capability_matrix()
    assert tm == jm
    for name in ("symplectic", "backprop", "adjoint"):
        assert tm[name][("adaptive", "ts")] and tm[name][("fixed", "ts")]
        assert not tm[name][("adaptive", "dense")]
    for name in ("remat_step", "remat_solve"):
        assert tm[name][("fixed", "ts")] and not tm[name][("adaptive", "t1")]
    x0, params = _problem()
    xt, pt = _torch_inputs(x0, params)
    for name in ("remat_step", "remat_solve"):
        with pytest.raises(ValueError, match="batch_axis=0.*fixed\\+t1"):
            T.solve(osc_torch, xt, pt, gradient=name, stepping=_cfg(T),
                    batch_axis=0)
    for name in sorted(tm):
        with pytest.raises(ValueError, match="dense.*batch_axis=0"):
            T.solve(osc_torch, xt, pt,
                    saveat=T.SaveAt(ts=[0.5, 1.0], dense=True),
                    stepping=_cfg(T), gradient=name, batch_axis=0)


def test_batch_axis_validation():
    x0, params = _problem()
    xt, pt = _torch_inputs(x0, params)
    with pytest.raises(ValueError, match="only the leading axis"):
        T.solve(osc_torch, xt, pt, stepping=_cfg(T), batch_axis=1)
    with pytest.raises(ValueError, match="leading lane axis"):
        T.solve(osc_torch, (xt[0], torch.tensor(1.0, dtype=torch.float64)),
                pt, stepping=_cfg(T), batch_axis=0)
    with pytest.raises(ValueError, match="same leading lane-axis size"):
        T.lane_count((torch.ones(3, 2), torch.ones(4)))


def test_solver_reads_the_host_once_per_attempt(monkeypatch):
    """The lane-batched stepper's only device-to-host read is whether any
    lane is live, once per attempt (counted here through the one
    ``bool()`` it calls; the card run counts CUDA synchronisations)."""
    from repro_torch.core import stepper as st
    x0, params = _problem()
    xt, pt = _torch_inputs(x0, params)
    stepper = st.AdaptiveStepper(osc_torch, tget("dopri5"), _cfg(T))
    state = stepper.init_state(xt, 0.0, 1.0, lanes=B)
    reads = []
    real = torch.Tensor.__bool__

    def counted(self):
        reads.append(1)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "__bool__", counted)
    attempts = 0
    while state.active:
        state = stepper.advance(state, pt)
        attempts += 1
    monkeypatch.undo()
    assert attempts == int(state.n_attempts.max())
    assert len(reads) == attempts


# ---------------------------------------------------------------------------
# Float32: the card's per-sample path solves in float32
# ---------------------------------------------------------------------------

# JAX with x64 off times a float32 solve in float32, as the port does for a
# float32 state.  The two libraries round the field (tanh, the products)
# differently by a few float32 ulps per stage slope, so the states agree to
# float32 rounding carried through the solve: |diff| <= 16 float32 ulps of
# the largest |x|.  The integer stats are exactly equal as long as the
# controller never decides on an embedded error estimate that those few
# ulps move.  With initial_step 0.05 the first step's estimate is at that
# level: the two libraries' float32 tanh move lane 2's first error norm by
# tens of percent, the step sizes that follow differ by more than
# rounding, and lane 2 takes one rejected attempt more in JAX.  That flip
# is the field's rounding, not the solver's: the second test gives both
# libraries a field whose nonlinearity they round alike (computed in
# float64, rounded once to float32) and holds the solvers to the same
# stats and the same bound at 0.05 too.
F32_ULPS = 16
F32_LANE = 3                        # the single-lane case: the stiffest lane
_F32_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp
    import numpy as np
    assert not jax.config.jax_enable_x64
    import repro.core as J

    def act_f64(x, w):
        # tanh(x @ w) in float64 on the host, rounded once to float32
        return jax.pure_callback(
            lambda a, b: np.tanh(np.einsum(
                "...i,...ij->...j", np.asarray(a, np.float64),
                np.asarray(b, np.float64))).astype(np.float32),
            jax.ShapeDtypeStruct(x.shape, x.dtype), x, w,
            vmap_method="broadcast_all")

    x, om, w, cfg, lane, field = json.loads(sys.stdin.read())

    def osc(state, t, p):
        x, om = state
        h = (jnp.tanh(x @ p["w"]) if field == "native"
             else act_f64(x, p["w"]))
        dx = om[..., None] * jnp.stack(
            [x[..., 1] + h[..., 0], -x[..., 0] + h[..., 1]], axis=-1)
        return (dx, jnp.zeros_like(om))
    x0 = (jnp.asarray(x, jnp.float32), jnp.asarray(om, jnp.float32))
    p = {"w": jnp.asarray(w, jnp.float32)}
    cfg = J.AdaptiveConfig(**cfg)
    out = {}
    for lanes in (False, True):
        if lanes:
            sol = J.solve(osc, x0, p, stepping=cfg, batch_axis=0,
                          backend="jnp")
        else:
            sol = J.solve(osc, (x0[0][lane], x0[1][lane]), p, stepping=cfg,
                          backend="jnp")
        assert sol.ys[0].dtype == jnp.float32
        out[str(lanes)] = {
            "ys": [np.asarray(l, np.float64).tolist() for l in sol.ys],
            "stats": {k: np.asarray(v).tolist()
                      for k, v in sol.stats.items()},
            "success": np.asarray(sol.success).tolist()}
    print(json.dumps(out))
""")


def osc_torch_f64_act(state, t, p):
    """``osc_torch`` with tanh(x @ w) computed in float64 and rounded once
    to the state's float32, as the JAX script's ``act_f64`` does."""
    x, om = state
    h = torch.tanh(x.double() @ p["w"].double()).to(x.dtype)
    dx = om[..., None] * torch.stack(
        [x[..., 1] + h[..., 0], -x[..., 0] + h[..., 1]], dim=-1)
    return (dx, torch.zeros_like(om))


@functools.lru_cache(maxsize=None)
def _jax_float32(initial_step, field="native"):
    x0, params = _problem(3)
    cfg = dict(rtol=1e-4, atol=1e-6, max_steps=192,
               initial_step=initial_step)
    env = dict(os.environ, JAX_ENABLE_X64="0", JAX_PLATFORMS="cpu")
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", _F32_SCRIPT],
        input=json.dumps([x0[0].tolist(), x0[1].tolist(),
                          params["w"].tolist(), cfg, F32_LANE, field]),
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    return x0, params, cfg, json.loads(out.stdout.splitlines()[-1])


def _check_float32(initial_step, lanes, field, f):
    x0, params, cfg, jax_out = _jax_float32(initial_step, field)
    want = jax_out[str(lanes)]
    x = (torch.tensor(x0[0], dtype=torch.float32),
         torch.tensor(x0[1], dtype=torch.float32))
    if not lanes:
        x = (x[0][F32_LANE], x[1][F32_LANE])
    sol = T.solve(f, x, {"w": torch.tensor(params["w"],
                                           dtype=torch.float32)},
                  stepping=T.AdaptiveConfig(**cfg),
                  batch_axis=0 if lanes else None)
    assert sol.ys[0].dtype == torch.float32
    stats = {k: np.asarray(v).tolist() for k, v in sol.stats.items()}
    assert stats == want["stats"]
    assert np.asarray(sol.success).tolist() == want["success"]
    assert max(np.ravel(want["stats"]["n_steps"])) > 15
    for a, b in zip(sol.ys, want["ys"]):
        b = np.asarray(b)
        bound = F32_ULPS * np.spacing(np.float32(np.abs(b).max()))
        assert np.abs(a.numpy().astype(np.float64) - b).max() <= bound


@pytest.mark.parametrize("lanes", [False, True], ids=["single", "lanes"])
@pytest.mark.parametrize("initial_step", [0.2, 1.0])
def test_float32_adaptive_matches_jax_x64_off(initial_step, lanes):
    """Float32 state, float32 times in both packages, each library's own
    tanh: the integer stats equal JAX's exactly (no accept/reject decision
    flips) and x_final agrees to F32_ULPS float32 ulps of its largest
    entry."""
    _check_float32(initial_step, lanes, "native", osc_torch)


@pytest.mark.parametrize("lanes", [False, True], ids=["single", "lanes"])
@pytest.mark.parametrize("initial_step", [0.05, 0.2, 1.0])
def test_float32_adaptive_matches_jax_field_rounded_alike(initial_step,
                                                          lanes):
    """The same comparison with the field's nonlinearity rounded alike in
    both libraries: the solvers then take the same decisions even where
    the first error estimate is at the field's rounding level
    (initial_step 0.05), with the same stats and the same F32_ULPS bound."""
    _check_float32(initial_step, lanes, "alike", osc_torch_f64_act)


# ---------------------------------------------------------------------------
# SaveAt lane cells: solve(..., saveat=SaveAt(ts=...), batch_axis=0)
# ---------------------------------------------------------------------------

TS = (0.4, 0.7, 1.0)


def _saveat_loss(mod, ys):
    """A loss over every observation of every lane, and a cross term
    between the first and last observation."""
    x = ys[0]
    if mod is J:
        return jnp.sum(jnp.tanh(x) ** 2) + jnp.sum(x[0] * x[-1])
    return torch.sum(torch.tanh(x) ** 2) + torch.sum(x[0] * x[-1])


@functools.lru_cache(maxsize=None)
def _jax_batched_saveat(gradient):
    x0, params = _problem()

    def loss(x, p):
        sol = J.solve(osc_jax, x, p, saveat=J.SaveAt(ts=jnp.asarray(TS)),
                      stepping=_cfg(J), gradient=gradient, batch_axis=0,
                      backend="jnp")
        return _saveat_loss(J, sol.ys), sol

    (_, sol), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True))(
        tuple(jnp.asarray(l) for l in x0),
        {k: jnp.asarray(v) for k, v in params.items()})
    return sol.ys, _stats(sol), list(g[0]) + [g[1]["w"]]


def _torch_batched_saveat(gradient, backend="auto", x0=None, **kw):
    x0_, params = _problem()
    xt, pt = _torch_inputs(x0_ if x0 is None else x0, params, grad=True)
    sol = T.solve(osc_torch, xt, pt, saveat=T.SaveAt(ts=list(TS)),
                  stepping=_cfg(T, **kw), gradient=gradient, batch_axis=0,
                  backend=backend)
    g = torch.autograd.grad(_saveat_loss(T, sol.ys), list(xt) + [pt["w"]])
    return sol, list(g)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("gradient", ["symplectic", "backprop", "adjoint"])
def test_batched_saveat_matches_jax(gradient, backend):
    """The lane SaveAt cells: per-lane stats exactly (threaded for the
    symplectic adjoint and DirectBackprop, restarting for the adjoint),
    observations to RTOL_X and gradients to RTOL_G / ATOL_G against the
    JAX package's (its symplectic gradient for DirectBackprop, which JAX
    cannot reverse through its while loop)."""
    ys_j, stats_j, g_j = _jax_batched_saveat(
        "adjoint" if gradient == "adjoint" else "symplectic")
    sol, g = _torch_batched_saveat(gradient, backend)
    assert sol.ys[0].shape == (len(TS), B, 2)
    assert _stats(sol) == stats_j
    for a, b in zip(sol.ys, ys_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL_X)
    for a, b in zip(g, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_G,
                                   atol=ATOL_G)


@pytest.mark.parametrize("gradient", ["symplectic", "adjoint"])
def test_batched_saveat_matches_single_lanes(gradient):
    """Inside torch: lane b of the batched SaveAt solve is the single-lane
    SaveAt solve of lane b (values, stats), and the batched gradient is the
    sum of the single-lane gradients (LOOP_TOL)."""
    x0, params = _problem()
    sol, g = _torch_batched_saveat(gradient)
    want = [[], [], 0.0]
    for b in range(B):
        xt, pt = _torch_inputs((x0[0][b], x0[1][b]), params, grad=True)
        one = T.solve(osc_torch, xt, pt, saveat=T.SaveAt(ts=list(TS)),
                      stepping=_cfg(T), gradient=gradient)
        for k in ("n_steps", "n_fevals", "n_attempts"):
            assert int(one.stats[k]) == int(sol.stats[k][b]), (b, k)
        np.testing.assert_allclose(sol.ys[0][:, b].detach().numpy(),
                                   one.ys[0].detach().numpy(), rtol=RTOL_X)
        gx, go, gw = torch.autograd.grad(
            _saveat_loss(T, one.ys), list(xt) + [pt["w"]])
        want[0].append(gx)
        want[1].append(go)
        want[2] = want[2] + gw
    for a, c in zip(g, (torch.stack(want[0]), torch.stack(want[1]),
                        want[2])):
        assert float((a - c).abs().max()) < LOOP_TOL


def test_poisoned_lane_does_not_burn_max_attempts_in_later_segments():
    """A lane NaN-poisoned in an early SaveAt segment drops out after one
    doomed trial per later segment, is flagged alone, and its stats equal
    the JAX package's exactly; the healthy lanes equal their single
    solves."""
    x0, params = _problem()
    tight = dict(max_steps=24, max_attempts=4096)
    ts = np.linspace(0.25, 1.0, 4)
    xt, pt = _torch_inputs(x0, params)
    sol = T.solve(osc_torch, xt, pt, saveat=T.SaveAt(ts=ts),
                  stepping=_cfg(T, **tight), gradient="backprop",
                  batch_axis=0)
    sol_j = J.solve(osc_jax, tuple(jnp.asarray(l) for l in x0),
                    {"w": jnp.asarray(params["w"])},
                    saveat=J.SaveAt(ts=jnp.asarray(ts)),
                    stepping=_cfg(J, **tight), gradient="backprop",
                    batch_axis=0, backend="jnp")
    assert _stats(sol) == _stats(sol_j)
    ok = sol.success.tolist()
    assert ok[0] and not ok[-1]
    assert int(sol.stats["n_attempts"][-1]) < 200
    assert torch.isnan(sol.ys[0][-1, -1]).all()
    one = T.solve(osc_torch, (xt[0][0], xt[1][0]), pt,
                  saveat=T.SaveAt(ts=ts), stepping=_cfg(T, **tight),
                  gradient="backprop")
    np.testing.assert_allclose(sol.ys[0][:, 0].numpy(), one.ys[0].numpy(),
                               rtol=RTOL_X)
    assert int(sol.stats["n_attempts"][0]) == int(one.stats["n_attempts"])


def test_lane_saveat_keeps_only_the_accepted_rows():
    """The lane SaveAt driver's residuals: per segment the checkpoint rows
    [0, max(n_accepted)) of that segment, cloned (not views of the
    (max_steps + 1, B) buffers), and the params."""
    x0, params = _problem()
    xt, pt = _torch_inputs(x0, params, grad=True)
    sol = T.solve(osc_torch, xt, pt, saveat=T.SaveAt(ts=list(TS)),
                  stepping=_cfg(T), batch_axis=0)
    fn = sol.ys[0].grad_fn
    assert type(fn).__name__ == "_SymplecticSaveAtLanesBackward"
    assert len(fn.segs) == len(TS)
    max_steps = _cfg(T).max_steps
    total = 0
    for xs, ts, hs, n_acc in fn.segs:
        rows = int(n_acc.max())
        assert rows < max_steps
        for buf in list(xs) + [ts, hs]:
            assert buf.shape[0] == rows
            assert buf._base is None           # a clone, not a view
            assert buf.untyped_storage().nbytes() == \
                buf.numel() * buf.element_size()
        total += rows
    assert total < len(TS) * (max_steps + 1)
    assert len(fn.saved_tensors) == 1          # the params


def test_per_sample_ts_squeezes_the_lane_singleton():
    """model_solve_ys with per_sample=True and SaveAt(ts=...) returns
    (len(ts), B, ...): the singleton axis of each lane is axis 2, after
    the observation axis (axis 1 for SaveAt(t1=...))."""
    from repro_torch.models.per_sample import model_solve_ys
    x0, params = _problem()
    xt, pt = _torch_inputs(x0, params)
    ys = model_solve_ys(osc_torch, xt, pt, per_sample=True,
                        saveat=T.SaveAt(ts=list(TS)), stepping=_cfg(T))
    assert ys[0].shape == (len(TS), B, 2) and ys[1].shape == (len(TS), B)
    lanes = T.solve(osc_torch, xt, pt, saveat=T.SaveAt(ts=list(TS)),
                    stepping=_cfg(T), batch_axis=0)
    assert torch.equal(ys[0], lanes.ys[0])
    t1 = model_solve_ys(osc_torch, xt, pt, per_sample=True,
                        saveat=T.SaveAt(t1=1.0), stepping=_cfg(T))
    assert t1[0].shape == (B, 2) and t1[1].shape == (B,)
