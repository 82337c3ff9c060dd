"""PyTorch port: the CNF workload and its trainer against the JAX package.

``cnf_nll`` value and parameter gradients on the SAME weights (the JAX
package's ``init_cnf`` exported as numpy, loaded with ``params_from_jax``)
and the same data and Hutchinson noise (numpy, from a seed), in float64 on
the CPU, for both trace estimators; then autograd through the solver
against the symplectic adjoint inside torch (the Hutchinson field takes a
VJP inside f, so this is a VJP of a VJP); then two steps of the trainer.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

jax.config.update("jax_enable_x64", True)

from repro.models import cnf as jcnf
from repro_torch.launch import train_cnf
from repro_torch.models import cnf as tcnf

RTOL, ATOL = 1e-9, 1e-11           # value and gradients, float64
DIM, HIDDEN, BATCH, M = 3, (8, 8), 6, 2


def _cfg(mod, **kw):
    base = dict(dim=DIM, hidden=HIDDEN, n_components=M, n_steps=3,
                method="dopri5", rtol=1e-6, atol=1e-8, max_steps=32)
    base.update(kw)
    if mod is jcnf:
        base["combine_backend"] = "jnp"
    return mod.CNFConfig(**base)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(BATCH, DIM)), rng.normal(size=(BATCH, DIM))


@functools.lru_cache(maxsize=None)
def _jax_params():
    p = jax.jit(jcnf.init_cnf, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), _cfg(jcnf), jnp.float64)
    return jax.tree_util.tree_map(np.asarray, p)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(trace, adaptive, grad_mode="symplectic"):
    u, eps = _data()
    cfg = _cfg(jcnf, trace=trace, adaptive=adaptive, grad_mode=grad_mode)
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    # jitted: one compile of the whole loss is cheaper than eager dispatch
    val, g = jax.jit(jax.value_and_grad(jcnf.cnf_nll), static_argnums=3)(
        params, jnp.asarray(u), jnp.asarray(eps), cfg)
    return float(val), jax.tree_util.tree_map(np.asarray, g)


def _torch_value_and_grad(trace, adaptive, grad_mode="symplectic",
                          backend="auto"):
    u, eps = _data()
    cfg = _cfg(tcnf, trace=trace, adaptive=adaptive, grad_mode=grad_mode,
               combine_backend=backend)
    params = tcnf.params_from_jax(_jax_params(), device="cpu")
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    val = tcnf.cnf_nll(params, torch.tensor(u), torch.tensor(eps), cfg)
    grads = torch.autograd.grad(val, leaves)
    return float(val.detach()), pytree.tree_unflatten(
        list(grads), pytree.tree_structure(params))


# every gradient strategy on the fixed grid, and the adjoint's adaptive
# cell; the first two cases keep the ids they had with the symplectic
# adjoint alone
CNF_CASES = [
    pytest.param("hutchinson", True, "symplectic", id="hutchinson-True"),
    pytest.param("exact", False, "symplectic", id="exact-False"),
] + [pytest.param("hutchinson", False, mode, id=f"hutchinson-False-{mode}")
     for mode in ("symplectic", "backprop", "remat_step", "remat_solve",
                  "adjoint")] + [
    pytest.param("hutchinson", True, "adjoint", id="hutchinson-True-adjoint"),
]


@pytest.mark.parametrize("trace,adaptive,grad_mode", CNF_CASES)
def test_cnf_nll_and_gradient_match_jax(trace, adaptive, grad_mode):
    """The JAX package's same strategy on the same weights: for the exact
    strategies a VJP of the Hutchinson VJP through the solver, for the
    adjoint the augmented backward solve of that field."""
    vj, gj = _jax_value_and_grad(trace, adaptive, grad_mode)
    vt, gt = _torch_value_and_grad(trace, adaptive, grad_mode)
    np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)
    for lj, lt in zip(gj["components"], gt["components"]):
        assert sorted(lj) == sorted(lt)
        for k in lj:
            np.testing.assert_allclose(lt[k].numpy(), lj[k], rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_cnf_symplectic_equals_backprop(backend):
    """Exactness on the workload: Algorithm 2 through the Hutchinson field
    (an inner VJP) equals autograd through the solver, to rounding."""
    _, g_sym = _torch_value_and_grad("hutchinson", False, "symplectic",
                                     backend)
    _, g_bp = _torch_value_and_grad("hutchinson", False, "backprop",
                                    backend)
    for a, b in zip(pytree.tree_leaves(g_sym), pytree.tree_leaves(g_bp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_params_from_jax_keeps_layout_and_values():
    p = tcnf.params_from_jax(_jax_params(), device="cpu")
    q = tcnf.init_cnf(_cfg(tcnf), seed=0, device="cpu",
                      dtype=torch.float64)
    assert pytree.tree_structure(p) == pytree.tree_structure(q)
    for a, b, n in zip(pytree.tree_leaves(p), pytree.tree_leaves(q),
                       jax.tree_util.tree_leaves(_jax_params())):
        assert a.shape == b.shape == n.shape and a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), n)
    # fan-in truncated normal, like the JAX init
    w = tcnf.init_cnf(dataclasses.replace(_cfg(tcnf), hidden=(64,)),
                      seed=1, device="cpu")["components"][0]["w"]
    assert w.dtype == torch.float32
    assert float(w.abs().max()) <= 2.0 / math.sqrt(DIM) + 1e-6
    assert abs(float(w.std()) * math.sqrt(DIM) - 0.88) < 0.15


PS_DIM, PS_BATCH = 4, 4             # the per-sample case: dim 4, batch 4


@functools.lru_cache(maxsize=None)
def _per_sample_case(trace, grad_mode="symplectic"):
    """JAX's ``cnf_nll(per_sample=True)`` value and gradients (float64) on
    its own weights, with the inputs from a numpy seed.  The exact
    strategies share one JAX run (symplectic): they agree to rounding."""
    rng = np.random.default_rng(11)
    u, eps = (rng.normal(size=(PS_BATCH, PS_DIM)) for _ in range(2))
    kw = dict(dim=PS_DIM, hidden=HIDDEN, n_components=1, method="dopri5",
              rtol=1e-6, atol=1e-8, max_steps=32, adaptive=True,
              per_sample=True, trace=trace)
    cfg = jcnf.CNFConfig(**kw, combine_backend="jnp", grad_mode=grad_mode)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        jcnf.init_cnf, static_argnums=(1, 2))(jax.random.PRNGKey(1), cfg,
                                              jnp.float64))
    val, g = jax.jit(jax.value_and_grad(jcnf.cnf_nll), static_argnums=3)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(u),
        jnp.asarray(eps), cfg)
    return kw, u, eps, params, float(val), jax.tree_util.tree_map(
        np.asarray, g)


@pytest.mark.parametrize("grad_mode", ["symplectic", "backprop",
                                       "adjoint"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("trace", ["hutchinson", "exact"])
def test_per_sample_cnf_matches_jax(trace, backend, grad_mode):
    """per_sample=True: a step controller per sample (solve(...,
    batch_axis=0)), the field's inner VJP in its torch.func form; value and
    gradients against JAX's per-sample cnf_nll at RTOL, ATOL (the
    adjoint's against JAX's lane-batched adjoint, each lane on its own
    backward grid)."""
    kw, u, eps, jparams, vj, gj = _per_sample_case(
        trace, "adjoint" if grad_mode == "adjoint" else "symplectic")
    cfg = tcnf.CNFConfig(**kw, grad_mode=grad_mode, combine_backend=backend)
    params = tcnf.params_from_jax(jparams, device="cpu")
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    val = tcnf.cnf_nll(params, torch.tensor(u), torch.tensor(eps), cfg)
    grads = torch.autograd.grad(val, leaves)
    np.testing.assert_allclose(float(val.detach()), vj, rtol=RTOL, atol=ATOL)
    for a, b in zip(grads, jax.tree_util.tree_leaves(gj)):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("extra", [[], ["--adaptive"],
                                   ["--adaptive", "--per-sample"],
                                   ["--grad-mode", "adjoint"]])
def test_trainer_two_steps_on_cpu(extra):
    hist = train_cnf.main(["--dataset", "power", "--steps", "2", "--batch",
                           "8", "--hidden", "8", "8", "--n-steps", "2",
                           "--device", "cpu"] + extra)
    assert len(hist) == 2
    for rec in hist:
        assert math.isfinite(rec["nll"]) and math.isfinite(rec["grad_norm"])
        assert rec["grad_norm"] > 0


PATH_TS = (0.25, 0.5, 1.0)


def _path_loss(mod, xs, dlps):
    lib = jnp if mod is jcnf else torch
    return lib.sum(lib.tanh(xs) ** 2) + lib.sum(dlps * dlps)


@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["fixed", "per_sample"])
def test_cnf_flow_path_matches_jax(per_sample):
    """cnf_flow_path: one SaveAt(ts) solve per component, the path states
    and the cumulative delta log p stacked over M * len(ts) points; values
    and the gradient of a loss over the whole path against the JAX
    package's (symplectic adjoint; per_sample=True runs the lane SaveAt
    cell, adaptive, one controller per sample) at RTOL, ATOL."""
    if per_sample:
        kw, u, eps, jparams, _, _ = _per_sample_case("hutchinson")
        jcfg = jcnf.CNFConfig(**kw, combine_backend="jnp")
        tcfg = tcnf.CNFConfig(**kw)
    else:
        u, eps = _data()
        jparams = _jax_params()
        jcfg, tcfg = _cfg(jcnf), _cfg(tcnf)

    def jloss(p):
        xs, dlps = jcnf.cnf_flow_path(p, jnp.asarray(u), jnp.asarray(eps),
                                      jcfg, jnp.asarray(PATH_TS))
        return _path_loss(jcnf, xs, dlps), (xs, dlps)

    (_, (xs_j, dlps_j)), g_j = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, jparams))
    params = tcnf.params_from_jax(jparams, device="cpu")
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    xs, dlps = tcnf.cnf_flow_path(params, torch.tensor(u), torch.tensor(eps),
                                  tcfg, PATH_TS)
    n_points = tcfg.n_components * len(PATH_TS)
    assert xs.shape == (n_points,) + u.shape and \
        dlps.shape == (n_points, u.shape[0])
    for a, b in ((xs, xs_j), (dlps, dlps_j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(_path_loss(tcnf, xs, dlps), leaves)
    for a, b in zip(grads, jax.tree_util.tree_leaves(g_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_cnf_flow_path_endpoint_matches_forward():
    """With one observation at t1 the flow path's last point is
    cnf_forward exactly (the JAX package's
    test_flow_path_endpoint_matches_forward, float64 rtol 1e-12)."""
    u, eps = _data()
    cfg = _cfg(tcnf)
    params = tcnf.params_from_jax(_jax_params(), device="cpu")
    xs, dlps = tcnf.cnf_flow_path(params, torch.tensor(u), torch.tensor(eps),
                                  cfg, [cfg.t1])
    z, dlp = tcnf.cnf_forward(params, torch.tensor(u), torch.tensor(eps),
                              cfg)
    np.testing.assert_allclose(xs[-1].detach().numpy(), z.detach().numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(dlps[-1].detach().numpy(),
                               dlp.detach().numpy(), rtol=1e-12)
