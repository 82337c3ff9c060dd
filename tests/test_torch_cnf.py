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
def _jax_value_and_grad(trace, adaptive):
    u, eps = _data()
    cfg = _cfg(jcnf, trace=trace, adaptive=adaptive)
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


@pytest.mark.parametrize("trace,adaptive", [("hutchinson", True),
                                            ("exact", False)])
def test_cnf_nll_and_gradient_match_jax(trace, adaptive):
    vj, gj = _jax_value_and_grad(trace, adaptive)
    vt, gt = _torch_value_and_grad(trace, adaptive)
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


def test_per_sample_names_its_roadmap_item():
    u, eps = _data()
    cfg = _cfg(tcnf, adaptive=True, per_sample=True)
    params = tcnf.params_from_jax(_jax_params(), device="cpu")
    with pytest.raises(ValueError, match="item 10"):
        tcnf.cnf_nll(params, torch.tensor(u), torch.tensor(eps), cfg)


@pytest.mark.parametrize("extra", [[], ["--adaptive"]])
def test_trainer_two_steps_on_cpu(extra):
    hist = train_cnf.main(["--dataset", "power", "--steps", "2", "--batch",
                           "8", "--hidden", "8", "8", "--n-steps", "2",
                           "--device", "cpu"] + extra)
    assert len(hist) == 2
    for rec in hist:
        assert math.isfinite(rec["nll"]) and math.isfinite(rec["grad_norm"])
        assert rec["grad_norm"] > 0
