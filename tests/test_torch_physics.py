"""PyTorch port: the physics workload (the paper's Table 4, HNN++ on KdV /
Cahn-Hilliard) against the JAX package.

Float64 on the CPU at a tiny width (grid 16, channels 4, hidden 8, a
batch of 3 trajectories, 2 snapshot intervals), the same weights (the JAX
package's ``init_energy_net`` exported as numpy, loaded with
``params_from_jax``) and the same snapshots (``data/physics_gen.py`` in
both packages, which must give the same arrays from the same seed).
``physics_loss`` (one interval, ``SaveAt(t1)``) and ``rollout_loss`` (one
``SaveAt(ts)`` solve over the snapshots) with the symplectic adjoint:
values and parameter gradients at rtol 1e-10, atol 1e-12 (the earlier
slices' bound), fixed, adaptive and per-sample; inside torch the
symplectic gradient equals DirectBackprop's at the same bound.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

jax.config.update("jax_enable_x64", True)

from repro.data import physics_gen as jgen
from repro.models import physics as jphys
from repro_torch.data import physics_gen as tgen
from repro_torch.launch import train_physics
from repro_torch.models import physics as tphys

RTOL, ATOL = 1e-10, 1e-12
WIDTH = dict(grid=16, channels=4, hidden=8)
HORIZON = 2
CASES = {"fixed": dict(method="dopri5", n_steps=2),
         "fixed_dopri8": dict(method="dopri8", n_steps=1),
         "adaptive": dict(method="dopri5", adaptive=True, rtol=1e-6,
                          atol=1e-8, max_steps=32),
         "per_sample": dict(method="dopri5", adaptive=True, rtol=1e-6,
                            atol=1e-8, max_steps=32, per_sample=True)}


@pytest.mark.parametrize("system", ["kdv", "cahn_hilliard"])
def test_physics_gen_arrays_equal(system):
    kw = dict(n_traj=2, grid=16, n_snapshots=4, seed=3, substeps=10)
    a = jgen.generate_trajectories(system, **kw)
    b = tgen.generate_trajectories(system, **kw)
    assert a.dtype == b.dtype == np.float32 and a.shape == (2, 4, 16)
    assert np.array_equal(a, b)


@functools.lru_cache(maxsize=None)
def _inputs(system):
    """The JAX package's float64 weights (numpy) and a (HORIZON + 1, 3,
    grid) window of snapshots."""
    cfg = jphys.PhysicsConfig(**WIDTH, system=system)
    params = jax.tree_util.tree_map(np.asarray, jphys.init_energy_net(
        jax.random.PRNGKey(0), cfg, jnp.float64))
    trajs = jgen.generate_trajectories(system, n_traj=3, grid=WIDTH["grid"],
                                       n_snapshots=HORIZON + 1, seed=1,
                                       substeps=10)
    return params, np.transpose(trajs, (1, 0, 2)).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _jax_loss(system, case, loss):
    params, u = _inputs(system)
    cfg = jphys.PhysicsConfig(**WIDTH, system=system, combine_backend="jnp",
                              **CASES[case])
    if loss == "physics":
        fn = functools.partial(jphys.physics_loss, u_k=jnp.asarray(u[0]),
                               u_k1=jnp.asarray(u[1]), cfg=cfg)
    else:
        fn = functools.partial(jphys.rollout_loss, u_traj=jnp.asarray(u),
                               cfg=cfg)
    val, g = jax.jit(jax.value_and_grad(fn))(
        jax.tree_util.tree_map(jnp.asarray, params))
    return float(val), [np.asarray(l) for l in jax.tree_util.tree_leaves(g)]


def _torch_loss(system, case, loss, grad_mode="symplectic",
                backend="auto"):
    params, u = _inputs(system)
    cfg = tphys.PhysicsConfig(**WIDTH, system=system, grad_mode=grad_mode,
                              combine_backend=backend, **CASES[case])
    tp = tphys.params_from_jax(params, device="cpu")
    leaves = pytree.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    ut = torch.tensor(u)
    val = tphys.physics_loss(tp, ut[0], ut[1], cfg) if loss == "physics" \
        else tphys.rollout_loss(tp, ut, cfg)
    return float(val.detach()), [g.numpy() for g in
                                 torch.autograd.grad(val, leaves)]


# the SaveAt rollout in every stepping; the one-interval loss (SaveAt(t1))
# on the fixed grid
LOSS_CASES = [("fixed", "physics"), ("fixed_dopri8", "rollout"),
              ("adaptive", "rollout"), ("per_sample", "rollout")]


@pytest.mark.parametrize("case,loss", LOSS_CASES)
def test_physics_losses_match_jax(case, loss):
    """KdV: the loss and its parameter gradients (symplectic adjoint)
    against the JAX package's."""
    vj, gj = _jax_loss("kdv", case, loss)
    vt, gt = _torch_loss("kdv", case, loss)
    np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)
    assert len(gt) == len(gj) == 5
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_cahn_hilliard_rollout_matches_jax():
    """G = d^2/dx^2: the Cahn-Hilliard field through the SaveAt rollout."""
    vj, gj = _jax_loss("cahn_hilliard", "fixed", "rollout")
    vt, gt = _torch_loss("cahn_hilliard", "fixed", "rollout")
    np.testing.assert_allclose(vt, vj, rtol=RTOL, atol=ATOL)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("case", ["fixed_dopri8", "adaptive",
                                  "per_sample"])
def test_rollout_symplectic_equals_backprop(case, backend):
    """Exactness inside torch on the physics field, which differentiates
    the energy net itself: the symplectic SaveAt gradient equals autograd
    through the solver (a VJP of a gradient), on both combine paths."""
    vs, gs = _torch_loss("kdv", case, "rollout", "symplectic", backend)
    vb, gb = _torch_loss("kdv", case, "rollout", "backprop", backend)
    assert vs == vb
    for a, b in zip(gs, gb):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_init_energy_net_layout():
    cfg = tphys.PhysicsConfig(**WIDTH)
    p = tphys.init_energy_net(cfg, seed=0, device="cpu")
    params, _ = _inputs("kdv")
    assert list(p) == sorted(params)          # JAX's leaf order
    for k, v in p.items():
        assert v.shape == params[k].shape and v.dtype == torch.float32
    assert float(p["conv_w"].abs().max()) <= 2.0 / math.sqrt(3) + 1e-6
    q = tphys.init_energy_net(cfg, seed=0, device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)


def test_trainer_steps_and_rollout_on_cpu():
    """The trainer's loop and its held-out SaveAt rollout at a tiny width
    (the CLI runs the example's full settings on the card)."""
    cfg = tphys.PhysicsConfig(**WIDTH, method="dopri5", n_steps=2)
    trajs = tgen.generate_trajectories("kdv", n_traj=2, grid=WIDTH["grid"],
                                       n_snapshots=4, substeps=10)
    params, history = train_physics.train(cfg, trajs, steps=2, batch=2,
                                          lr=3e-3, device="cpu")
    assert len(history) == 2
    for rec in history:
        assert math.isfinite(rec["mse"]) and rec["grad_norm"] > 0
    errs = train_physics.held_out_rollout(params, trajs, cfg, "cpu",
                                          horizon=3)
    assert len(errs) == 3 and all(math.isfinite(e) for e in errs)
