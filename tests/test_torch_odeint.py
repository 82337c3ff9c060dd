"""PyTorch port: the deprecated ``odeint`` / ``odeint_with_stats`` shims
(``repro_torch.core.odeint``) against the JAX package's.

Float64 on the CPU, the same numpy inputs for both packages: values and
gradients within 1e-12 relative per leaf, integer stats exactly equal, for
the five grad modes x t1 / ts / dense, fixed and adaptive.  The JAX
package cannot reverse through its adaptive DirectBackprop, so the port's
adaptive backprop gradient is held against JAX's symplectic one (both are
the gradient of the same discrete map).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import repro.core as J
from repro.core.odeint import TS_MODES as J_TS_MODES
import repro_torch.core as T

# Deliberately exercises the deprecated odeint shims.
pytestmark = pytest.mark.filterwarnings(
    "ignore:odeint-style entry point:DeprecationWarning")

RTOL = 1e-12
ADAPTIVE_MODES = ("symplectic", "backprop", "adjoint")
TS = np.array([0.3, 0.55, 1.0])


def _problem(seed=0, d=4, hidden=8):
    rng = np.random.default_rng(seed)
    params = {"w1": rng.normal(size=(d, hidden)) * 0.5,
              "b1": rng.normal(size=hidden) * 0.2,
              "w2": rng.normal(size=(hidden, d)) * 0.5}
    return rng.normal(size=d), params


def field_jax(x, t, p):
    return jnp.tanh(x @ p["w1"] + p["b1"] + t) @ p["w2"]


def field_torch(x, t, p):
    return torch.tanh(x @ p["w1"] + p["b1"] + t) @ p["w2"]


def _cfg(mod, **kw):
    base = dict(rtol=1e-8, atol=1e-10, max_steps=64, initial_step=0.3)
    base.update(kw)
    return mod.AdaptiveConfig(**base)


def _kwargs(mod, obs, stepping):
    kw = {"method": "dopri5"}
    if obs == "t1":
        kw["t1"] = 1.0
    else:
        kw["ts"] = TS
        if obs == "dense":
            kw["ts_mode"] = "dense"
    if stepping == "fixed":
        kw["n_steps"] = 5
    else:
        kw["adaptive"] = _cfg(mod)
    return kw


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= rtol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _jax_run(mode, obs, stepping, x0, params, grad=True):
    kw = _kwargs(J, obs, stepping)
    px = {k: jnp.asarray(v) for k, v in params.items()}

    def loss(p):
        y = J.odeint(field_jax, jnp.asarray(x0), p, grad_mode=mode, **kw)
        return jnp.sum(jnp.sin(y) ** 2), y
    if not grad:
        return np.asarray(jax.jit(loss)(px)[1]), None
    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(px)
    return np.asarray(y), {k: np.asarray(v) for k, v in g.items()}


def _torch_run(mode, obs, stepping, x0, params, grad=True):
    kw = _kwargs(T, obs, stepping)
    p = {k: torch.tensor(v, requires_grad=grad) for k, v in params.items()}
    y = T.odeint(field_torch, torch.tensor(x0), p, grad_mode=mode, **kw)
    if not grad:
        return y.detach().numpy(), None
    g = torch.autograd.grad(torch.sum(torch.sin(y) ** 2), list(p.values()))
    return y.detach().numpy(), {k: v.numpy() for k, v in zip(p, g)}


CASES = ([(m, o, "fixed") for m in T.GRAD_MODES for o in ("t1", "ts")]
         + [(m, o, "adaptive") for m in ADAPTIVE_MODES for o in ("t1", "ts")]
         + [("backprop", "dense", "adaptive")])


@pytest.mark.parametrize("mode,obs,stepping", CASES)
def test_odeint_matches_jax(mode, obs, stepping):
    x0, params = _problem()
    dense = obs == "dense"
    y_t, g_t = _torch_run(mode, obs, stepping, x0, params, grad=not dense)
    y_j, g_j = _jax_run(mode, obs, stepping, x0, params,
                        grad=not dense and not (
                            mode == "backprop" and stepping == "adaptive"))
    _close(y_t, y_j)
    if dense:
        return
    if g_j is None:        # JAX's adaptive DirectBackprop: value/JVP only
        _, g_j = _jax_run("symplectic", obs, stepping, x0, params)
    for k in params:
        _close(g_t[k], g_j[k])


STATS_CASES = [("t1", "fixed", {}), ("ts", "fixed", {}),
               ("t1", "adaptive", {}), ("ts", "adaptive", {}),
               # from initial_step 1e-3 the first error estimate is not at
               # rounding level, so the truncated grids agree
               ("t1", "adaptive", {"max_steps": 2, "initial_step": 1e-3})]


@pytest.mark.parametrize("obs,stepping,over", STATS_CASES)
def test_odeint_with_stats_matches_jax(obs, stepping, over):
    """Stats keys and integers equal; with ts and an adaptive config the
    observations are Hermite dense output; an exhausted budget is reported
    in stats["succeeded"], never NaN-poisoned."""
    x0, params = _problem(1)
    out = {}
    for mod, f, arr in ((J, field_jax, jnp.asarray),
                        (T, field_torch, torch.tensor)):
        kw = {"method": "dopri5"}
        if obs == "t1":
            kw["t1"] = 1.0
        else:
            kw["ts"] = TS
        if stepping == "fixed":
            kw["n_steps"] = 5
        else:
            kw["adaptive"] = _cfg(mod, **over)
        y, stats = mod.odeint_with_stats(
            f, arr(x0), {k: arr(v) for k, v in params.items()}, **kw)
        out[mod] = (np.asarray(y), {k: int(v) for k, v in stats.items()})
    (y_j, s_j), (y_t, s_t) = out[J], out[T]
    assert s_t == s_j
    assert set(s_t) == ({"n_steps", "n_fevals"} if stepping == "fixed"
                        else {"n_steps", "n_fevals", "n_attempts",
                              "succeeded"})
    assert np.all(np.isfinite(y_t))
    _close(y_t, y_j)
    if over:
        assert s_t["succeeded"] == 0


def test_odeint_warns_deprecation():
    x0, params = _problem()
    p = {k: torch.tensor(v) for k, v in params.items()}
    for fn in (T.odeint, T.odeint_with_stats):
        with pytest.warns(DeprecationWarning,
                          match=rf"^odeint-style entry point "
                                rf"{fn.__name__}\(\) is deprecated"):
            fn(field_torch, torch.tensor(x0), p, n_steps=2)


def test_odeint_rejects_what_jax_rejects():
    x0, params = _problem()
    p = {k: torch.tensor(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="ts_mode"):
        T.odeint(field_torch, torch.tensor(x0), p, ts=TS, ts_mode="bad")
    with pytest.raises(ValueError, match="EITHER t1 or ts"):
        T.odeint(field_torch, torch.tensor(x0), p, ts=TS, t1=1.0)
    with pytest.raises(ValueError, match="EITHER t1 or ts"):
        T.odeint_with_stats(field_torch, torch.tensor(x0), p, ts=TS,
                            t1=1.0)
    assert T.GRAD_MODES == J.GRAD_MODES
    assert T.TS_MODES == J_TS_MODES
