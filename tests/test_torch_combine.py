"""PyTorch port: the StageCombiner against the JAX package's.

Every combiner operation of the solvers — stage states, the update, the
fused update+error, the FSAL error, the Eq. (7)/(8) Lambda rows and the
lambda update — on a two-leaf float64 state, through both of the port's
paths (``torch``: plain ops with pruning; ``cuda``: the kernel path, which
on CPU tensors runs the kernels' plain versions), against the JAX
package's ``jnp`` backend.  The kernel path's autograd backward is held
against autograd through the plain ops.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from repro.core.combine import StageCombiner as JCombiner
from repro.core.tableau import get_tableau as jget
from repro_torch.core.combine import StageCombiner as TCombiner
from repro_torch.core.combine import get_combiner
from repro_torch.core.tableau import get_tableau as tget

# float64, same operations in the same order in both packages: the bound is
# rounding (a*b+c fusion may differ between XLA and PyTorch).
RTOL = 1e-14
ATOL = 1e-15
METHODS = ("euler", "heun12", "bosh3", "rk4", "fehlberg45", "dopri5",
           "dopri8")
BACKENDS = ("torch", "cuda")


def _state(seed, lead=()):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=lead + (3, 4)), rng.normal(size=lead + (5,)))


def _to_jax(tree):
    return tuple(jnp.asarray(l) for l in tree)


def _to_torch(tree):
    return tuple(torch.tensor(l) for l in tree)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def _forward_rows(c, x, K, h, tab):
    """Every forward combine of a step: stage states, the update, and the
    embedded error (FSAL-extended or fused with the update)."""
    s = tab.s
    Ks = tuple(l[:s] for l in K)
    out = [c.stage_state(x, Ks, h, i) for i in range(s)]
    out.append(c.solution(x, Ks, h))
    if tab.b_err is not None and tab.err_uses_fsal:
        out.append(c.error(x, K, h))
    elif tab.b_err is not None:
        out.extend(c.solution_and_error(x, Ks, h))
    return out


def _backward_rows(c, lam, L, h, tab):
    """Every backward combine of a step: the Lambda rows and the update."""
    out = [c.lambda_stage(lam, L, h, i) for i in range(tab.s)]
    out.append(c.lambda_update(lam, L, h))
    return out


def _inputs(method):
    s = tget(method).s
    # K has s+1 rows: room for the FSAL error slope
    return _state(1), _state(2, lead=(s + 1,)), _state(3), _state(4,
                                                                lead=(s,))


@functools.lru_cache(maxsize=None)
def _jax_rows(method):
    """The JAX package's results, once per method (both port backends are
    held against them)."""
    x, K, lam, L = (_to_jax(t) for t in _inputs(method))
    jc, jt = JCombiner(jget(method), "jnp"), jget(method)
    return (_forward_rows(jc, x, K, jnp.asarray(0.173), jt),
            _backward_rows(jc, lam, L, jnp.asarray(0.311), jt))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", METHODS)
def test_forward_rows_match_jax(method, backend):
    tt = tget(method)
    x, K, _, _ = (_to_torch(t) for t in _inputs(method))
    got = _forward_rows(TCombiner(tt, backend), x, K,
                        torch.tensor(0.173, dtype=torch.float64), tt)
    want = _jax_rows(method)[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", METHODS)
def test_backward_rows_match_jax(method, backend):
    tt = tget(method)
    _, _, lam, L = (_to_torch(t) for t in _inputs(method))
    got = _backward_rows(TCombiner(tt, backend), lam, L,
                         torch.tensor(0.311, dtype=torch.float64), tt)
    want = _jax_rows(method)[1]
    for g, w in zip(got, want):
        _close(g, w)


def test_backend_knob():
    tab = tget("dopri5")
    x = _to_torch(_state(0))
    assert not get_combiner(tab, "auto").uses_kernel(x)   # CPU tensors
    assert get_combiner(tab, "cuda").uses_kernel(x)
    assert not get_combiner(tab, "torch").uses_kernel(x)
    with pytest.raises(ValueError, match="combine_backend"):
        TCombiner(tab, "pallas")


@pytest.mark.parametrize("coef_grad", [False, True])
def test_kernel_path_backward_matches_autograd(coef_grad):
    """The kernel path's autograd.Function backward (dbase = dout,
    dK[i] = hc[i] dout, and dhc only when asked for) equals autograd
    through the plain ops, for the single-row and the two-row combine."""
    tab = tget("dopri5")
    kern, plain = TCombiner(tab, "cuda"), TCombiner(tab, "torch")
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(6, 3)), requires_grad=True)
    K = torch.tensor(rng.normal(size=(7, 6, 3)), requires_grad=True)
    row = torch.tensor(rng.normal(size=7), requires_grad=coef_grad)
    w = torch.tensor(rng.normal(size=(2, 6, 3)))
    h = torch.tensor(0.21, dtype=torch.float64)
    inputs = [x, K] + ([row] if coef_grad else [])
    grads = []
    for c in (kern, plain):
        (y,) = c.combine((x,), (K,), row, h)
        xn, err = c.solution_and_error((x,), (K,), h)
        loss = (y * w[0]).sum() + (xn[0] * w[1]).sum() + (err[0] ** 2).sum()
        grads.append(torch.autograd.grad(loss, inputs))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13,
                                   atol=1e-14)
