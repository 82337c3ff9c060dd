"""PyTorch port: the Mamba block (``repro_torch.nn.mamba``) against the JAX
package's ``repro.nn.mamba``, on the CPU, from JAX's weights.

Routes: training (no state), prefill (a state: the output and the state
after the last position), decode (S == 1 with a state), and the gradient
of the training route (the port recomputes each chunk in the backward).
Tolerances, relative to the largest entry:
  * float64, both packages' float32 casts lifted (JAX's float32 leaves
    A_log, D and dt_bias taken to float64 too): 1e-12.  JAX scans a chunk
    with an associative (tree) scan, the port step by step, so the two
    round differently: the bound is the rounding of a 2-chunk scan, ~1e-15
    measured here.
  * float32, each package as it ships: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo
from repro.nn import mamba as jm
from repro_torch.nn import mamba as tm

B, S, D = 2, 24, 16
TOL = {"float64": 1e-12, "float32": 1e-5}
single_thread = pytest.fixture(autouse=True)(torch_zoo.one_thread)


def _setup(dtype, chunk=8):
    jcfg = jm.MambaConfig(d_model=D, d_state=8, chunk=chunk)
    tcfg = tm.MambaConfig(d_model=D, d_state=8, chunk=chunk)
    p = jm.init_mamba(jax.random.PRNGKey(0), jcfg,
                      getattr(jnp, dtype))
    if dtype == "float64":
        p = torch_zoo.upcast(p)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, D)).astype(dtype)
    x1 = rng.normal(size=(B, 1, D)).astype(dtype)
    return jcfg, tcfg, p, tp, x, x1


def test_configs_and_init_match_jax():
    jcfg = jm.MambaConfig(d_model=4096)
    tcfg = tm.MambaConfig(d_model=4096)
    assert (tcfg.d_inner, tcfg.rank) == (jcfg.d_inner, jcfg.rank) == \
        (8192, 256)
    p = jm.init_mamba(jax.random.PRNGKey(0), jm.MambaConfig(d_model=D))
    tp = tm.init_mamba(torch.Generator().manual_seed(0),
                       tm.MambaConfig(d_model=D), device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in p.items()} == \
        {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
         for k, v in tp.items()}
    # the deterministic leaves are JAX's, to one float32 ulp (each
    # library's log rounds on its own); dt_bias = softplus^-1(dt), dt in
    # [1e-3, 1e-1]
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(p["A_log"]),
                               rtol=2.0 ** -23, atol=0)
    np.testing.assert_array_equal(tp["D"].numpy(), np.asarray(p["D"]))
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-6) and \
        float(dt.max()) <= 1e-1 * (1 + 1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_training_route_matches_jax(dtype, monkeypatch):
    jcfg, tcfg, p, tp, x, _ = _setup(dtype)
    if dtype == "float64":
        torch_zoo.lift(monkeypatch)
    yj, sj = jm.mamba_forward(p, jnp.asarray(x), jcfg)
    yt, st = tm.mamba_forward(tp, torch.tensor(x), tcfg)
    assert sj is None and st is None
    torch_zoo.rel(yt, yj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_prefill_then_decode_matches_jax(dtype, monkeypatch):
    """The prefill's output and state (conv buffer, ssm state after the
    last position), then two decode steps from it."""
    jcfg, tcfg, p, tp, x, x1 = _setup(dtype)
    if dtype == "float64":
        torch_zoo.lift(monkeypatch)
    js = jm.init_mamba_state(jcfg, B)
    ts = tm.init_mamba_state(tcfg, B, device="cpu")
    assert ts["ssm"].dtype == ts["conv"].dtype == torch.float32
    yj, js = jm.mamba_forward(p, jnp.asarray(x), jcfg, state=js)
    yt, ts = tm.mamba_forward(tp, torch.tensor(x), tcfg, state=ts)
    torch_zoo.rel(yt, yj, TOL[dtype])
    for k in ("conv", "ssm"):
        torch_zoo.rel(ts[k], js[k], TOL[dtype])
    for step in (x1, -x1):
        yj, js = jm.mamba_forward(p, jnp.asarray(step), jcfg, state=js)
        yt, ts = tm.mamba_forward(tp, torch.tensor(step), tcfg, state=ts)
        torch_zoo.rel(yt, yj, TOL[dtype])
        for k in ("conv", "ssm"):
            torch_zoo.rel(ts[k], js[k], TOL[dtype])


def test_decode_recurrence_equals_the_scan(monkeypatch):
    """Decoding the prompt token by token from the zero state gives the
    chunked scan's outputs and final state (float64, lifted), in both
    packages."""
    jcfg, tcfg, p, tp, x, _ = _setup("float64")
    torch_zoo.lift(monkeypatch)
    yt, st = tm.mamba_forward(tp, torch.tensor(x), tcfg,
                              state=tm.init_mamba_state(tcfg, B,
                                                        device="cpu"))
    yj, sj = jm.mamba_forward(p, jnp.asarray(x), jcfg,
                              state=jm.init_mamba_state(jcfg, B))
    rt = tm.init_mamba_state(tcfg, B, device="cpu")
    rj = jm.init_mamba_state(jcfg, B)
    for t in range(S):
        y1, rt = tm.mamba_forward(tp, torch.tensor(x[:, t:t + 1]), tcfg,
                                  state=rt)
        j1, rj = jm.mamba_forward(p, jnp.asarray(x[:, t:t + 1]), jcfg,
                                  state=rj)
        torch_zoo.rel(y1, yt[:, t:t + 1].detach(), 1e-12)
        torch_zoo.rel(j1, yj[:, t:t + 1], 1e-12)
    torch_zoo.rel(rt["ssm"], st["ssm"], 1e-12)
    torch_zoo.rel(rj["ssm"], sj["ssm"], 1e-12)


def test_gradient_matches_jax(monkeypatch):
    """The training route's gradients (input and every weight) through the
    per-chunk recomputation, against ``jax.grad`` (float64, lifted)."""
    jcfg, tcfg, p, tp, x, _ = _setup("float64")
    torch_zoo.lift(monkeypatch)

    def jloss(pp, xx):
        return jnp.sum(jm.mamba_forward(pp, xx, jcfg)[0] ** 2)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.tensor(x, requires_grad=True)
    (tm.mamba_forward(leaves, xt, tcfg)[0] ** 2).sum().backward()
    torch_zoo.rel(xt.grad, gx, 1e-12)
    for k, v in leaves.items():
        torch_zoo.rel(v.grad, gp[k], 1e-11)


def test_chunk_contract():
    """Above one chunk a sequence must be whole chunks (JAX asserts it);
    at or below one chunk any length runs as one chunk."""
    jcfg, tcfg, p, tp, x, _ = _setup("float32", chunk=16)
    with pytest.raises(ValueError, match="whole number"):
        tm.mamba_forward(tp, torch.tensor(x), tcfg)      # 24 = 1.5 chunks
    yt, _ = tm.mamba_forward(tp, torch.tensor(x[:, :12]), tcfg)
    yj, _ = jm.mamba_forward(p, jnp.asarray(x[:, :12]), jcfg)
    torch_zoo.rel(yt, yj, 1e-5)
