"""PyTorch port: the xLSTM blocks (``repro_torch.nn.xlstm``: mLSTM in its
parallel, chunkwise and recurrent forms, sLSTM) against the JAX package's
``repro.nn.xlstm``, on the CPU, from JAX's weights; and the port's own
form checks of ``tests/test_xlstm_forms.py`` (chunkwise == parallel in
values, gradients and carry; the ``auto`` switch).

Tolerances, relative to the largest entry:
  * float64, both packages' float32 casts lifted (JAX's float32 leaves
    wi, wf, r, b taken to float64 too): 1e-12 (~1e-15 measured).
  * float32, each package as it ships: 1e-5.
  * the port's chunkwise form against its parallel form, float64: 1e-12
    for values, gradients and the carry (the two forms are equal up to
    rounding; JAX's own test holds them at 2e-4 / 5e-3 in float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo
from repro.nn import xlstm as jx
from repro_torch.nn import xlstm as tx

B, S, D = 2, 16, 16
TOL = {"float64": 1e-12, "float32": 1e-5}
single_thread = pytest.fixture(autouse=True)(torch_zoo.one_thread)


def _cfgs(**kw):
    return jx.XLSTMConfig(d_model=D, n_heads=4, **kw), \
        tx.XLSTMConfig(d_model=D, n_heads=4, **kw)


def _params(init, dtype, seed):
    jc, _ = _cfgs()
    p = getattr(jx, init)(jax.random.PRNGKey(seed), jc, getattr(jnp, dtype))
    if dtype == "float64":
        p = torch_zoo.upcast(p)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), p)
    return p, tp


def _x(dtype, n=S, seed=0, scale=0.5):
    return (np.random.default_rng(seed).normal(size=(B, n, D))
            * scale).astype(dtype)


def _state(pkg, kind, cfg):
    if pkg is jx:
        return getattr(jx, f"init_{kind}_state")(cfg, B)
    return getattr(tx, f"init_{kind}_state")(cfg, B, device="cpu")


def _run(pkg, p, x, cfg, kind="mlstm", state=None):
    fwd = getattr(pkg, f"{kind}_forward")
    if pkg is jx:      # one compile instead of op-by-op dispatch
        return jax.jit(lambda pp, xx, st: fwd(pp, xx, cfg, state=st))(
            p, jnp.asarray(x), state)
    return fwd(p, torch.tensor(x), cfg, state=state)


# ---------------------------------------------------------------------------
# mLSTM against JAX

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("form", ["parallel", "chunkwise"])
def test_mlstm_training_matches_jax(form, dtype, monkeypatch):
    jc, tc = _cfgs(m_form=form, m_chunk=8)
    p, tp = _params("init_mlstm", dtype, 1)
    x = _x(dtype)
    if dtype == "float64":
        torch_zoo.lift(monkeypatch)
    yj, _ = _run(jx, p, x, jc)
    yt, _ = _run(tx, tp, x, tc)
    torch_zoo.rel(yt, yj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("form", ["parallel", "chunkwise"])
def test_mlstm_prefill_then_decode_matches_jax(form, dtype, monkeypatch):
    """The prefill's output and state (C, n, m, conv) from either form,
    then two recurrent decode steps."""
    jc, tc = _cfgs(m_form=form, m_chunk=8)
    p, tp = _params("init_mlstm", dtype, 1)
    x, x1 = _x(dtype), _x(dtype, 1, seed=3, scale=1.0)
    if dtype == "float64":
        torch_zoo.lift(monkeypatch)
    yj, sj = _run(jx, p, x, jc, state=_state(jx, "mlstm", jc))
    yt, st = _run(tx, tp, x, tc, state=_state(tx, "mlstm", tc))
    torch_zoo.rel(yt, yj, TOL[dtype])
    for step in (x1, -x1):
        for k in ("conv", "C", "n", "m"):
            torch_zoo.rel(st[k], sj[k], TOL[dtype])
        yj, sj = _run(jx, p, step, jc, state=sj)
        yt, st = _run(tx, tp, step, tc, state=st)
        torch_zoo.rel(yt, yj, TOL[dtype])


def test_mlstm_prefill_then_decode_equals_recurrent_decode(monkeypatch):
    """Prefill-then-decode against decoding the same prompt token by token
    from ``init_mlstm_state`` (m = 0, where the forms start from -inf), in
    both packages (float64, lifted): the outputs, the state and the next
    step agree to rounding, and the port's recurrence is JAX's."""
    jc, tc = _cfgs()
    p, tp = _params("init_mlstm", "float64", 1)
    x, x1 = _x("float64"), _x("float64", 1, seed=3, scale=1.0)
    torch_zoo.lift(monkeypatch)
    for pkg, pp, cfg in ((jx, p, jc), (tx, tp, tc)):
        y, st = _run(pkg, pp, x, cfg, state=_state(pkg, "mlstm", cfg))
        rec, ys = _state(pkg, "mlstm", cfg), []
        for t in range(S):
            o, rec = _run(pkg, pp, x[:, t:t + 1], cfg, state=rec)
            ys.append(np.asarray(o))
        torch_zoo.rel(np.concatenate(ys, 1), np.asarray(y), 1e-12)
        for k in ("C", "n", "m"):
            torch_zoo.rel(rec[k], st[k], 1e-12)
        a, _ = _run(pkg, pp, x1, cfg, state=st)
        b, _ = _run(pkg, pp, x1, cfg, state=rec)
        torch_zoo.rel(b, a, 1e-12)


# ---------------------------------------------------------------------------
# mLSTM forms (tests/test_xlstm_forms.py's four, on the port)

def _forms(S_=32, d=32):
    cfgP = tx.XLSTMConfig(d_model=d, n_heads=4, m_form="parallel")
    cfgC = tx.XLSTMConfig(d_model=d, n_heads=4, m_form="chunkwise",
                          m_chunk=16)
    g = torch.Generator().manual_seed(0)
    p = tx.init_mlstm(g, cfgP, dtype=torch.float64, device="cpu")
    p = {k: (v.double() if isinstance(v, torch.Tensor)
             else {kk: vv.double() for kk, vv in v.items()})
         for k, v in p.items()}
    x = torch.randn((2, S_, d), generator=g, dtype=torch.float64) * 0.5
    return cfgP, cfgC, p, x


def test_chunkwise_matches_parallel_values(monkeypatch):
    torch_zoo.lift(monkeypatch)
    cfgP, cfgC, p, x = _forms()
    yp, _ = tx.mlstm_forward(p, x, cfgP)
    yc, _ = tx.mlstm_forward(p, x, cfgC)
    torch_zoo.rel(yc, yp, 1e-12)


def test_chunkwise_matches_parallel_grads(monkeypatch):
    """Gradients through each form (each query block or chunk recomputed
    in the backward), equal to rounding; and the parallel form's equal to
    JAX's ``jax.grad``."""
    torch_zoo.lift(monkeypatch)
    cfgP, cfgC, p, x = _forms()
    grads = {}
    for name, cfg in (("P", cfgP), ("C", cfgC)):
        leaves = {k: (v.clone().requires_grad_()
                      if isinstance(v, torch.Tensor) else
                      {kk: vv.clone().requires_grad_()
                       for kk, vv in v.items()}) for k, v in p.items()}
        (tx.mlstm_forward(leaves, x, cfg)[0] ** 2).sum().backward()
        grads[name] = jax.tree_util.tree_map(lambda t: t.grad, leaves)
    for a, b in zip(jax.tree_util.tree_leaves(grads["C"]),
                    jax.tree_util.tree_leaves(grads["P"])):
        torch_zoo.rel(a, b, 1e-12)
    jc = jx.XLSTMConfig(d_model=32, n_heads=4, m_form="parallel")
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p)
    gj = jax.jit(jax.grad(lambda pp: jnp.sum(jx.mlstm_forward(
        pp, jnp.asarray(x.numpy()), jc)[0] ** 2)))(jp)
    for a, b in zip(jax.tree_util.tree_leaves(grads["P"]),
                    jax.tree_util.tree_leaves(gj)):
        torch_zoo.rel(a, b, 1e-12)


def test_chunkwise_carry_matches_recurrent_decode(monkeypatch):
    """The chunkwise final carry equals rolling the O(1) decode recurrence
    token by token, so the prefill -> decode handoff is consistent."""
    torch_zoo.lift(monkeypatch)
    cfgP, cfgC, p, x = _forms(S_=48, d=16)
    _, stC = tx.mlstm_forward(p, x, cfgC,
                              state=tx.init_mlstm_state(cfgC, 2,
                                                        device="cpu"))
    st = tx.init_mlstm_state(cfgP, 2, device="cpu")
    for t in range(48):
        _, st = tx.mlstm_forward(p, x[:, t:t + 1], cfgP, state=st)
    for k in ("C", "n", "m"):
        torch_zoo.rel(stC[k], st[k], 1e-12)


def test_auto_form_switches_on_length(monkeypatch):
    """``m_form="auto"`` takes the chunkwise form from m_chunkwise_min_s
    positions on (a whole number of chunks, more than one), the parallel
    form below; both finite and equal to JAX's at each length."""
    jc = jx.XLSTMConfig(d_model=32, n_heads=4, m_form="auto", m_chunk=16,
                        m_chunkwise_min_s=64)
    tc = tx.XLSTMConfig(d_model=32, n_heads=4, m_form="auto", m_chunk=16,
                        m_chunkwise_min_s=64)
    p = jx.init_mlstm(jax.random.PRNGKey(0), jc)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), p)
    calls = []
    real = tx._mlstm_chunkwise
    monkeypatch.setattr(tx, "_mlstm_chunkwise",
                        lambda *a: calls.append(a[0].shape[2]) or real(*a))
    for n in (32, 64):     # below / at the threshold
        x = np.random.default_rng(n).normal(size=(1, n, 32)) \
            .astype(np.float32)
        yt, _ = tx.mlstm_forward(tp, torch.tensor(x), tc)
        yj, _ = _run(jx, p, x, jc)
        assert bool(torch.isfinite(yt).all())
        torch_zoo.rel(yt, yj, 1e-5)
    assert calls == [64]


# ---------------------------------------------------------------------------
# sLSTM

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_slstm_training_matches_jax(dtype, monkeypatch):
    jc, tc = _cfgs()
    p, tp = _params("init_slstm", dtype, 3)
    x = _x(dtype)
    if dtype == "float64":
        torch_zoo.lift(monkeypatch)
    yj, _ = _run(jx, p, x, jc, "slstm")
    yt, _ = _run(tx, tp, x, tc, "slstm")
    torch_zoo.rel(yt, yj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_slstm_prefill_then_decode_matches_jax(dtype, monkeypatch):
    """Prefill from ``init_slstm_state`` (its state after the last
    position), then two decode steps (one cell step each)."""
    jc, tc = _cfgs()
    p, tp = _params("init_slstm", dtype, 3)
    x, x1 = _x(dtype), _x(dtype, 1, seed=3, scale=1.0)
    if dtype == "float64":
        torch_zoo.lift(monkeypatch)
    sj, st = _state(jx, "slstm", jc), _state(tx, "slstm", tc)
    for inp in (x, x1, -x1):
        yj, sj = _run(jx, p, inp, jc, "slstm", state=sj)
        yt, st = _run(tx, tp, inp, tc, "slstm", state=st)
        torch_zoo.rel(yt, yj, TOL[dtype])
        for k in "cnhm":
            torch_zoo.rel(st[k], sj[k], TOL[dtype])


def test_slstm_time_chunks_and_gradient(monkeypatch):
    """Past 256 steps the cell runs in chunks of 256 (each recomputed in
    the backward): values and input gradients equal to JAX's two-level
    scan (float64, lifted)."""
    jc, tc = _cfgs()
    p, tp = _params("init_slstm", "float64", 3)
    x = _x("float64", 512)
    torch_zoo.lift(monkeypatch)
    gj = jax.jit(jax.grad(lambda xx: jnp.sum(
        jx.slstm_forward(p, xx, jc)[0] ** 2)))(jnp.asarray(x))
    leaves = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(),
                                    tp)
    xt = torch.tensor(x, requires_grad=True)
    (tx.slstm_forward(leaves, xt, tc)[0] ** 2).sum().backward()
    torch_zoo.rel(xt.grad, gj, 1e-12)
    assert leaves["r"].grad is not None


def test_layernorm_matches_jax(monkeypatch):
    from repro.nn import norm as jn
    from repro_torch.nn import norm as tn
    x = np.random.default_rng(0).normal(size=(3, 5, 24)) * 3 + 1
    p = {"w": np.linspace(0.5, 1.5, 24), "b": np.linspace(-1, 1, 24)}
    for dtype, tol in (("float32", 1e-6), ("float64", 1e-15)):
        if dtype == "float64":
            torch_zoo.lift(monkeypatch)
        jp = {k: jnp.asarray(v.astype(dtype)) for k, v in p.items()}
        tp = {k: torch.tensor(v.astype(dtype)) for k, v in p.items()}
        got = tn.layernorm(tp, torch.tensor(x.astype(dtype)))
        want = jn.layernorm(jp, jnp.asarray(x.astype(dtype)))
        assert str(got.dtype) == f"torch.{dtype}"
        torch_zoo.rel(got, want, tol)
