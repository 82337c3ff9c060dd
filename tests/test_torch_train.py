"""PyTorch port: the LM training slice (losses, the plain backward
versions of the LM kernels, node mode, the train step) against the JAX
package at the qwen3-0.6b SMOKE width, on the CPU.

Tolerances, with their reasons:
  * losses and the plain backward versions in float64: 1e-12 (relative to
    the largest entry).  The JAX package casts logits and the RMSNorm /
    attention inputs to float32 inside; to compare the algorithms both
    sides run in float64 (the JAX functions with those float32 casts
    lifted to float64 for the call, ``_lift``); in float32 the stock
    functions agree to float32 rounding (2e-5).
  * a whole train step from the same state (``train_state_from_jax``):
    RMSNorm, RoPE and attention compute in float32 inside in both
    packages (as tests/test_torch_lm.py states), and AdamW keeps float32
    moments and float32 master copies of the float64 params (the JAX
    package's rule), so loss, grad_norm, params and optimizer state agree
    to 1e-5 (relative, and 1e-5 of the largest entry).
  * the port's own exactness in float64: the node-mode symplectic gradient
    equals DirectBackprop through the same solve to 1e-9 (phase 4's rule),
    node mode (euler, n_steps = R) equals the discrete stack to 1e-8.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import repro.kernels.ref as jref
import repro.train.losses as jlosses
from repro.configs import qwen3_0_6b as jqwen
from repro.configs.base import NodeConfig as JNodeConfig
from repro.models import lm as jlm
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import qwen3_0_6b as tqwen
from repro_torch.configs.base import NodeConfig
from repro_torch.data.tokens import TokenPipeline, synthetic_lm_batch
from repro_torch.float64 import Float64Torch
from repro_torch.kernels import ref as tref
from repro_torch.models import lm as tlm
from repro_torch.train import (IGNORE, TrainConfig, init_train_state,
                               lm_loss, lm_loss_chunked, loss_and_grads,
                               make_decode_step, make_prefill_step,
                               make_train_step, node_solver_counts,
                               train_state_from_jax)
from repro_torch.train import losses as tlosses

F64 = 1e-12
F32 = 2e-5
STEP_RTOL = 1e-5


def _lift(module, monkeypatch):
    """Run ``module``'s jnp code with its float32 casts taken to float64."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.float32 = jnp.float64
    monkeypatch.setattr(module, "jnp", proxy)


def _rel(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"max |diff| / max |want| = {err:.3e} > {tol}"


def _np(t):
    return t.detach().to(torch.float64).numpy() \
        if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)


def _labels(rng, B, S, V):
    labels = rng.integers(0, V, size=(B, S))
    labels[0, :3] = IGNORE
    labels[-1, -2:] = IGNORE
    return labels


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lm_loss_matches_jax(dtype, monkeypatch):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 11)).astype(dtype)
    labels = _labels(rng, 3, 7, 11)
    if dtype == "float64":
        _lift(jlosses, monkeypatch)
    want = jlosses.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = lm_loss(torch.tensor(logits), torch.tensor(labels))
    _rel(_np(got), want, F64 if dtype == "float64" else F32)


@pytest.mark.parametrize("S, chunk", [(12, 4), (13, 4), (5, 512)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lm_loss_chunked_matches_jax(dtype, S, chunk, monkeypatch):
    """Value and gradient (hidden, head) against JAX's scanned, padded,
    checkpointed chunks; S not a multiple of the chunk takes the padding
    path."""
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(2, S, 6)).astype(dtype)
    head = rng.normal(size=(6, 9)).astype(dtype)
    labels = _labels(rng, 2, S, 9)
    if dtype == "float64":
        _lift(jlosses, monkeypatch)
    jl = jnp.asarray(labels)
    want, (jgh, jgw) = jax.value_and_grad(
        lambda h, w: jlosses.lm_loss_chunked(h, w, jl, chunk),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(head))
    th = torch.tensor(hidden, requires_grad=True)
    tw = torch.tensor(head, requires_grad=True)
    got = lm_loss_chunked(th, tw, torch.tensor(labels), chunk)
    gh, gw = torch.autograd.grad(got, (th, tw))
    tol = F64 if dtype == "float64" else F32
    _rel(_np(got), want, tol)
    _rel(_np(gh), jgh, tol)
    _rel(_np(gw), jgw, tol)
    # and the chunked loss is the full-logits loss
    full = lm_loss(torch.tensor(hidden) @ torch.tensor(head),
                   torch.tensor(labels))
    _rel(_np(got), _np(full), tol)


def test_lm_loss_chunked_never_makes_the_full_logits(monkeypatch):
    """Each chunk's (B, chunk, V) block is the largest logits tensor."""
    shapes = []
    orig = tlosses._chunk_nll

    def spy(xi, head, li):
        shapes.append(tuple(xi.shape[:2]) + (head.shape[1],))
        return orig(xi, head, li)

    monkeypatch.setattr(tlosses, "_chunk_nll", spy)
    h = torch.randn(2, 10, 4, requires_grad=True)
    loss = lm_loss_chunked(h, torch.randn(4, 7), torch.zeros(2, 10,
                                                            dtype=torch.long),
                           chunk=4)
    loss.backward()
    # forward 3 chunks, then each recomputed once in the backward (last
    # chunk first)
    assert shapes == [(2, 4, 7), (2, 4, 7), (2, 2, 7),
                      (2, 2, 7), (2, 4, 7), (2, 4, 7)]


# ---------------------------------------------------------------------------
# the plain backward versions
# ---------------------------------------------------------------------------

RMS_CASES = [(5, 16, False), (7, 32, True), (2, 3, 1000, True)]
# (B, H, Hkv, Sq, Sk, D, causal, window, q_offset): causal, GQA, window,
# query offset, non-causal, Sq != Sk
ATTN_BWD_CASES = [
    (1, 4, 4, 9, 9, 16, True, None, 0),
    (2, 4, 2, 12, 12, 16, True, None, 0),
    (1, 4, 1, 10, 10, 32, True, 4, 0),
    (1, 2, 2, 5, 17, 16, True, None, 12),
    (2, 4, 2, 6, 11, 16, False, None, 0),
    (1, 6, 2, 8, 20, 16, True, 5, 9),
]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", range(3))
def test_rms_norm_bwd_ref_matches_jax_grad(case, dtype, monkeypatch):
    shape = {0: (5, 16), 1: (7, 32), 2: (2, 3, 1000)}[case]
    with_res = case != 0
    rng = np.random.default_rng(case)
    x, r, dy = (rng.normal(size=shape).astype(dtype) for _ in range(3))
    w = rng.normal(size=shape[-1:]).astype(dtype)
    if dtype == "float64":
        _lift(jref, monkeypatch)
    args = (jnp.asarray(x), jnp.asarray(w)) + \
        ((jnp.asarray(r),) if with_res else ())
    _, vjp = jax.vjp(lambda *a: jref.rms_norm_ref(*a), *args)
    want = vjp(jnp.asarray(dy))
    dx, dw, dres = tref.rms_norm_bwd_ref(
        torch.tensor(x), torch.tensor(w),
        torch.tensor(r) if with_res else None, torch.tensor(dy))
    tol = F64 if dtype == "float64" else F32
    _rel(_np(dx), want[0], tol)
    _rel(_np(dw), want[1], tol)
    if with_res:
        _rel(_np(dres), want[2], tol)
    else:
        assert dres is None


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ATTN_BWD_CASES)
def test_attention_bwd_ref_matches_jax_grad(case, dtype, monkeypatch):
    """The flash recurrence from (o, lse) against ``jax.vjp`` of JAX's
    materialized attention; lse itself against a log-sum-exp of JAX's
    scores."""
    B, H, Hkv, Sq, Sk, D, causal, window, q_offset = case
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, H, Sq, D)).astype(dtype)
    k, v = (rng.normal(size=(B, Hkv, Sk, D)).astype(dtype) for _ in range(2))
    do = rng.normal(size=(B, H, Sq, D)).astype(dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if dtype == "float64":
        _lift(jref, monkeypatch)
    o, vjp = jax.vjp(lambda a, b, c: jref.attention_ref(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    lse = tref.attention_lse_ref(tq, tk, **kw)
    got = tref.attention_bwd_ref(tq, tk, tv, torch.tensor(np.asarray(o)),
                                 lse, torch.tensor(do), **kw)
    tol = F64 if dtype == "float64" else F32
    for g, w_ in zip(got, want):
        _rel(_np(g), w_, tol)
    # lse: the row's log-sum-exp of JAX's scaled, masked scores
    group = H // Hkv
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  np.repeat(k, group, axis=1).astype(np.float64)) * D ** -0.5
    qpos = np.arange(Sq)[:, None] + q_offset
    kpos = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    _rel(_np(lse), want_lse, tol)


# ---------------------------------------------------------------------------
# node mode: unit selection
# ---------------------------------------------------------------------------

def _jax_units(R, dtype):
    """The JAX package's unit sequence for euler, n_steps = R: its stepper's
    t_n = t0 + n h (core/stepper.py) and its field's floor(t R)
    (models/lm.py), eager jnp ops in ``dtype``."""
    t0 = jnp.asarray(0.0, dtype)
    h = (jnp.asarray(1.0, dtype) - t0) / R
    return [int(jnp.clip(jnp.floor((t0 + jnp.asarray(n, dtype) * h) * R)
                         .astype(jnp.int32), 0, R - 1)) for n in range(R)]


# depths R = 2..64 at which the JAX package's floor(t R) repeats a unit and
# skips the next one (a reference fault the port does not copy; ROADMAP
# queue 3)
JAX_UNIT_FAULTS = {
    "float32": [25, 29, 31, 41, 43, 47, 49, 50, 54, 55, 58, 59, 61, 62],
    "float64": [7, 9, 12, 14, 17, 18, 19, 21, 23, 24, 27, 28, 29, 31, 34,
                35, 36, 38, 39, 42, 43, 46, 47, 48, 49, 50, 51, 53, 54, 55,
                56, 57, 58, 60, 62, 63],
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_unit_sequence_is_every_unit_once(dtype):
    """Euler with n_steps = R runs units 0..R-1 in order for every R <= 64
    in both time dtypes; the JAX package's sequence differs exactly at the
    listed depths (qwen3-0.6b's R = 28 in float64 among them)."""
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    faults = []
    for R in range(2, 65):
        cfg = tqwen.SMOKE.with_(n_layers=R, node=NodeConfig(mode="node"))
        assert tlm.node_depth_units(cfg, tdt) == list(range(R)), R
        if _jax_units(R, jdt) != list(range(R)):
            faults.append(R)
    assert faults == JAX_UNIT_FAULTS[dtype]
    if dtype == "float64":
        assert _jax_units(28, jdt) == [0, 1, 2, 3, 4, 4, 6, 7, 8, 9, 9, 11,
                                       12, 12, 14, 15, 16, 17, 18, 18, 19,
                                       21, 22, 23, 24, 25, 25, 26]


@pytest.mark.parametrize("method, want", [
    ("rk4", [0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 2]),
    ("midpoint", [0, 0, 1, 1, 2, 2])])
def test_unit_of_a_stage_is_floor_of_n_plus_c(method, want):
    """A stage at t_n + c_i h runs unit floor(n + c_i), clipped to R - 1."""
    cfg = tqwen.SMOKE.with_(n_layers=3, node=NodeConfig(mode="node",
                                                         method=method))
    for dtype in (torch.float32, torch.float64):
        assert tlm.node_depth_units(cfg, dtype) == want


# ---------------------------------------------------------------------------
# node mode and the train step
# ---------------------------------------------------------------------------

def _state_pair(arch_j, arch_t, seed=0):
    """JAX's float64 train state and the port's copy of it."""
    jstate = j_init_train_state(jax.random.PRNGKey(seed), arch_j,
                                JTrainConfig(param_dtype="float64"))
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    return jstate, train_state_from_jax(np_state, arch_t, device="cpu")


def _batch(step, B=2, S=16, V=None):
    b = synthetic_lm_batch(step, B, S + 1, V or tqwen.SMOKE.vocab)
    return b, {k: torch.as_tensor(v, dtype=torch.long) for k, v in b.items()}


def _close_leaves(got, want, rtol):
    from torch.utils import _pytree as pytree
    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _np(a), _np(b)
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * float(np.abs(b).max()))


@pytest.mark.parametrize("mode", ["discrete", "node_symplectic"])
def test_train_step_matches_jax(mode):
    """One train step from JAX's state (float64 params): loss, grad_norm,
    the updated params and the AdamW state."""
    arch_j, arch_t = jqwen.SMOKE, tqwen.SMOKE
    if mode == "node_symplectic":
        arch_j = arch_j.with_(node=JNodeConfig(mode="node",
                                               grad_mode="symplectic"))
        arch_t = arch_t.with_(node=NodeConfig(mode="node",
                                              grad_mode="symplectic"))
    jstate, tstate = _state_pair(arch_j, arch_t)
    nb, tb = _batch(0)
    # AdamW's first step is g / (|g| + eps): with the default eps 1e-8 an
    # entry whose gradient is near 0 moves by up to lr times a rounding-
    # level difference over eps; eps 1e-3 (both packages) keeps the update
    # a smooth function of the gradient at float32 rounding
    jcfg = JTrainConfig(param_dtype="float64",
                        adamw=dataclasses.replace(JTrainConfig().adamw,
                                                  eps=1e-3))
    tcfg = TrainConfig(param_dtype="float64",
                       adamw=dataclasses.replace(TrainConfig().adamw,
                                                 eps=1e-3))
    js, jm = jax.jit(j_make_train_step(arch_j, jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in nb.items()})
    ts, tm = make_train_step(arch_t, tcfg)(tstate, tb)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=STEP_RTOL)
    np_js = jax.tree_util.tree_map(np.asarray, js)
    want = train_state_from_jax(np_js, arch_t, device="cpu")
    _close_leaves(ts.params, want.params, STEP_RTOL)
    for k in ("m", "v", "master"):
        _close_leaves(ts.opt[k], want.opt[k], STEP_RTOL)
    assert int(ts.opt["step"]) == int(js.opt["step"]) == 1
    assert {k: int(v) for k, v in ts.solver_stats.items()} == \
        {k: int(v) for k, v in js.solver_stats.items()}


def test_microbatches_2_match_1():
    """Two microbatches of 2 against one batch of 4 (float64 params): the
    float32 casts inside RMSNorm and attention turn the float64 rounding
    of differently shaped products into float32 rounding flips, so loss
    and grad_norm agree to 1e-6, not to float64."""
    arch = tqwen.SMOKE
    state = init_train_state(arch, TrainConfig(param_dtype="float64"),
                             device="cpu")
    _, batch = _batch(0, B=4)
    s1, m1 = make_train_step(arch, TrainConfig(param_dtype="float64"))(
        state, batch)
    s2, m2 = make_train_step(arch, TrainConfig(param_dtype="float64",
                                               microbatches=2))(state, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-6)
    _close_leaves(s2.params, s1.params, 1e-6)


def test_train_step_advances_every_contract_field():
    arch = tqwen.SMOKE.with_(node=NodeConfig(mode="node", method="euler",
                                             grad_mode="symplectic"))
    tcfg = TrainConfig()
    state = init_train_state(arch, tcfg, device="cpu")
    assert int(state.data_step) == 0
    assert int(state.solver_stats["n_steps"]) == 0
    step_fn = make_train_step(arch, tcfg)
    s1, m1 = step_fn(state, _batch(0)[1])
    s2, m2 = step_fn(s1, _batch(1)[1])
    assert int(s1.data_step) == 1 and int(s2.data_step) == 2
    assert int(s2.opt["step"]) == 2
    assert not torch.equal(state.rng, s1.rng)
    assert not torch.equal(s1.rng, s2.rng)
    n_steps, n_fevals = node_solver_counts(arch)
    assert n_steps == arch.n_repeats and n_fevals == n_steps
    assert int(s2.solver_stats["n_steps"]) == 2 * n_steps
    assert int(s2.solver_stats["n_fevals"]) == 2 * n_fevals
    assert float(m2["loss"]) != float(m1["loss"])
    # the state is a mapping too, as in the JAX package
    assert "compress_err" not in s2 and s2["data_step"] is s2.data_step


def _lm_loss(params, arch, batch):
    return loss_and_grads(params, batch, arch, loss_chunk=8)


def test_node_symplectic_gradient_equals_backprop_float64(monkeypatch):
    """The paper's claim on the LM: the symplectic adjoint over depth gives
    autograd's gradient through the same solve (phase 4's rule, 1e-9 of
    the largest entry per leaf), and node mode with euler on R steps is
    the discrete stack (1e-8).  The plain versions' float32 casts are
    lifted to float64 (``Float64Torch``): their autograd would otherwise
    round each cotangent to float32, and the two strategies hand the field
    cotangents that differ by the factor h (the symplectic adjoint scales
    after the VJP), so those roundings differ."""
    from torch.utils import _pytree as pytree
    monkeypatch.setattr(tref, "torch", Float64Torch())
    base = tqwen.SMOKE.with_(n_layers=3)
    params = tlm.init_lm(base, seed=3, device="cpu", dtype=torch.float64)
    _, batch = _batch(2, B=2, S=12)
    grads = {}
    for name, arch in (
            ("symplectic", base.with_(node=NodeConfig(
                mode="node", grad_mode="symplectic"))),
            ("backprop", base.with_(node=NodeConfig(
                mode="node", grad_mode="backprop"))),
            ("discrete", base)):
        grads[name] = _lm_loss(params, arch, batch)
    for other, rtol in (("backprop", 1e-9), ("discrete", 1e-8)):
        np.testing.assert_allclose(float(grads["symplectic"][0]),
                                   float(grads[other][0]), rtol=rtol)
        for a, b in zip(pytree.tree_leaves(grads["symplectic"][1]),
                        pytree.tree_leaves(grads[other][1])):
            _rel(_np(a), _np(b), rtol)


def test_node_symplectic_makes_no_zero_cotangents_for_units(monkeypatch):
    """Node mode runs one unit per field evaluation.  Algorithm 2 carries
    the other units' parameter cotangents as None (no zero tensor per stage
    for each untouched leaf), and since every unit runs once in the
    euler solve, no zero is made for a unit leaf at the end either."""
    from torch.utils import _pytree as pytree
    base = tqwen.SMOKE.with_(n_layers=3)
    params = tlm.init_lm(base, seed=3, device="cpu", dtype=torch.float64)
    _, batch = _batch(2, B=2, S=12)
    arch = base.with_(node=NodeConfig(mode="node", grad_mode="symplectic"))
    unit_ptrs = {l.data_ptr() for l in pytree.tree_leaves(params["unit"])}
    calls = []
    zeros_like = torch.zeros_like

    def counting(t, *args, **kwargs):
        calls.append(t.data_ptr() in unit_ptrs)
        return zeros_like(t, *args, **kwargs)

    monkeypatch.setattr(torch, "zeros_like", counting)
    loss, grads = _lm_loss(params, arch, batch)
    monkeypatch.setattr(torch, "zeros_like", zeros_like)
    assert sum(calls) == 0, f"{sum(calls)} zeros_like of unit leaves"
    assert all(float(g.abs().max()) > 0
               for g in pytree.tree_leaves(grads["unit"]))
    assert np.isfinite(float(loss))


def test_remat_gives_the_gradient_of_the_plain_stack():
    arch = tqwen.SMOKE
    params = tlm.init_lm(arch, seed=1, device="cpu", dtype=torch.float64)
    _, batch = _batch(0)
    a = _lm_loss(params, arch, batch)
    b = _lm_loss(params, arch.with_(remat=False), batch)
    from torch.utils import _pytree as pytree
    assert float(a[0]) == float(b[0])
    for x, y in zip(pytree.tree_leaves(a[1]), pytree.tree_leaves(b[1])):
        _rel(_np(x), _np(y), 1e-12)


def test_node_config_serves_with_the_discrete_stack():
    """The fault the slice repairs first: a node config prefills and
    decodes through the discrete stack (as the JAX package does), so a
    node-trained checkpoint serves."""
    arch = tqwen.SMOKE
    node = arch.with_(node=NodeConfig(mode="node", grad_mode="symplectic"))
    params = tlm.init_lm(arch, seed=0, device="cpu")
    toks = torch.as_tensor(synthetic_lm_batch(0, 2, 9, arch.vocab)["tokens"],
                           dtype=torch.long)
    outs = []
    for a in (arch, node):
        logits, caches = make_prefill_step(a, 2, 12)(params, {"tokens": toks})
        step, _ = make_decode_step(a)(params, caches, toks[:, :1], 8)
        outs.append((logits, step))
    for x, y in zip(*outs):
        assert torch.equal(x, y)


def test_node_depth_states_match_jax():
    """SaveAt(ts) over depth: the hidden states at depths 1/2 and 1 of the
    smoke stack (float32 inside in both packages: 1e-5)."""
    jparams = jax.jit(jlm.init_lm, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jqwen.SMOKE, jnp.float64)
    tparams = tlm.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  tqwen.SMOKE, device="cpu")
    toks = synthetic_lm_batch(0, 2, 9, tqwen.SMOKE.vocab)["tokens"]
    x = np.asarray(jparams["embed"])[toks]
    jarch = jqwen.SMOKE.with_(node=JNodeConfig(mode="node"))
    tarch = tqwen.SMOKE.with_(node=NodeConfig(mode="node"))
    want = jlm.node_depth_states(jparams, jarch, jnp.asarray(x),
                                 jnp.asarray([0.5, 1.0]))
    got = tlm.node_depth_states(tparams, tarch, torch.tensor(x), [0.5, 1.0])
    assert tuple(got.shape) == (2,) + x.shape
    _rel(_np(got), want, STEP_RTOL)


def test_unported_training_paths_name_their_items():
    arch = tqwen.SMOKE
    # data parallelism is ported (tests/test_torch_elastic.py), and so is a
    # training step on a "model" axis for every arch (item 17:
    # tests/test_torch_tensor_parallel.py, test_torch_tensor_parallel_zoo.py,
    # test_torch_tensor_parallel_rec.py); a "model" size that does not
    # divide a dim a layer splits raises, naming the dim
    from repro_torch.configs import get_smoke_arch
    from repro_torch.parallel import make_sharder
    from repro_torch.train.data_parallel import check_mesh

    def mesh(model):
        return type("Mesh", (), {"shape": {"data": 2, "model": model},
                                 "axis_names": ("data", "model")})
    jamba = get_smoke_arch("jamba-v0.1-52b")
    check_mesh(mesh(2), jamba)
    with pytest.raises(NotImplementedError, match="kv heads"):
        make_train_step(jamba, TrainConfig(), shard=make_sharder(mesh(4)))
    # the enc-dec model trains (tests/test_torch_zoo_rec_node.py): its
    # state holds the encoder and decoder stacks
    ed = get_smoke_arch("seamless-m4t-medium")
    assert callable(make_train_step(ed, TrainConfig()))
    assert {"enc_unit", "dec_unit", "frontend"} <= set(init_train_state(
        ed, TrainConfig(), device="cpu").params)
    # the patch frontend trains (tests/test_torch_zoo_train.py); the audio
    # frontend belongs to the enc-dec model, not to the decoder-only LM
    assert "frontend" in init_train_state(
        arch.with_(frontend="patch", d_frontend=8), TrainConfig(),
        device="cpu").params
    with pytest.raises(ValueError, match="models.encdec"):
        init_train_state(arch.with_(frontend="audio"), TrainConfig(),
                         device="cpu")
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="no H100 counterpart"):
        train.main(["--arch", "qwen3-0.6b", "--smoke", "--mesh", "pod",
                    "--device", "cpu"])


def test_token_pipeline_is_keyed_by_step():
    pipe = iter(TokenPipeline(4, 8, 50, start_step=3))
    a = next(pipe)
    b = synthetic_lm_batch(3, 4, 9, 50)
    assert a["tokens"].dtype == torch.long and a["tokens"].device.type == "cpu"
    assert np.array_equal(a["tokens"].numpy(), b["tokens"])
    assert np.array_equal(a["labels"].numpy(), b["labels"])
    half = iter(TokenPipeline(4, 8, 50, start_step=3, host_id=1, n_hosts=2))
    assert np.array_equal(next(half)["tokens"].numpy(),
                          synthetic_lm_batch(7, 2, 9, 50)["tokens"])
