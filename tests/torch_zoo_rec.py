"""Shared set-up of the recurrent and enc-dec archs' whole-model parity
tests (``test_torch_zoo_rec*.py``): seamless-m4t-medium's serving pair,
the smoke-width training step of both packages from JAX's
``init_train_state``, and the leaf comparison of a step.

seamless-m4t-medium decodes on the JAX side through ``decode_forward(...,
memory=...)``: JAX's own ``make_decode_step`` passes no memory, and its
cross-attention then takes the cached self-attention branch (ROADMAP queue
3, "Faults in the reference"; ``test_torch_encdec.py`` shows it)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import NodeConfig as JNodeConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_arch
from repro_torch.configs.base import NodeConfig
from repro_torch.train import (TrainConfig, make_train_step,
                               train_state_from_jax)
from torch_zoo import (B, GEN, S, inputs, j_smoke, lift, serve_pair,
                       train_batch, upcast)

REC_ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b", "seamless-m4t-medium")
STEP_RTOL = 1e-5


def source_frames(arch, dtype):
    return np.random.default_rng(5).normal(
        size=(B, S, arch.d_frontend)).astype(dtype)


def encdec_pair(dtype, monkeypatch, cache=None):
    """seamless-m4t-medium: prefill + GEN decode steps in both packages from
    JAX's weights (``serve_pair``'s settings), JAX decoding
    through its memory route."""
    from repro.models import encdec as jed
    from repro.train import serve_step as jss
    from repro_torch.models import encdec as ted
    from repro_torch.train import serve_step as tss
    arch_id = "seamless-m4t-medium"
    jarch, tarch = j_smoke(arch_id), get_smoke_arch(arch_id)
    jdt = getattr(jnp, dtype)
    params = jax.jit(jed.init_encdec, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jdt)
    if dtype == "float64":
        params = upcast(params)
    tparams = ted.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         params),
                                  tarch, device="cpu")
    toks, feed, _ = inputs(jarch)
    src = source_frames(jarch, dtype)
    if dtype == "float64":
        lift(monkeypatch)
    cache = cache or dtype
    jc, tc = getattr(jnp, cache), getattr(torch, cache)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(src)}
    tb = {"tokens": torch.tensor(toks), "frames": torch.tensor(src)}
    jl, jcache = jax.jit(jss.make_prefill_step(jarch, B, S + GEN,
                                               cache_dtype=jc))(params, jb)
    tl, tcache = tss.make_prefill_step(tarch, B, S + GEN, cache_dtype=tc)(
        tparams, tb)
    pairs = [(np.asarray(jl), tl.numpy())]
    memory = jed.encode(params, jb["frames"], jarch)
    jdec = jax.jit(lambda p, c, t, pos: jed.decode_forward(
        p, jarch, t, memory=memory, caches=c, pos=pos, mode="decode"))
    tdec = tss.make_decode_step(tarch)
    for i in range(GEN):
        out = jdec(params, jcache, jnp.asarray(feed[i]), jnp.int32(S + i))
        jcache = out["caches"]
        tl, tcache = tdec(tparams, tcache, torch.tensor(feed[i]), S + i)
        pairs.append((np.asarray(out["logits"]), tl.numpy()))
    return pairs


def pairs(arch_id, dtype, monkeypatch, cache=None):
    if arch_id == "seamless-m4t-medium":
        return encdec_pair(dtype, monkeypatch, cache)
    return serve_pair(arch_id, dtype, monkeypatch, cache)


def close_leaves(got, want, old=None, m_want=None, adamw=None, lr=None):
    """Each leaf of ``got`` within STEP_RTOL of ``want``'s largest entry.
    A parameter that was zero before the step (``old``) is its first update
    alone, u = lr g / (|g| + eps) with |du/dg| <= lr / eps: it is held to
    what a gradient within STEP_RTOL of its largest entry (g = m / (1 -
    b1), from ``m_want``; m itself is held to STEP_RTOL) can move it by,
    STEP_RTOL lr max|g| / eps."""
    from torch.utils import _pytree as pytree
    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    o = pytree.tree_leaves(old) if old is not None else [None] * len(g)
    m = pytree.tree_leaves(m_want) if m_want is not None else [None] * len(g)
    assert len(g) == len(w) == len(o) == len(m)
    for a, b, c, mw in zip(g, w, o, m):
        a = a.detach().to(torch.float64).numpy()
        b = b.detach().to(torch.float64).numpy()
        scale = float(np.abs(b).max())
        if c is not None and not bool(c.abs().max()):
            gmax = float(mw.abs().max()) / (1 - adamw.b1)
            scale = lr * gmax / adamw.eps
        np.testing.assert_allclose(a, b, rtol=0, atol=STEP_RTOL * scale)


def step_pair(arch_id, node=False):
    jarch, tarch = j_smoke(arch_id), get_smoke_arch(arch_id)
    if node:
        jarch = jarch.with_(node=JNodeConfig(mode="node", method="euler",
                                             grad_mode="symplectic"))
        tarch = tarch.with_(node=NodeConfig(mode="node", method="euler",
                                            grad_mode="symplectic"))
    jcfg = JTrainConfig(param_dtype="float64",
                        adamw=dataclasses.replace(JTrainConfig().adamw,
                                                  eps=1e-3))
    tcfg = TrainConfig(param_dtype="float64",
                       adamw=dataclasses.replace(TrainConfig().adamw,
                                                 eps=1e-3))
    jstate = j_init_train_state(jax.random.PRNGKey(0), jarch, jcfg)
    tstate = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate),
                                  tarch, device="cpu")
    b = train_batch(jarch)
    if jarch.encdec:
        b["frames"] = source_frames(jarch, "float64")
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) if k == "frames"
          else torch.as_tensor(v, dtype=torch.long) for k, v in b.items()}
    js, jm = jax.jit(j_make_train_step(jarch, jcfg))(jstate, jb)
    ts, tm = make_train_step(tarch, tcfg)(tstate, tb)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=STEP_RTOL)
    want = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                                tarch, device="cpu")
    close_leaves(ts.params, want.params, tstate.params, want.opt["m"],
                  tcfg.adamw, tcfg.lr)
    # m = (1 - b1) g; v = (1 - b2) g^2, whose square root is |g| scaled
    close_leaves(ts.opt["m"], want.opt["m"])
    root = lambda t: jax.tree_util.tree_map(torch.sqrt, t)  # noqa: E731
    close_leaves(root(ts.opt["v"]), root(want.opt["v"]))
    return ts
