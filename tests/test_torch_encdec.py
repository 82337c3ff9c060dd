"""PyTorch port: the enc-dec model (``repro_torch.models.encdec``) against
the JAX package's ``repro.models.encdec``, route by route, on the CPU from
JAX's smoke-width weights of seamless-m4t-medium.

``_mha``'s routes: training self-attention (causal, rotated; non-causal,
the encoder's, not rotated), cached self-attention (prefill into the cache,
then a decode step at a position), cross-attention against the memory
(training), against the precomputed K/V in the cache (prefill, the cache's
rounding) and one decode step against that cache (every memory position).
Then ``encode``, ``precompute_cross_kv``, ``decode_forward`` in each mode,
and the JAX package's decode-step fault (see ``torch_zoo_rec``).

Tolerances, relative to the largest entry: float64 with both packages'
float32 casts lifted 1e-12; float32 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo
from repro.models import encdec as jed
from repro.train import serve_step as jss
from repro_torch.configs import get_smoke_arch
from repro_torch.models import encdec as ted
from repro_torch.train import serve_step as tss

ARCH = "seamless-m4t-medium"
B, S, SE = 2, 6, 10          # batch, target length, source length
TOL = {"float64": 1e-12, "float32": 1e-5}
single_thread = pytest.fixture(autouse=True)(torch_zoo.one_thread)


def _setup(dtype, monkeypatch):
    jarch, tarch = torch_zoo.j_smoke(ARCH), get_smoke_arch(ARCH)
    p = jax.jit(jed.init_encdec, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, getattr(jnp, dtype))
    if dtype == "float64":
        p = torch_zoo.upcast(p)
    tp = ted.params_from_jax(jax.tree_util.tree_map(np.asarray, p), tarch,
                             device="cpu")
    if dtype == "float64":
        torch_zoo.lift(monkeypatch)
    rng = np.random.default_rng(0)
    d = jarch.d_model
    data = {"x": rng.normal(size=(B, S, d)).astype(dtype),
            "mem": rng.normal(size=(B, SE, d)).astype(dtype),
            "x1": rng.normal(size=(B, 1, d)).astype(dtype),
            "frames": rng.normal(size=(B, SE, jarch.d_frontend))
            .astype(dtype),
            "tokens": rng.integers(0, jarch.vocab, size=(B, S)),
            "token1": rng.integers(0, jarch.vocab, size=(B, 1))}
    return jarch, tarch, p, tp, data


def _layer(tree, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.tensor(a)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("causal", [True, False])
def test_training_self_attention(causal, dtype, monkeypatch):
    jarch, tarch, p, tp, d = _setup(dtype, monkeypatch)
    jl = _layer(p["dec_unit"])["self_attn"]
    tl = tp["dec_unit"][0]["self_attn"]
    yj, _ = jed._mha(jl, _j(d["x"]), jarch, causal=causal)
    yt, _ = ted._mha(tl, _t(d["x"]), tarch, causal=causal)
    torch_zoo.rel(yt, yj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cached_self_attention_prefill_and_decode(dtype, monkeypatch):
    """Prefill writes positions [0, S) of the cache (rotated k), a decode
    step writes position S and attends to [0, S]."""
    jarch, tarch, p, tp, d = _setup(dtype, monkeypatch)
    jl = _layer(p["dec_unit"])["self_attn"]
    tl = tp["dec_unit"][0]["self_attn"]
    H, Dh = jarch.n_heads, jarch.head_dim
    jc = {k: jnp.zeros((B, S + 2, H, Dh), getattr(jnp, dtype))
          for k in "kv"}
    tc = {k: torch.zeros((B, S + 2, H, Dh), dtype=getattr(torch, dtype))
          for k in "kv"}
    yj, jc = jed._mha(jl, _j(d["x"]), jarch, causal=True, cache=jc)
    yt, tc = ted._mha(tl, _t(d["x"]), tarch, causal=True, cache=tc)
    torch_zoo.rel(yt, yj, TOL[dtype])
    for k in "kv":
        torch_zoo.rel(tc[k], jc[k], TOL[dtype])
    yj, jc = jed._mha(jl, _j(d["x1"]), jarch, causal=True, cache=jc,
                      pos=jnp.int32(S))
    yt, tc = ted._mha(tl, _t(d["x1"]), tarch, causal=True, cache=tc, pos=S)
    torch_zoo.rel(yt, yj, TOL[dtype])
    for k in "kv":
        torch_zoo.rel(tc[k], jc[k], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cross_attention_routes(dtype, monkeypatch):
    """Against the memory (training); against the precomputed K/V (prefill,
    S > 1, the K/V rounded to a bfloat16 cache and cast back); one decode
    step against that cache (every memory position)."""
    jarch, tarch, p, tp, d = _setup(dtype, monkeypatch)
    jl = _layer(p["dec_unit"])["cross_attn"]
    tl = tp["dec_unit"][0]["cross_attn"]
    yj, _ = jed._mha(jl, _j(d["x"]), jarch, kv=_j(d["mem"]), causal=False)
    yt, _ = ted._mha(tl, _t(d["x"]), tarch, kv=_t(d["mem"]), cross=True,
                     causal=False)
    torch_zoo.rel(yt, yj, TOL[dtype])
    H, Dh = jarch.n_heads, jarch.head_dim
    kv = {k: (d["mem"] @ np.asarray(jl[f"w{k}"])).reshape(B, SE, H, Dh)
          for k in "kv"}
    jc = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in kv.items()}
    tc = {k: torch.tensor(v).to(torch.bfloat16) for k, v in kv.items()}
    for x in ("x", "x1"):
        yj, _ = jed._mha(jl, _j(d[x]), jarch, kv=_j(d["mem"]), causal=False,
                         cache=jc)
        yt, _ = ted._mha(tl, _t(d[x]), tarch, kv=_t(d["mem"]), cross=True,
                         causal=False, cache=tc)
        torch_zoo.rel(yt, yj, TOL[dtype])
        # the decode route needs no memory in the port
        yt, _ = ted._mha(tl, _t(d[x]), tarch, cross=True, causal=False,
                         cache=tc)
        torch_zoo.rel(yt, yj, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_encode_and_cross_kv(dtype, monkeypatch):
    jarch, tarch, p, tp, d = _setup(dtype, monkeypatch)
    mj = jed.encode(p, _j(d["frames"]), jarch)
    mt = ted.encode(tp, _t(d["frames"]), tarch)
    torch_zoo.rel(mt, mj, TOL[dtype])
    kj = jed.precompute_cross_kv(p, mj, jarch)
    kt = ted.precompute_cross_kv(tp, mt, tarch)
    for k in "kv":
        assert tuple(kt[k].shape) == (jarch.n_layers, B, SE, jarch.n_heads,
                                      jarch.head_dim)
        torch_zoo.rel(kt[k], kj[k], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_decode_forward_modes(dtype, monkeypatch):
    """train (every position's logits, and the hidden states the chunked
    loss takes), then the serving steps: prefill (last position's logits,
    the caches) and two decode steps, JAX decoding through its memory
    route."""
    jarch, tarch, p, tp, d = _setup(dtype, monkeypatch)
    mj = jed.encode(p, _j(d["frames"]), jarch)
    mt = ted.encode(tp, _t(d["frames"]), tarch)
    oj = jed.decode_forward(p, jarch, _j(d["tokens"]), memory=mj)
    ot = ted.decode_forward(tp, tarch, _t(d["tokens"]), memory=mt)
    torch_zoo.rel(ot["logits"], oj["logits"], TOL[dtype])
    assert ot["caches"] is None and ot["aux"] == 0.0
    oj = jed.decode_forward(p, jarch, _j(d["tokens"]), memory=mj,
                            return_hidden=True)
    ot = ted.decode_forward(tp, tarch, _t(d["tokens"]), memory=mt,
                            return_hidden=True)
    torch_zoo.rel(ot["hidden"], oj["hidden"], TOL[dtype])
    cdt = getattr(jnp, dtype), getattr(torch, dtype)
    jl, jc = jss.make_prefill_step(jarch, B, S + 2, cache_dtype=cdt[0])(
        p, {"tokens": _j(d["tokens"]), "frames": _j(d["frames"])})
    tl, tc = tss.make_prefill_step(tarch, B, S + 2, cache_dtype=cdt[1])(
        tp, {"tokens": _t(d["tokens"]), "frames": _t(d["frames"])})
    torch_zoo.rel(tl, jl, TOL[dtype])
    for part in ("self", "cross"):
        for k in "kv":
            torch_zoo.rel(tc[part][k], jc[part][k], TOL[dtype])
    for i in range(2):
        oj = jed.decode_forward(p, jarch, _j(d["token1"]), memory=mj,
                                caches=jc, pos=jnp.int32(S + i),
                                mode="decode")
        jc = oj["caches"]
        tl, tc = tss.make_decode_step(tarch)(tp, tc, _t(d["token1"]), S + i)
        torch_zoo.rel(tl, oj["logits"], TOL[dtype])
        torch_zoo.rel(tc["self"]["k"], jc["self"]["k"], TOL[dtype])


def test_jax_encdec_decode_step_fault(monkeypatch):
    """A fault of the reference, not copied: JAX's ``make_decode_step``
    calls ``decode_forward`` without the memory, so each decoder layer's
    cross-attention takes ``_mha``'s cached self-attention branch (the
    token projected by the cross weights, rotated, written over the cache's
    last memory position) instead of attending to the memory.  Its logits
    differ from the memory route's; the port's decode step is the memory
    route, and leaves the cross cache as the prefill wrote it."""
    jarch, tarch, p, tp, d = _setup("float64", monkeypatch)
    batch = {"tokens": _j(d["tokens"]), "frames": _j(d["frames"])}
    _, jc = jss.make_prefill_step(jarch, B, S + 2,
                                  cache_dtype=jnp.float64)(p, batch)
    faulty, _ = jss.make_decode_step(jarch)(p, jc, _j(d["token1"]),
                                            jnp.int32(S))
    mj = jed.encode(p, batch["frames"], jarch)
    right = jed.decode_forward(p, jarch, _j(d["token1"]), memory=mj,
                               caches=jc, pos=jnp.int32(S),
                               mode="decode")["logits"]
    gap = float(jnp.abs(faulty - right).max() / jnp.abs(right).max())
    assert gap > 1e-3
    _, tc = tss.make_prefill_step(tarch, B, S + 2, cache_dtype=torch.float64)(
        tp, {"tokens": _t(d["tokens"]), "frames": _t(d["frames"])})
    before = tc["cross"]["k"].clone()
    tl, tc = tss.make_decode_step(tarch)(tp, tc, _t(d["token1"]), S)
    torch_zoo.rel(tl, right, 1e-12)
    assert torch.equal(tc["cross"]["k"], before)


def test_init_and_caches_match_jax():
    jarch, tarch = torch_zoo.j_smoke(ARCH), get_smoke_arch(ARCH)
    jp = jax.eval_shape(lambda: jed.init_encdec(jax.random.PRNGKey(0),
                                                jarch))
    tp = ted.init_encdec(tarch, device="cpu")
    assert len(tp["enc_unit"]) == jarch.enc_layers
    assert len(tp["dec_unit"]) == jarch.n_layers
    def shapes(tree):
        return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)

    got = {k: jax.tree_util.tree_map(
        lambda *ls: (len(ls),) + tuple(ls[0].shape), *v)
        if k in ("enc_unit", "dec_unit") else shapes(v)
        for k, v in tp.items()}
    assert got == shapes(jp)
    jc = jed.init_encdec_caches(jarch, B, S, SE)
    tc = ted.init_encdec_caches(tarch, B, S, SE, device="cpu")
    assert jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), jc) == \
        jax.tree_util.tree_map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
            tc)
    meta = ted.init_encdec(get_smoke_arch(ARCH), device="meta")
    assert all(t.device.type == "meta"
               for t in jax.tree_util.tree_leaves(meta))
