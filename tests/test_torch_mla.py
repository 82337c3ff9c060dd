"""PyTorch port: DeepSeek-V2's latent attention (``nn.attention.mla_*``)
and the query-blocked plain attention (``kernels.ref.
attention_blocked_ref``, and its route in ``kernels.ops.attention``)
against the JAX package, on the CPU.

Tolerances, with their reasons:
  * float64 with the JAX package's float32 casts lifted to float64 on both
    sides (``_lift``, ``Float64Torch``: RMSNorm, RoPE's angles, the scores
    and the absorbed decode): 1e-12 of the largest entry, float64
    rounding.  The cache is float64 there, so no entry is rounded.
  * float32 as shipped, bfloat16 cache: 1e-5 of the largest entry for the
    prefill output (float32 rounding); decode attends over the bfloat16
    latent, whose entries round alike in both packages unless their
    float32 values straddle a bfloat16 boundary, so the decode outputs are
    held to 1e-3 of the largest entry (a flipped entry moves by 2^-8 of
    itself) and the cache entries to one bfloat16 ulp.
  * the blocked attention against JAX's, values and gradients (float64,
    lifted): 1e-12; against the port's own ``attention_ref``: 1e-12.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax.config.update("jax_enable_x64", True)

import repro.kernels.ref as jref
import repro.nn.attention as jattn
import repro.nn.rope as jrope
from repro_torch.float64 import Float64Torch
import repro_torch.kernels.ops as tops
import repro_torch.kernels.ref as tref
import repro_torch.nn.attention as tattn
import repro_torch.nn.rope as trope

F64 = 1e-12
F32 = 1e-5
BF16_EPS = float(torch.finfo(torch.bfloat16).eps)

# deepseek-v2-lite's smoke widths
MLA = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, mla=True,
           kv_lora=32, rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
B, S, GEN = 2, 12, 3


def _lift(module, monkeypatch):
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.float32 = jnp.float64
    monkeypatch.setattr(module, "jnp", proxy)


def _lift_all(monkeypatch):
    for m in (jref, jattn, jrope):
        _lift(m, monkeypatch)
    for m in (tref, tattn, trope):
        monkeypatch.setattr(m, "torch", Float64Torch())


def _rel(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-300)
    assert err <= tol, f"max |diff| / max |want| = {err:.3e} > {tol}"


def _mla_run(dtype, cache_dtype, monkeypatch):
    """Both packages: prefill S tokens into a cache, then GEN decode steps
    fed the same inputs.  Returns the outputs and caches as numpy."""
    jcfg = jattn.AttnConfig(**MLA)
    tcfg = tattn.AttnConfig(**MLA)
    jp = jattn.init_mla(jax.random.PRNGKey(0), jcfg, dtype)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), jp)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, MLA["d_model"])).astype(dtype)
    steps = rng.normal(size=(GEN, B, 1, MLA["d_model"])).astype(dtype)
    if dtype == np.float64:
        _lift_all(monkeypatch)
    jdt = {np.float64: jnp.float64, "bf16": jnp.bfloat16}[cache_dtype]
    tdt = {np.float64: torch.float64, "bf16": torch.bfloat16}[cache_dtype]
    jc = jattn.init_mla_cache(jcfg, B, S + GEN, jdt)
    tc = tattn.init_mla_cache(tcfg, B, S + GEN, tdt, device="cpu")
    out = {"j": [], "t": []}
    jo, jc = jattn.mla_attention(jp, jnp.asarray(x), jcfg, cache=jc)
    to, tc = tattn.mla_attention(tp, torch.tensor(x), tcfg, cache=tc)
    out["j"].append(np.asarray(jo))
    out["t"].append(to.numpy())
    for i in range(GEN):
        jo, jc = jattn.mla_attention(jp, jnp.asarray(steps[i]), jcfg,
                                     cache=jc, pos=jnp.int32(S + i))
        to, tc = tattn.mla_attention(tp, torch.tensor(steps[i]), tcfg,
                                     cache=tc, pos=S + i)
        out["j"].append(np.asarray(jo))
        out["t"].append(to.numpy())
    caches = {k: (np.asarray(jc[k].astype(jnp.float64)),
                  tc[k].to(torch.float64).numpy()) for k in ("ckv", "kr")}
    return out, caches


def test_mla_prefill_and_decode_float64_match_jax(monkeypatch):
    out, caches = _mla_run(np.float64, np.float64, monkeypatch)
    for j, t in zip(out["j"], out["t"]):
        _rel(t, j, F64)
    for k, (j, t) in caches.items():
        _rel(t, j, F64)


def test_mla_prefill_and_decode_float32_match_jax(monkeypatch):
    out, caches = _mla_run(np.float32, "bf16", monkeypatch)
    _rel(out["t"][0], out["j"][0], F32)
    for j, t in zip(out["j"][1:], out["t"][1:]):
        _rel(t, j, 1e-3)
    for k, (j, t) in caches.items():
        np.testing.assert_allclose(t, j, rtol=BF16_EPS, atol=1e-6)


def test_mla_cache_is_written_in_place():
    tcfg = tattn.AttnConfig(**MLA)
    g = torch.Generator().manual_seed(0)
    p = tattn.init_mla(g, tcfg, device="cpu")
    cache = tattn.init_mla_cache(tcfg, B, S + 1, device="cpu")
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    x = torch.randn((B, S, MLA["d_model"]), generator=g)
    _, c1 = tattn.mla_attention(p, x, tcfg, cache=cache)
    _, c2 = tattn.mla_attention(p, x[:, :1], tcfg, cache=c1, pos=S)
    assert c1 is cache and c2 is cache
    assert {k: v.data_ptr() for k, v in c2.items()} == ptrs
    assert bool((cache["ckv"][:, S] != 0).any())


# ---------------------------------------------------------------------------
# the query-blocked plain attention
# ---------------------------------------------------------------------------

BLOCKED_CASES = [
    # (B, H, Hkv, Sq, Sk, D, causal, window, q_offset, block_q)
    (1, 4, 2, 64, 64, 16, True, None, 0, 16),
    (2, 4, 4, 48, 80, 8, True, 24, 32, 16),
    (1, 6, 2, 32, 32, 16, False, None, 0, 8),
    (1, 2, 1, 40, 40, 8, True, None, 0, 16),      # Sq % block: the ref path
]


@pytest.mark.parametrize("case", BLOCKED_CASES)
def test_attention_blocked_matches_jax(case, monkeypatch):
    """Values and the gradients of sum(out * w) w.r.t. q, k, v."""
    Bq, H, Hkv, Sq, Sk, D, causal, window, q_offset, bq = case
    rng = np.random.default_rng(Sq + Sk)
    q = rng.normal(size=(Bq, H, Sq, D))
    k = rng.normal(size=(Bq, Hkv, Sk, D))
    v = rng.normal(size=(Bq, Hkv, Sk, D))
    w = rng.normal(size=(Bq, H, Sq, D))
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=bq)
    _lift(jref, monkeypatch)
    monkeypatch.setattr(tref, "torch", Float64Torch())

    def jloss(q, k, v):
        return jnp.sum(jref.attention_blocked_ref(q, k, v, **kw) * w)

    jout = jref.attention_blocked_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tout = tref.attention_blocked_ref(tq, tk, tv, **kw)
    (tout * torch.tensor(w)).sum().backward()
    _rel(tout.detach().numpy(), jout, F64)
    for t, j in zip((tq, tk, tv), jgrads):
        _rel(t.grad.numpy(), j, F64)
    plain = tref.attention_ref(tq, tk, tv, causal=causal, window=window,
                               q_offset=q_offset)
    _rel(tout.detach().numpy(), plain.detach().numpy(), F64)


class _ShapeLog(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("Sq, Sk, blocked", [
    (1024, 8193, True), (1024, 8192, False), (1023, 16384, False),
    (2048, 4097, True), (4096, 4096, True), (512, 65536, False)])
def test_plain_attention_routes_as_jax(Sq, Sk, blocked, monkeypatch):
    """ops.attention's plain path takes the blocked version exactly where
    the JAX package's ops.attention does (Sq >= 1024, Sq Sk > 2048 4096)."""
    seen = []
    monkeypatch.setattr(tref, "attention_blocked_ref",
                        lambda q, *a, **k: seen.append("blocked") or q)
    monkeypatch.setattr(tref, "attention_ref",
                        lambda q, *a, **k: seen.append("full") or q)
    q = torch.zeros((1, 1, Sq, 4))
    kv = torch.zeros((1, 1, Sk, 4))
    tops.attention(q, kv, kv, use_kernels=False)
    assert seen == ["blocked" if blocked else "full"]


def test_blocked_route_never_holds_the_whole_scores():
    """At a routed shape no op of the plain path returns a tensor with
    (Sq, Sk) trailing dims; the blocks are (512, Sk)."""
    Sq, Sk = 1024, 8448
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 1, Sq, 4), generator=g)
    kv = torch.randn((1, 1, Sk, 4), generator=g)
    with _ShapeLog() as log:
        out = tops.attention(q, kv, kv, causal=True, use_kernels=False)
    assert not any(s[-2:] == (Sq, Sk) for s in log.shapes if len(s) >= 2)
    assert any(s[-2:] == (512, Sk) for s in log.shapes if len(s) >= 2)
    want = tref.attention_ref(q, kv, kv, causal=True)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
