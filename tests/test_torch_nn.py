"""PyTorch port: the LM layers (rope, SwiGLU, GQA attention with its KV
cache) against the JAX package, on the same weights (the JAX package's
initializers exported as numpy) and the same numpy inputs, on the CPU.

The JAX side runs with x64 on and float64 weights.  RoPE, RMSNorm and
attention compute in float32 inside in both packages (``repro/nn/rope.py``
and ``repro/kernels/ref.py`` cast explicitly), so the layers agree to
float32 rounding, not to float64: each test states its bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from repro.nn import attention as jattn
from repro.nn import mlp as jmlp
from repro.nn import rope as jrope
from repro_torch.nn import attention as tattn
from repro_torch.nn import common as tcommon
from repro_torch.nn import mlp as tmlp
from repro_torch.nn import rope as trope

# float32 internals, float64 outside: differences are float32 rounding of
# O(1) values carried through a few float64 products
RTOL, ATOL = 2e-5, 2e-6


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


@pytest.mark.parametrize("theta,rd", [(10000.0, None), (1e6, None),
                                      (10000.0, 8)])
def test_rope_freqs_match_jax(theta, rd):
    """Both compute 1 / theta**(arange/rd) in float32: equal to one ulp."""
    want = np.asarray(jrope.rope_freqs(32, theta, rd))
    got = trope.rope_freqs(32, theta, rd)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("rd,pos2d", [(None, False), (4, False),
                                      (None, True)])
def test_apply_rope_matches_jax(rd, pos2d, dtype):
    """Angles, cos/sin and the rotation are float32 in both packages (cos
    and sin of angles up to ~1e3 rad round to ~1e-7 of an O(1) result)."""
    rng = np.random.default_rng(1)
    B, H, S, D = 2, 3, 5, 16
    x = rng.normal(size=(B, H, S, D)).astype(dtype)
    positions = (rng.integers(0, 1000, size=(B, S)) if pos2d
                 else np.arange(S) + 7)
    inv_j = jrope.rope_freqs(D, 1e4, rd)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(positions), inv_j,
                            rd)
    got = trope.apply_rope(torch.tensor(x), torch.tensor(positions),
                           trope.rope_freqs(D, 1e4, rd), rd)
    assert got.dtype == torch.tensor(x).dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_swiglu_matches_jax():
    """Pure float64 on both sides: rounding-level agreement."""
    p = jmlp.init_swiglu(jax.random.PRNGKey(0), 8, 24, jnp.float64)
    x = np.random.default_rng(2).normal(size=(2, 5, 8))
    want = jmlp.swiglu(p, jnp.asarray(x))
    got = tmlp.swiglu(_t(p), torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-14)


ATTN_CFGS = {
    "qwen3": dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
                  qk_norm=True, rope_theta=1e6),
    "window_partial_rope": dict(d_model=32, n_heads=4, n_kv_heads=1,
                                head_dim=16, window=4, rotary_pct=0.25),
}


@pytest.mark.parametrize("name", sorted(ATTN_CFGS))
def test_gqa_prefill_then_decode_matches_jax(name):
    """Prefill S tokens into a bfloat16 cache, then decode two tokens at
    positions S and S+1: outputs and caches equal JAX's.  Cache entries are
    float32 results rounded to bfloat16; where the two packages' float32
    values straddle a rounding boundary they differ by one bfloat16 ulp."""
    kw = ATTN_CFGS[name]
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    p = jattn.init_gqa(jax.random.PRNGKey(3), jcfg, jnp.float64)
    tp = _t(p)
    B, S, Smax = 2, 6, 10
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S, kw["d_model"]))
    steps = rng.normal(size=(2, B, 1, kw["d_model"]))

    prefill = jax.jit(lambda p, x, c: jattn.gqa_attention(p, x, jcfg,
                                                          cache=c))
    decode = jax.jit(lambda p, x, c, pos: jattn.gqa_attention(
        p, x, jcfg, cache=c, pos=pos))
    jcache = jattn.init_gqa_cache(jcfg, B, Smax)
    want, jcache = prefill(p, jnp.asarray(x), jcache)
    tcache = tattn.init_gqa_cache(tcfg, B, Smax, device="cpu")
    got, tcache2 = tattn.gqa_attention(tp, torch.tensor(x), tcfg,
                                       cache=tcache)
    assert tcache2 is tcache        # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for i, xs in enumerate(steps):
        want, jcache = decode(p, jnp.asarray(xs), jcache,
                              jnp.int32(S + i))
        got, tcache = tattn.gqa_attention(tp, torch.tensor(xs), tcfg,
                                          cache=tcache, pos=S + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    eps = float(torch.finfo(torch.bfloat16).eps)
    for key in ("k", "v"):
        want_c = np.asarray(jcache[key].astype(jnp.float32))
        got_c = tcache[key].float().numpy()
        np.testing.assert_allclose(got_c, want_c, rtol=eps, atol=1e-6)
        assert np.all(got_c[:, S + 2:] == 0)


def test_gqa_train_mode_matches_jax():
    """No cache: the training/prefill forward alone."""
    kw = ATTN_CFGS["qwen3"]
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    p = jattn.init_gqa(jax.random.PRNGKey(5), jcfg, jnp.float64)
    x = np.random.default_rng(6).normal(size=(3, 7, kw["d_model"]))
    want, c = jax.jit(lambda p, x: jattn.gqa_attention(p, x, jcfg))(
        p, jnp.asarray(x))
    got, tc = tattn.gqa_attention(_t(p), torch.tensor(x), tcfg)
    assert c is None and tc is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_init_shapes_match_jax():
    def shapes(tree):
        return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)

    cfg = ATTN_CFGS["qwen3"]
    g = torch.Generator().manual_seed(0)
    assert shapes(tattn.init_gqa(g, tattn.AttnConfig(**cfg), device="cpu")) \
        == shapes(jattn.init_gqa(jax.random.PRNGKey(0),
                                 jattn.AttnConfig(**cfg)))
    assert shapes(tmlp.init_swiglu(g, 8, 24, device="cpu")) == \
        shapes(jmlp.init_swiglu(jax.random.PRNGKey(0), 8, 24))


def test_initializers_statistics():
    """dense_init: truncated N(0, 1/fan_in) inside two standard deviations;
    embed_init: N(0, 0.02^2).  1e5 draws: the sample std is within 2 % of
    its expected value."""
    g = torch.Generator().manual_seed(0)
    w = tcommon.dense_init((400, 250), torch.float32, g, device="cpu")
    std = 400 ** -0.5
    assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
    # the std of N(0,1) truncated to [-2, 2] is 0.8796
    assert abs(float(w.std()) / (0.8796 * std) - 1) < 0.02
    e = tcommon.embed_init((400, 250), torch.float64, g, device="cpu")
    assert e.dtype == torch.float64
    assert abs(float(e.std()) / 0.02 - 1) < 0.02
