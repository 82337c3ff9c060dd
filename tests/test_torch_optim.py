"""PyTorch port: the optimizer modules (``repro_torch.optim``: AdamW with
and without float32 master copies, global-norm clipping, the three LR
schedules, bf16 and int8 gradient compression with error feedback) against
the JAX package's ``repro.optim`` on the same numpy trees, on the CPU.

Tolerance: both sides do the same float32 elementwise arithmetic; XLA and
PyTorch may round a ``pow``, ``cos`` or a summed norm differently by an
ulp, so values agree to rtol 1e-6 (atol 1e-6 of the largest entry);
bfloat16 params and grads to one bfloat16 ulp; an int8 quantum (the
scale) where a rounding tie in g / scale may fall either way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim.compress import init_error_state as j_init_error_state
from repro_torch import optim as topt

RTOL = 1e-6
BF16_EPS = float(torch.finfo(torch.bfloat16).eps)


def _trees(seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(8, 8)) * scale).astype(dtype),
            "b": (rng.normal(size=(8,)) * scale).astype(dtype),
            "unit": [{"k": (rng.normal(size=(4, 4)) * scale).astype(dtype)}
                     for _ in range(2)]}


def _to_jax(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype=dtype), tree)


def _to_torch(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda a: torch.tensor(np.asarray(a)).to(dtype) if dtype else
        torch.tensor(np.asarray(a)), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64).numpy() if x.is_floating_point() \
            else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float64) if jnp.issubdtype(a.dtype, jnp.floating) \
        else a


def _close_trees(got, want, rtol=RTOL, eps=None):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        tol = rtol if eps is None else eps
        np.testing.assert_allclose(a, b, rtol=tol,
                                   atol=tol * max(float(np.abs(b).max()),
                                                  1e-30))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(param_dtype):
    """Three AdamW steps on the same grads: params, m, v, step and (for
    bfloat16 params) the float32 master copies."""
    cfg = jopt.AdamWConfig()
    tcfg = topt.AdamWConfig()
    assert dataclasses_equal(cfg, tcfg)
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    p0 = _trees(0)
    jp, tp = _to_jax(p0, jdt), _to_torch(p0, tdt)
    js, ts = jopt.adamw_init(jp, cfg), topt.adamw_init(tp, tcfg)
    assert ("master" in js) == ("master" in ts) == (param_dtype ==
                                                     "bfloat16")
    for i in range(3):
        g = _trees(10 + i, scale=0.1)
        jp, js = jopt.adamw_update(jp, _to_jax(g, jdt), js, 1e-2, cfg)
        tp, ts = topt.adamw_update(tp, _to_torch(g, tdt), ts, 1e-2, tcfg)
    assert int(ts["step"]) == int(js["step"]) == 3
    eps = BF16_EPS if param_dtype == "bfloat16" else None
    _close_trees(tp, jp, eps=eps)
    for k in ("m", "v") + (("master",) if "master" in js else ()):
        _close_trees(ts[k], js[k])


def dataclasses_equal(a, b):
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_jax(max_norm):
    g = _trees(3)
    jg, jn = jopt.clip_by_global_norm(_to_jax(g), max_norm)
    tg, tn = topt.clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    _close_trees(tg, jg)
    if max_norm > float(jn):
        _close_trees(tg, _to_torch(g), rtol=0.0)   # untouched below the cap


@pytest.mark.parametrize("name", ["constant", "cosine", "wsd"])
def test_schedules_match_jax(name):
    make = {"constant": lambda m: m.constant_schedule(3e-4),
            "cosine": lambda m: m.cosine_schedule(3e-4, 5, 40),
            "wsd": lambda m: m.wsd_schedule(3e-4, 5, 20, 10)}[name]
    jf, tf = make(jopt), make(topt)
    for step in range(0, 45):
        want = float(jf(jnp.int32(step)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(float(tf(step)), want, rtol=RTOL,
                                   atol=1e-12)


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compression_with_error_feedback_matches_jax(mode):
    """Three compress -> decompress rounds, each feeding the error state of
    the last: the decompressed grads and the residual match JAX."""
    jcfg = jopt.CompressionConfig(mode=mode)
    tcfg = topt.CompressionConfig(mode=mode)
    p = _trees(0)
    je = j_init_error_state(_to_jax(p), jcfg)
    te = topt.init_error_state(_to_torch(p), tcfg)
    assert (je is None) == (te is None) == (mode == "bf16")
    for i in range(3):
        g = _trees(20 + i, scale=0.3)
        jc, je = jopt.compress_grads(_to_jax(g), jcfg, je)
        tc, te = topt.compress_grads(_to_torch(g), tcfg, te)
        jd = jopt.decompress_grads(jc, jcfg)
        td = topt.decompress_grads(tc, tcfg)
        if mode == "bf16":
            _close_trees(td, jd, eps=BF16_EPS)
            continue
        # one int8 quantum: a tie in round(g / scale) may fall either way
        for a, b, (q, scale) in zip(jax.tree_util.tree_leaves(td),
                                    jax.tree_util.tree_leaves(jd),
                                    _pairs(tc)):
            assert q.dtype == torch.int8
            np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                       atol=1.01 * float(scale))
        for a, b, (_, scale) in zip(jax.tree_util.tree_leaves(te),
                                    jax.tree_util.tree_leaves(je),
                                    _pairs(tc)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                       atol=1.01 * float(scale))


def _pairs(comp):
    from torch.utils import _pytree as pytree
    return pytree.tree_leaves(
        comp, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[0], torch.Tensor))


def test_int8_error_feedback_reduces_bias():
    """The residual carries what quantization dropped: the mean of the
    decompressed grads over many rounds approaches the true mean."""
    cfg = topt.CompressionConfig(mode="int8")
    # one large entry sets the tensor's scale (100 / 127): 0.3 alone rounds
    # to 0 without the residual
    g = {"w": torch.cat([torch.full((64,), 0.3), torch.tensor([100.0])])}
    err = topt.init_error_state(g, cfg)
    total = torch.zeros(65)
    n = 50
    for _ in range(n):
        comp, err = topt.compress_grads(g, cfg, err)
        total += topt.decompress_grads(comp, cfg)["w"]
    no_fb = topt.decompress_grads(
        topt.compress_grads(g, topt.CompressionConfig(
            mode="int8", error_feedback=False))[0], cfg)["w"]
    assert abs(float(total[:64].mean()) / n - 0.3) < 0.02
    assert float(no_fb[:64].abs().max()) == 0.0
