"""Shared set-up of the LM zoo's parity tests (``test_torch_zoo*.py``,
``test_torch_mamba.py``, ``test_torch_xlstm.py``, ``test_torch_encdec.py``):
the JAX package's smoke-width weights of one arch carried into the port by
``params_from_jax``, both packages' serving runs on the same inputs, and
the float32 casts of both packages lifted to float64 for the float64
comparisons (a float64 run also takes JAX's float32 leaves, the routers and
Mamba's A_log, D, dt_bias, to float64, as ``params_from_jax(...,
dtype=torch.float64)`` does for the port)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

jax.config.update("jax_enable_x64", True)

import repro.kernels.ref as jref
import repro.models.encdec as jencdec
import repro.models.lm as jlm
import repro.nn.attention as jattn
import repro.nn.mamba as jmamba
import repro.nn.moe as jmoe
import repro.nn.norm as jnorm
import repro.nn.rope as jrope
import repro.nn.xlstm as jxlstm
import repro.train.serve_step as jserve
import repro_torch.models.lm as tlm
import repro_torch.train.serve_step as tserve
from repro_torch import float64
from repro.configs import get_smoke_arch as j_smoke
from repro_torch.configs import get_smoke_arch as t_smoke
from repro_torch.data.tokens import synthetic_lm_batch

B, S, GEN, PATCHES = 2, 12, 3, 4
# the JAX modules whose float32 casts are lifted (the port's:
# ``repro_torch.float64.CAST_MODULES``)
J_CASTS = (jref, jattn, jrope, jmoe, jlm, jserve, jmamba, jxlstm, jnorm,
           jencdec)


def lift(monkeypatch):
    """Both packages' float32 casts taken to float64 for the test."""
    for module in J_CASTS:
        proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                         if not k.startswith("__")})
        proxy.float32 = jnp.float64
        monkeypatch.setattr(module, "jnp", proxy)
    for module in float64.cast_modules():
        monkeypatch.setattr(module, "torch", float64.Float64Torch())


def one_thread():
    """A fixture body: torch on one intra-op thread for the test, then as
    it was (the smoke-width tensors are tiny, and a time loop's thousands
    of small ops cost several times more with a thread pool behind each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-300)
    assert err <= tol, f"max |diff| / max |want| = {err:.3e} > {tol}"


def upcast(tree):
    """A JAX param tree with every floating leaf in float64."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def inputs(arch):
    """Prompt tokens, teacher-forced decode tokens and (patch frontend)
    patch embeddings, from numpy seeds."""
    toks = synthetic_lm_batch(0, B, S + 1, arch.vocab)["tokens"]
    rng = np.random.default_rng(1)
    feed = rng.integers(0, arch.vocab, size=(GEN, B, 1))
    patches = rng.normal(size=(B, PATCHES, arch.d_frontend)) \
        if arch.frontend == "patch" else None
    return toks, feed, patches


def serve_pair(arch_id, dtype, monkeypatch, cache=None):
    """Prefill + GEN decode steps in both packages from JAX's weights.
    float64: weights and cache in float64, casts lifted; float32: float32
    weights and a ``cache`` of "float32" (the default) or "bfloat16" (the
    serving path's).  Returns the logits of each step, (JAX, port) pairs
    of numpy arrays."""
    jarch, tarch = j_smoke(arch_id), t_smoke(arch_id)
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    params = jax.jit(jlm.init_lm, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jarch, jdt)
    if dtype == "float64":
        params = upcast(params)
    tparams = tlm.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), tarch, device="cpu",
        dtype=torch.float64 if dtype == "float64" else None)
    toks, feed, patches = inputs(jarch)
    off = PATCHES if patches is not None else 0
    max_len = off + S + GEN
    if dtype == "float64":
        lift(monkeypatch)
    cache = cache or dtype
    jc, tc = getattr(jnp, cache), getattr(torch, cache)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.tensor(toks)}
    if patches is not None:
        jb["patch_embeds"] = jnp.asarray(patches.astype(np.dtype(dtype)))
        tb["patch_embeds"] = torch.tensor(patches.astype(np.dtype(dtype)))
    jpre = jax.jit(jserve.make_prefill_step(jarch, B, max_len,
                                            cache_dtype=jc))
    jdec = jax.jit(jserve.make_decode_step(jarch))
    tpre = tserve.make_prefill_step(tarch, B, max_len, cache_dtype=tc)
    tdec = tserve.make_decode_step(tarch)
    jl, jcache = jpre(params, jb)
    tl, tcache = tpre(tparams, tb)
    pairs = [(np.asarray(jl), tl.numpy())]
    for i in range(GEN):
        pos = off + S + i
        jl, jcache = jdec(params, jcache, jnp.asarray(feed[i]),
                          jnp.int32(pos))
        tl, tcache = tdec(tparams, tcache, torch.tensor(feed[i]), pos)
        pairs.append((np.asarray(jl), tl.numpy()))
    return pairs


def train_batch(arch, step=0):
    """A training batch as numpy, with the patch frontend's embeddings."""
    b = dict(synthetic_lm_batch(step, B, S + 1, arch.vocab))
    if arch.frontend == "patch":
        b["patch_embeds"] = np.random.default_rng(step + 7).normal(
            size=(B, PATCHES, arch.d_frontend))
    return b
