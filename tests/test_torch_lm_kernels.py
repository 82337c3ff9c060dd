"""PyTorch port: the LM kernels (rms_norm, flash attention), their plain
versions and their dispatch.

The plain PyTorch versions (``repro_torch.kernels.ref``) are held against
the JAX package's oracles (``repro.kernels.ref``) and against its Pallas
kernels run in interpret mode, as ``tests/test_kernels.py`` runs them, on
the same numpy inputs on the CPU.  The CUDA kernels are held against the
plain versions on the card in ``tests/test_torch_cuda.py``, which needs no
JAX.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.rmsnorm import rms_norm_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import butcher_combine as combine_kern
from repro_torch.kernels import flash_attention as flash_kern
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as rms_kern

from test_torch_cuda import ATTN_CASES, DTYPES, RMS_TOL, TOL, attn_inputs

JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if isinstance(
        a, jax.Array) else a.to(torch.float32).numpy()


@functools.lru_cache(maxsize=None)
def _jax_attention(case, dtype):
    """(Pallas interpret output, oracle output) as float32 numpy."""
    _, _, _, _, _, _, causal, window, q_offset = case
    jdt = JAX_DTYPES[dtype]
    q, k, v = (jnp.asarray(a).astype(jdt) for a in attn_inputs(case))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    pallas = flash_attention_pallas(q, k, v, block_q=64, block_k=64,
                                    interpret=True, **kw)
    oracle = jref.attention_ref(q, k, v, **kw)
    return _np(pallas), _np(oracle)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_ref_matches_jax(case, dtype):
    _, _, _, _, _, _, causal, window, q_offset = case
    tdt = DTYPES[dtype]
    q, k, v = (torch.tensor(a).to(tdt) for a in attn_inputs(case))
    got = tref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    assert got.shape == q.shape and got.dtype == tdt
    pallas, oracle = _jax_attention(case, dtype)
    np.testing.assert_allclose(_np(got), oracle, **TOL[dtype])
    np.testing.assert_allclose(_np(got), pallas, **TOL[dtype])


def test_attention_ref_fully_masked_rows_are_zero():
    """A row that may see no key (window 1 past a query offset beyond the
    keys) gives zeros, not NaN, in both packages."""
    case = (1, 2, 1, 4, 8, 16, True, 1, 20)
    q, k, v = (torch.tensor(a) for a in attn_inputs(case))
    got = tref.attention_ref(q, k, v, causal=True, window=1, q_offset=20)
    want = jref.attention_ref(*(jnp.asarray(a) for a in attn_inputs(case)),
                              causal=True, window=1, q_offset=20)
    assert torch.equal(got, torch.zeros_like(got))
    np.testing.assert_array_equal(np.asarray(want), 0.0)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("qdtype", ["float32", "float64"])
def test_decode_attention_ref_matches_jax(qdtype, window):
    """q against a bfloat16 cache: both packages take both operands to
    float32, round the probabilities to bfloat16 and accumulate in float32,
    so the results agree to float32 summation order (rtol 1e-5)."""
    B, H, Hkv, Smax, D, pos = 2, 4, 2, 40, 16, 17
    rng = np.random.default_rng(3)
    q = rng.normal(size=(B, H, 1, D)).astype(qdtype)
    kc = rng.normal(size=(B, Smax, Hkv, D)).astype(np.float32)
    vc = rng.normal(size=(B, Smax, Hkv, D)).astype(np.float32)
    want = jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc).astype(jnp.bfloat16),
        jnp.asarray(vc).astype(jnp.bfloat16), jnp.int32(pos), window=window)
    got = tref.decode_attention_ref(
        torch.tensor(q), torch.tensor(kc).to(torch.bfloat16),
        torch.tensor(vc).to(torch.bfloat16), pos, window=window)
    assert got.dtype == torch.float64 if qdtype == "float64" else \
        got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


RMS_SHAPES = [(1, 16), (37, 128), (2, 5, 1024), (3, 4, 2, 16), (130, 32)]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rms_norm_ref_matches_jax(shape, dtype, residual):
    """float64 inputs are normalised in float32 in both packages (as the
    JAX kernel does), so they are held to the float32 tolerance."""
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = rng.normal(size=shape)
    r = rng.normal(size=shape) if residual else None
    w = rng.normal(size=shape[-1:])
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "float64": jnp.float64}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}[dtype]
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    jr = None if r is None else jnp.asarray(r).astype(jdt)
    oracle = jref.rms_norm_ref(jx, jw, jr)
    pallas = rms_norm_pallas(jx, jw, jr, block_rows=8, interpret=True)
    got = tref.rms_norm_ref(torch.tensor(x).to(tdt), torch.tensor(w).to(tdt),
                            None if r is None else torch.tensor(r).to(tdt))
    assert got.dtype == tdt and got.shape == shape
    tol = RMS_TOL["bfloat16" if dtype == "bfloat16" else "float32"]
    np.testing.assert_allclose(_np(got), _np(oracle), **tol)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)


def test_ops_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(3, 32)))
    w = torch.tensor(rng.normal(size=(32,)))
    q, k, v = (torch.tensor(a) for a in attn_inputs(ATTN_CASES[3]))
    before = (rms_kern.rms_norm.launches, flash_kern.flash_attention.launches)
    assert torch.equal(ops.rms_norm(x, w, x), tref.rms_norm_ref(x, w, x))
    assert torch.equal(ops.rms_norm(x, w, use_kernels=False),
                       tref.rms_norm_ref(x, w))
    assert torch.equal(ops.attention(q, k, v, window=16),
                       tref.attention_ref(q, k, v, window=16))
    # nothing was launched: the counters move only where a kernel launches
    assert (rms_kern.rms_norm.launches,
            flash_kern.flash_attention.launches) == before


def test_ops_use_kernels_true_never_falls_back():
    x = torch.ones(2, 16)
    q = torch.ones(1, 2, 4, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rms_norm(x, torch.ones(16), use_kernels=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.attention(q, q, q, use_kernels=True)


def test_ops_kernel_path_refuses_autograd():
    """The kernel path is differentiable through the backward kernels
    (``ops._RmsNorm``, ``ops._Attention``) and never hands a gradient to
    the plain version: a tensor that requires grad on the kernel path goes
    to the kernel or raises (here, a CPU tensor is refused with and without
    grad); ``use_kernels=False`` differentiates the plain version."""
    x = torch.ones(2, 16, requires_grad=True)
    q = torch.ones(1, 2, 4, 16, requires_grad=True)
    before = (rms_kern.rms_norm_bwd.launches,
              flash_kern.flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rms_norm(x, torch.ones(16), use_kernels=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.attention(q, q, q, use_kernels=True)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensor"):
            ops.rms_norm(x, torch.ones(16), use_kernels=True)
    y = ops.rms_norm(x, torch.ones(16), use_kernels=False)
    y.sum().backward()
    assert x.grad is not None
    assert (rms_kern.rms_norm_bwd.launches,
            flash_kern.flash_attention_bwd.launches) == before
    # the backward wrappers take float32, float64 and bfloat16 only
    with pytest.raises(TypeError, match="not supported"):
        rms_kern.rms_norm_bwd(x.detach().to(torch.float16),
                              torch.ones(16), None,
                              x.detach().to(torch.float16))
    qb = q.detach().to(torch.float16)
    with pytest.raises(TypeError, match="not supported"):
        flash_kern.flash_attention_bwd(qb, qb, qb, qb,
                                       torch.zeros(1, 2, 4), qb)


def test_wrappers_check_their_inputs():
    """Shapes, dtypes and layouts are checked before the device, so the
    checks run here; a CPU tensor is refused, never computed."""
    x = torch.ones(4, 32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rms_kern.rms_norm(x, torch.ones(32))
    with pytest.raises(ValueError, match="weight shape"):
        rms_kern.rms_norm(x, torch.ones(16))
    with pytest.raises(ValueError, match="residual"):
        rms_kern.rms_norm(x, torch.ones(32), torch.ones(4, 32,
                                                        dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        rms_kern.rms_norm(torch.ones(32, 4).t(), torch.ones(32))
    with pytest.raises(TypeError, match="not supported"):
        rms_kern.rms_norm(x.to(torch.int32), torch.ones(32))
    q = torch.ones(1, 4, 8, 64)
    kv = torch.ones(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_kern.flash_attention(q, kv, kv)
    # a (B, S, H, D) projection read through its (B, H, S, D) view is fine
    # (the check reaches the device test); a strided last dim is not
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_kern.flash_attention(torch.ones(1, 8, 4, 64).transpose(1, 2),
                                   kv, kv)
    with pytest.raises(ValueError, match="last dim must be contiguous"):
        flash_kern.flash_attention(torch.ones(1, 4, 64, 8).transpose(2, 3),
                                   kv, kv)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_kern.flash_attention(torch.ones(1, 4, 8, 48),
                                   torch.ones(1, 2, 8, 48),
                                   torch.ones(1, 2, 8, 48))
    with pytest.raises(ValueError, match="H % Hkv"):
        flash_kern.flash_attention(torch.ones(1, 4, 8, 64),
                                   torch.ones(1, 3, 8, 64),
                                   torch.ones(1, 3, 8, 64))
    with pytest.raises(TypeError, match="differ"):
        flash_kern.flash_attention(q, kv.to(torch.bfloat16), kv)
    # TMA reads 16-byte aligned bases only: a q at storage offset 1 is
    # refused before the device check
    with pytest.raises(ValueError, match="16-byte"):
        flash_kern.flash_attention(torch.ones(1 + 4 * 8 * 64)[1:].view(
            1, 4, 8, 64), kv, kv)


@pytest.mark.parametrize("module,library,source,entries", [
    (rms_kern, "LIBRARY", "SOURCE", ["rms_norm_launch"]),
    (flash_kern, "LIBRARY", "SOURCE", ["flash_attention_launch"]),
    (combine_kern, "LIBRARY", "SOURCE", ["butcher_combine_launch"]),
    (combine_kern, "ROWS_LIBRARY", "ROWS_SOURCE",
     ["butcher_combine_rows_launch"]),
])
def test_kernel_sources_build_through_one_helper(module, library, source,
                                                 entries):
    lib, path = getattr(module, library), getattr(module, source)
    src = path.read_text()
    assert lib.source == path
    assert path.parent == _build.CSRC
    for entry in entries:
        assert f'extern "C" int {entry}' in src
        assert entry in lib.entries
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "replaces repro/kernels/" in src
