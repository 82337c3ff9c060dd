"""PyTorch port: tableaus, the plain combine versions, kernel dispatch.

The plain PyTorch versions of the two stage-combine kernels
(``repro_torch.kernels.ref``) are held against the JAX package's oracles
(``repro.kernels.ref``) in float64 on the CPU; the CUDA kernels are held
against the plain versions on the card (``cuda`` marker: skipped where
there is no CUDA device, run by ``chip_smoke.py`` and on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from repro.core import tableau as jtab
from repro.kernels import ref as jref
from repro_torch.core import tableau as ttab
from repro_torch.kernels import butcher_combine as kern
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

STAGES = (1, 3, 7, 12, 13)
# float64: the two packages run the same float64 operations in the same
# stage order; what differs is the libraries' rounding of a*b+c fusions.
RTOL_F64 = 1e-14


@pytest.mark.parametrize("name", sorted(jtab.TABLEAUS))
def test_tableaus_equal_exactly(name):
    a, b = jtab.get_tableau(name), ttab.get_tableau(name)
    assert sorted(ttab.TABLEAUS) == sorted(jtab.TABLEAUS)
    for field in ("name", "order", "a", "b", "c", "b_err", "err_order",
                  "err_uses_fsal", "fsal", "s", "n_fevals"):
        assert getattr(a, field) == getattr(b, field), field
    for dense in ("a_dense", "b_dense", "c_dense", "b_err_dense"):
        x, y = getattr(a, dense), getattr(b, dense)
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(jtab.HERMITE_DENSE_W, ttab.HERMITE_DENSE_W)


def _inputs(s, m=None, shape=(3, 7), seed=0):
    rng = np.random.default_rng(seed + s)
    x = rng.normal(size=shape)
    ks = rng.normal(size=(s,) + shape)
    coefs = rng.normal(size=(s,) if m is None else (m, s))
    sc = rng.normal(size=(m,)) if m is not None else None
    h = np.float64(rng.uniform(0.05, 0.5))
    return x, ks, coefs, sc, h


@pytest.mark.parametrize("s", STAGES)
def test_combine_ref_matches_jax(s):
    x, ks, coefs, _, h = _inputs(s)
    want = jref.butcher_combine_ref(jnp.asarray(x), jnp.asarray(ks),
                                    jnp.asarray(coefs), jnp.asarray(h))
    got = tref.butcher_combine_ref(torch.tensor(x), torch.tensor(ks),
                                   torch.tensor(coefs), torch.tensor(h))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL_F64, atol=0)


@pytest.mark.parametrize("s", STAGES)
def test_combine_rows_ref_matches_jax(s):
    x, ks, coefs, sc, h = _inputs(s, m=2)
    want = jref.butcher_combine_rows_ref(
        jnp.asarray(x), jnp.asarray(ks), jnp.asarray(coefs), jnp.asarray(sc),
        jnp.asarray(h))
    got = tref.butcher_combine_rows_ref(
        torch.tensor(x), torch.tensor(ks), torch.tensor(coefs),
        torch.tensor(sc), torch.tensor(h))
    assert got.shape == (2,) + x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL_F64, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_ref_low_precision_accumulates_in_f32(dtype):
    """Low-precision states accumulate in float32 and round once: the
    result equals the float64 sum rounded to ``dtype`` up to the float32
    accumulation error (1e-6 of the summed magnitudes) plus one ulp."""
    x, ks, coefs, _, h = _inputs(7)
    xt = torch.tensor(x).to(dtype)
    kt = torch.tensor(ks).to(dtype)
    got = tref.butcher_combine_ref(xt, kt, torch.tensor(coefs), float(h))
    assert got.dtype == dtype
    hc = (h * coefs).astype(np.float32).astype(np.float64)
    xd, kd = xt.double().numpy(), kt.double().numpy()
    exact = xd + np.tensordot(hc, kd, axes=1)
    mag = np.abs(xd) + np.tensordot(np.abs(hc), np.abs(kd), axes=1)
    ulp = torch.finfo(dtype).eps * np.abs(exact)
    err = np.abs(got.double().numpy() - exact)
    assert np.all(err <= 1e-6 * mag + ulp)


def test_ops_cpu_tensors_take_the_plain_version():
    x, ks, coefs, sc, h = _inputs(5, m=2)
    xt, kt = torch.tensor(x), torch.tensor(ks)
    hc = torch.tensor(h * coefs)
    before = (kern.butcher_combine.launches,
              kern.butcher_combine_rows.launches)
    got = ops.butcher_combine_rows(xt, kt, hc, torch.tensor(sc))
    want = tref.butcher_combine_rows_ref(xt, kt, hc, torch.tensor(sc), 1.0)
    assert torch.equal(got, want)
    got1 = ops.butcher_combine(xt, kt, hc[0])
    assert torch.equal(got1, tref.butcher_combine_ref(xt, kt, hc[0], 1.0))
    # nothing was launched: the counters move only where a kernel launches
    assert (kern.butcher_combine.launches,
            kern.butcher_combine_rows.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA tensors or raise: no fallback."""
    x, ks, coefs, sc, h = _inputs(3, m=2)
    xt, kt = torch.tensor(x), torch.tensor(ks)
    hc = torch.tensor(h * coefs)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.butcher_combine(xt, kt, hc[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kern.butcher_combine_rows(xt, kt, hc, torch.tensor(sc))
    with pytest.raises(ValueError, match=r"\(m, s\)"):
        kern.butcher_combine_rows(xt, kt, hc[0], torch.tensor(sc))


def test_kernel_source_is_in_the_package():
    src = kern.SOURCE.read_text()
    for entry in ("butcher_combine_launch", "butcher_combine_rows_launch"):
        assert f'extern "C" int {entry}' in src
    assert "arch=compute_90a,code=sm_90a" in kern.NVCC_FLAGS
    assert kern.BUILD_DIR.parent == kern.SOURCE.parent.parent


def _close(got, want, mag, dtype):
    """|got - want| <= rtol * (summed term magnitudes) [+ one bf16 ulp]:
    the kernel contracts a*b+c into one rounding, the plain version two."""
    acc = torch.promote_types(dtype, torch.float32)
    tol = (1e-13 if dtype == torch.float64 else 1e-6) * mag
    if dtype == torch.bfloat16:
        tol = tol + want.to(acc).abs() * torch.finfo(dtype).eps
    return bool(torch.all((got.to(acc) - want.to(acc)).abs() <= tol))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    acc = torch.promote_types(dtype, torch.float32)
    for n in (1, 127, 256 * 43):
        for s in STAGES:
            g = torch.Generator(device=dev).manual_seed(n + s)
            x = torch.randn(n, generator=g, device=dev).to(dtype)
            ks = torch.randn((s, n), generator=g, device=dev).to(dtype)
            hc = torch.randn((2, s), generator=g, device=dev,
                             dtype=torch.float64).to(acc)
            sc = torch.tensor([1.0, 0.0], device=dev, dtype=acc)
            kmag = hc.abs() @ ks.to(acc).abs()             # (2, n)
            xmag = x.to(acc).abs()
            got = kern.butcher_combine(x, ks, hc[0])
            want = tref.butcher_combine_ref(x, ks, hc[0], 1.0)
            assert _close(got, want, xmag + kmag[0], dtype)
            rows = kern.butcher_combine_rows(x, ks, hc, sc)
            rows_ref = tref.butcher_combine_rows_ref(x, ks, hc, sc, 1.0)
            assert _close(rows[0], rows_ref[0], xmag + kmag[0], dtype)
            assert _close(rows[1], rows_ref[1], kmag[1], dtype)
