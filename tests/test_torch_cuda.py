"""PyTorch port: the LM kernels (rms_norm, flash attention) against their
plain PyTorch versions on the card.

``cuda`` marker: skipped with a reason where there is no CUDA device.  This
file imports no JAX, so it runs on a machine that has only PyTorch (the
suite's conftest imports JAX, hence ``--noconftest``):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

It also holds the cases and tolerances that ``test_torch_lm_kernels.py``
uses against the JAX package on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as flash_kern
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as rms_kern

# (B, H, Hkv, Sq, Sk, D, causal, window, q_offset): tests/test_kernels.py's
ATTN_CASES = [
    (1, 4, 4, 128, 128, 64, True, None, 0),     # MHA causal
    (2, 8, 2, 256, 256, 64, True, None, 0),     # GQA causal
    (1, 4, 1, 128, 128, 128, True, 64, 0),      # MQA + sliding window
    (1, 4, 2, 100, 100, 64, True, None, 0),     # ragged (padding path)
    (2, 8, 4, 1, 512, 64, True, None, 511),     # decode: 1 query vs cache
    (1, 4, 4, 64, 256, 64, True, None, 192),    # chunked prefill offset
    (1, 4, 4, 128, 128, 64, False, None, 0),    # non-causal (encoder)
    (1, 16, 8, 1, 300, 64, True, 128, 299),     # decode + SWA, ragged cache
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Both sides compute in float32 and differ only in the order of the float32
# sums (dot products, softmax and mean-of-squares reductions): ~1e-6
# relative.  bfloat16 outputs are that float32 result rounded once, so a
# rounding flip costs one bfloat16 ulp; these are tests/test_kernels.py's
# Pallas-vs-oracle tolerances.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
RMS_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
           "bfloat16": dict(rtol=float(torch.finfo(torch.bfloat16).eps),
                            atol=1e-6)}


def attn_inputs(case, seed=42):
    """float32 numpy (q, k, v) for an ``ATTN_CASES`` entry."""
    B, H, Hkv, Sq, Sk, D = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_kernel_matches_plain_on_card(dtype):
    dev = _on_card()
    tdt = DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(0)
    for rows, d in ((8192, 1024), (4099, 128), (7, 16), (33, 1000)):
        x = torch.randn(rows, d, generator=g, device=dev).to(tdt)
        r = torch.randn(rows, d, generator=g, device=dev).to(tdt)
        w = torch.randn(d, generator=g, device=dev)
        for res in (None, r):
            got = rms_kern.rms_norm(x, w, res)
            want = tref.rms_norm_ref(x, w, res)
            torch.testing.assert_close(got.float(), want.float(),
                                       **RMS_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_kernel_matches_plain_on_card(case, dtype):
    dev = _on_card()
    _, _, _, _, _, _, causal, window, q_offset = case
    tdt = DTYPES[dtype]
    q, k, v = (torch.tensor(a, device=dev).to(tdt)
               for a in attn_inputs(case))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_kern.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(),
                               tref.attention_ref(q, k, v, **kw).float(),
                               **TOL[dtype])
