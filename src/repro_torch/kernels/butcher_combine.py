"""CUDA kernels for the fused Runge-Kutta stage combination (Hopper, sm_90a).

Two kernels over a stacked slope buffer ``ks`` with leading stage dim s,
both in ``csrc/butcher_combine.cu``:

  * ``butcher_combine``      — one coefficient row:
        out = x + sum_i hc[i] * ks[i]
    (replaces the JAX package's ``butcher_combine_pallas``)
  * ``butcher_combine_rows`` — m rows from ONE read of (x, ks):
        out[r] = sc[r] * x + sum_i hc[r, i] * ks[i]
    (replaces ``butcher_combine_rows_pallas``; the solver uses it for the
    fused step update + embedded error, rows = [b; b_err], sc = [1; 0])

``hc``/``sc`` arrive already scaled by the step size, in the accumulation
dtype ``promote(x.dtype, float32)``, as device tensors: the wrappers never
read them on the host.  The plain PyTorch versions of both functions are in
``kernels/ref.py``; ``kernels/ops.py`` routes CPU tensors there and CUDA
tensors here.

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface and loaded with ``ctypes`` (``kernels/_build.py``).
Each wrapper counts its kernel launches in ``<wrapper>.launches``, a plain
integer that callers may reset.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import BUILD_DIR, NVCC_FLAGS, CudaLibrary, raise_on
from .ref import acc_dtype

__all__ = ["butcher_combine", "butcher_combine_rows", "MAX_STAGES",
           "MAX_ROWS", "SOURCE", "BUILD_DIR", "NVCC_FLAGS"]

MAX_STAGES = 13
MAX_ROWS = 13
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}
_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("butcher_combine", {
    "butcher_combine_launch": [_i32, _vp, _vp, _vp, _vp, _i64, _i32, _vp],
    "butcher_combine_rows_launch": [_i32, _vp, _vp, _vp, _vp, _vp, _i64,
                                    _i32, _i32, _vp],
})
SOURCE = LIBRARY.source


def _check(x: torch.Tensor, ks: torch.Tensor, coef: torch.Tensor,
           coef_shape, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(have {sorted(map(str, _DTYPE_CODE))})")
    if ks.dtype != x.dtype:
        raise TypeError(f"{name}: ks dtype {ks.dtype} != x dtype {x.dtype}")
    if tuple(ks.shape[1:]) != tuple(x.shape) or ks.ndim != x.ndim + 1:
        raise ValueError(f"{name}: ks shape {tuple(ks.shape)} is not "
                         f"(s,) + {tuple(x.shape)}")
    s = ks.shape[0]
    if not 1 <= s <= MAX_STAGES:
        raise ValueError(f"{name}: s={s} stages not in [1, {MAX_STAGES}]")
    acc = acc_dtype(x.dtype)
    if coef.dtype != acc or tuple(coef.shape) != tuple(coef_shape):
        raise ValueError(f"{name}: coefficients must be {acc} of shape "
                         f"{tuple(coef_shape)}, got {coef.dtype} "
                         f"{tuple(coef.shape)}")
    for t in (ks, coef):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    for t in (x, ks, coef):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return s


def butcher_combine(x: torch.Tensor, ks: torch.Tensor,
                    hc: torch.Tensor) -> torch.Tensor:
    """out = x + sum_i hc[i] * ks[i] on the card.

    x: (...,) CUDA tensor of float32/float64/float16/bfloat16; ks: (s,) +
    x.shape of the same dtype, 1 <= s <= 13; hc: (s,) in promote(x.dtype,
    float32).  All contiguous on one device.
    """
    s = _check(x, ks, hc, (ks.shape[0],), "butcher_combine")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.butcher_combine_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), ks.data_ptr(), hc.data_ptr(),
            out.data_ptr(), n, s, stream)
    raise_on(err, "butcher_combine")
    butcher_combine.launches += 1
    return out


def butcher_combine_rows(x: torch.Tensor, ks: torch.Tensor, hc: torch.Tensor,
                         sc: torch.Tensor) -> torch.Tensor:
    """out[r] = sc[r] * x + sum_i hc[r, i] * ks[i] on the card, all m rows
    from one read of (x, ks).  hc: (m, s), sc: (m,), both in
    promote(x.dtype, float32); 1 <= m <= 13.  Returns (m,) + x.shape."""
    m = hc.shape[0] if hc.ndim == 2 else -1
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"butcher_combine_rows: hc must be (m, s) with "
                         f"1 <= m <= {MAX_ROWS}, got {tuple(hc.shape)}")
    s = _check(x, ks, hc, (m, ks.shape[0]), "butcher_combine_rows")
    _check(x, ks, sc, (m,), "butcher_combine_rows")
    out = torch.empty((m,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.butcher_combine_rows_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), ks.data_ptr(), hc.data_ptr(),
            sc.data_ptr(), out.data_ptr(), n, s, m, stream)
    raise_on(err, "butcher_combine_rows")
    butcher_combine_rows.launches += 1
    return out


butcher_combine.launches = 0
butcher_combine_rows.launches = 0
