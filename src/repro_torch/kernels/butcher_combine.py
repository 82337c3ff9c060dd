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

from ._build import BUILD_DIR, NVCC_FLAGS, CudaLibrary, call, raise_on
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


_ACC = {dt: acc_dtype(dt) for dt in _DTYPE_CODE}


def _check(x: torch.Tensor, ks: torch.Tensor, name: str):
    """Checks x and ks; returns (dtype code, s, device index).  Sizes are
    compared directly and messages are built only to raise."""
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(have {sorted(map(str, _DTYPE_CODE))})")
    if ks.dtype != x.dtype:
        raise TypeError(f"{name}: ks dtype {ks.dtype} != x dtype {x.dtype}")
    if ks.shape[1:] != x.shape or ks.dim() != x.dim() + 1:
        raise ValueError(f"{name}: ks shape {tuple(ks.shape)} is not "
                         f"(s,) + {tuple(x.shape)}")
    s = ks.shape[0]
    if not 1 <= s <= MAX_STAGES:
        raise ValueError(f"{name}: s={s} stages not in [1, {MAX_STAGES}]")
    return code, s, x.get_device()


def _check_coef(x: torch.Tensor, ks: torch.Tensor, coef: torch.Tensor,
                shape, index: int, name: str):
    acc = _ACC[x.dtype]
    if coef.dtype != acc or coef.shape != shape:
        raise ValueError(f"{name}: coefficients must be {acc} of shape "
                         f"{tuple(shape)}, got {coef.dtype} "
                         f"{tuple(coef.shape)}")
    if ks.get_device() != index or coef.get_device() != index:
        t = ks if ks.get_device() != index else coef
        raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    if not (x.is_contiguous() and ks.is_contiguous() and
            coef.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")


def butcher_combine(x: torch.Tensor, ks: torch.Tensor,
                    hc: torch.Tensor) -> torch.Tensor:
    """out = x + sum_i hc[i] * ks[i] on the card.

    x: (...,) CUDA tensor of float32/float64/float16/bfloat16; ks: (s,) +
    x.shape of the same dtype, 1 <= s <= 13; hc: (s,) in promote(x.dtype,
    float32).  All contiguous on one device.

    The kernel moves 16-byte vectors when n * itemsize is a multiple of 16
    and x, ks and out are 16-byte aligned (its scalar path otherwise), with
    all s stage loads of a vector in flight before the sums, which run in
    stage order 0..s-1.
    """
    name = "butcher_combine"
    code, s, index = _check(x, ks, name)
    _check_coef(x, ks, hc, (s,), index, name)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    err = call(LIBRARY.load().butcher_combine_launch, index, code,
               x.data_ptr(), ks.data_ptr(), hc.data_ptr(), out.data_ptr(), n,
               s)
    raise_on(err, name)
    butcher_combine.launches += 1
    return out


def butcher_combine_rows(x: torch.Tensor, ks: torch.Tensor, hc: torch.Tensor,
                         sc: torch.Tensor) -> torch.Tensor:
    """out[r] = sc[r] * x + sum_i hc[r, i] * ks[i] on the card, all m rows
    from one read of (x, ks).  hc: (m, s), sc: (m,), both in
    promote(x.dtype, float32); 1 <= m <= 13.  Returns (m,) + x.shape."""
    name = "butcher_combine_rows"
    m = hc.shape[0] if hc.dim() == 2 else -1
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"{name}: hc must be (m, s) with "
                         f"1 <= m <= {MAX_ROWS}, got {tuple(hc.shape)}")
    code, s, index = _check(x, ks, name)
    _check_coef(x, ks, hc, (m, s), index, name)
    _check_coef(x, ks, sc, (m,), index, name)
    out = torch.empty((m,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    err = call(LIBRARY.load().butcher_combine_rows_launch, index, code,
               x.data_ptr(), ks.data_ptr(), hc.data_ptr(), sc.data_ptr(),
               out.data_ptr(), n, s, m)
    raise_on(err, name)
    butcher_combine_rows.launches += 1
    return out


butcher_combine.launches = 0
butcher_combine_rows.launches = 0
