"""CUDA kernels for the fused Runge-Kutta stage combination (Hopper, sm_90a).

Two kernels over a stacked slope buffer ``ks`` with leading stage dim s,
in ``csrc/butcher_combine.cu`` and ``csrc/butcher_combine_rows.cu`` (their
shared design in ``csrc/butcher_combine.cuh``; two sources, so the two
build in parallel), each with one coefficient row for the whole buffer or
one row per lane (the leading axis of ``x``):

  * ``butcher_combine``      — out = x + sum_i hc[i] * ks[i], or per lane b
        out[b] = x[b] + sum_i hc[b, i] * ks[i, b]
    (replaces the JAX package's ``butcher_combine_pallas``)
  * ``butcher_combine_rows`` — m rows from ONE read of (x, ks):
        out[r] = sc[r] * x + sum_i hc[r, i] * ks[i], or per lane b
        out[r, b] = sc[r] * x[b] + sum_i hc[b, r, i] * ks[i, b]
    (replaces ``butcher_combine_rows_pallas``; the solver uses it for the
    fused step update + embedded error, rows = [b; b_err], sc = [1; 0])

The lane forms are what a lane-batched solve (``solve(..., batch_axis=0)``)
needs: every lane steps with its own h, so every lane has its own row, and
one launch covers all lanes.

``hc``/``sc`` arrive already scaled by the step size, in the accumulation
dtype ``promote(x.dtype, float32)``, as device tensors: the wrappers never
read them on the host.  The plain PyTorch versions of both functions are in
``kernels/ref.py``; ``kernels/ops.py`` routes CPU tensors there and CUDA
tensors here.

Each source is compiled with ``nvcc`` at first use into a shared library
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
           "MAX_ROWS", "SOURCE", "ROWS_SOURCE", "BUILD_DIR", "NVCC_FLAGS"]

MAX_STAGES = 13
MAX_ROWS = 13
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}
_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIBRARY = CudaLibrary("butcher_combine", {
    "butcher_combine_launch": [_i32, _vp, _vp, _vp, _vp, _i64, _i64, _i32,
                               _vp],
})
ROWS_LIBRARY = CudaLibrary("butcher_combine_rows", {
    "butcher_combine_rows_launch": [_i32, _vp, _vp, _vp, _vp, _vp, _i64,
                                    _i64, _i32, _i32, _vp],
})
SOURCE, ROWS_SOURCE = LIBRARY.source, ROWS_LIBRARY.source


_ACC = {dt: acc_dtype(dt) for dt in _DTYPE_CODE}


def _check(name: str, x: torch.Tensor, ks: torch.Tensor, hc: torch.Tensor,
           row: tuple):
    """Checks x, ks and the coefficients hc against one row of shape
    ``row`` or one per lane, ``(B,) + row`` with B = x.shape[0].  Returns
    (dtype code, n, n_lane, device index).  Sizes are compared directly
    and messages are built only to raise.  Shapes and dtypes are checked
    before the device, so a bad call is refused the same way anywhere."""
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(have {sorted(map(str, _DTYPE_CODE))})")
    if ks.dtype != x.dtype:
        raise TypeError(f"{name}: ks dtype {ks.dtype} != x dtype {x.dtype}")
    if ks.dim() != x.dim() + 1 or ks.shape[1:] != x.shape or \
            ks.shape[0] != row[-1]:
        raise ValueError(f"{name}: ks shape {tuple(ks.shape)} is not "
                         f"({row[-1]},) + {tuple(x.shape)} (s = {row[-1]} "
                         f"stages)")
    n = x.numel()
    shape = hc.shape
    if shape == row:
        n_lane = n
    elif shape[1:] == row and x.dim() > 0 and shape[0] == x.shape[0] > 0:
        n_lane = n // shape[0]
    else:
        raise ValueError(f"{name}: coefficients must be {tuple(row)} or "
                         f"(B,) + {tuple(row)} with B = x.shape[0], got "
                         f"{tuple(shape)} for x {tuple(x.shape)}")
    if hc.dtype != _ACC[x.dtype]:
        raise ValueError(f"{name}: coefficients must be {_ACC[x.dtype]}, "
                         f"got {hc.dtype}")
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    index = x.get_device()
    if ks.get_device() != index or hc.get_device() != index:
        t = ks if ks.get_device() != index else hc
        raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    if not (x.is_contiguous() and ks.is_contiguous() and
            hc.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    return code, n, n_lane, index


def butcher_combine(x: torch.Tensor, ks: torch.Tensor,
                    hc: torch.Tensor) -> torch.Tensor:
    """out = x + sum_i hc[i] * ks[i] on the card, or with one row per lane
    out[b] = x[b] + sum_i hc[b, i] * ks[i, b].

    x: (...,) CUDA tensor of float32/float64/float16/bfloat16; ks: (s,) +
    x.shape of the same dtype, 1 <= s <= 13; hc: (s,) or (B, s) with
    B = x.shape[0], in promote(x.dtype, float32).  All contiguous on one
    device.

    The kernel moves 16-byte vectors when n * itemsize is a multiple of 16,
    x, ks and out are 16-byte aligned and a lane holds at least one vector
    (its scalar path otherwise), with all s stage loads of a vector in
    flight before the sums, which run in stage order 0..s-1.
    """
    name = "butcher_combine"
    s = ks.shape[0] if ks.dim() else 0
    if not 1 <= s <= MAX_STAGES:
        raise ValueError(f"{name}: s={s} stages not in [1, {MAX_STAGES}]")
    code, n, n_lane, index = _check(name, x, ks, hc, (s,))
    out = torch.empty_like(x)
    if n == 0:
        return out
    err = call(LIBRARY.load().butcher_combine_launch, index, code,
               x.data_ptr(), ks.data_ptr(), hc.data_ptr(), out.data_ptr(), n,
               n_lane, s)
    raise_on(err, name)
    butcher_combine.launches += 1
    return out


def butcher_combine_rows(x: torch.Tensor, ks: torch.Tensor, hc: torch.Tensor,
                         sc: torch.Tensor) -> torch.Tensor:
    """out[r] = sc[r] * x + sum_i hc[r, i] * ks[i] on the card, or with one
    (m, s) block of rows per lane out[r, b] = sc[r] * x[b] + sum_i
    hc[b, r, i] * ks[i, b]; all m rows from one read of (x, ks).  hc:
    (m, s) or (B, m, s) with B = x.shape[0]; sc: (m,); both in
    promote(x.dtype, float32); 1 <= m <= 13.  Returns (m,) + x.shape."""
    name = "butcher_combine_rows"
    shape = hc.shape
    if not 2 <= len(shape) <= 3:
        raise ValueError(f"{name}: hc must be (m, s) or (B, m, s), got "
                         f"{tuple(shape)}")
    m, s = shape[-2], shape[-1]
    if not (1 <= m <= MAX_ROWS and 1 <= s <= MAX_STAGES):
        raise ValueError(f"{name}: m={m} rows, s={s} stages not in [1, "
                         f"{MAX_ROWS}] and [1, {MAX_STAGES}]")
    code, n, n_lane, index = _check(name, x, ks, hc, (m, s))
    if sc.shape != (m,) or sc.dtype != hc.dtype or \
            sc.get_device() != index or not sc.is_contiguous():
        raise ValueError(f"{name}: sc must be a contiguous {hc.dtype} "
                         f"({m},) on {x.device}, got {sc.dtype} "
                         f"{tuple(sc.shape)} on {sc.device}")
    out = x.new_empty(m, *x.shape)
    if n == 0:
        return out
    err = call(ROWS_LIBRARY.load().butcher_combine_rows_launch, index, code,
               x.data_ptr(), ks.data_ptr(), hc.data_ptr(), sc.data_ptr(),
               out.data_ptr(), n, n_lane, s, m)
    raise_on(err, name)
    butcher_combine_rows.launches += 1
    return out


butcher_combine.launches = 0
butcher_combine_rows.launches = 0
