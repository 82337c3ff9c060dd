"""CUDA kernel for RMSNorm with an optional fused residual add (Hopper,
sm_90a), in ``csrc/rmsnorm.cu``:

    rms_norm(x, w, residual=None, eps)
        = (x [+ residual]) * 1/sqrt(mean((x [+ residual])^2) + eps) * w

in float32 over the last dim, stored in ``x.dtype`` (replaces the JAX
package's ``rms_norm_pallas``).  The plain PyTorch version is
``kernels/ref.py::rms_norm_ref``; ``kernels/ops.py`` routes CPU tensors
there and CUDA tensors here.

The backward, ``rms_norm_bwd`` (float32, float64 and bfloat16), is in the
same source: one pass over the rows writes dx (which is also the residual's
gradient) and one partial row of dw per chunk of rows, then a small launch
sums the partials in a fixed order; no atomics, and the chunks depend on
the shape alone, so that two calls give the same bits.  bfloat16 rows are
read as they are and computed in float32 (the statistics, the dw partials
and dw), dx rounded to bfloat16 once: the JAX package's autodiff of its
float32 ``rms_norm_ref``, cast back.  ``kernels/ops.py``
makes the pair a ``torch.autograd.Function``; the plain version is
``kernels/ref.py::rms_norm_bwd_ref``.

Each wrapper counts its calls in ``<wrapper>.launches`` (one per call that
launches: ``rms_norm_bwd`` launches its two kernels per call), a plain
integer that callers may reset.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import CudaLibrary, call, raise_on

__all__ = ["rms_norm", "rms_norm_bwd", "SOURCE"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}
_vp = ctypes.c_void_p
LIBRARY = CudaLibrary("rmsnorm", {
    "rms_norm_launch": [ctypes.c_int, _vp, _vp, _vp, _vp, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_float, _vp],
    "rms_norm_bwd_launch": [ctypes.c_int, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                            ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_double,
                            _vp],
})
_BWD_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 3}
SOURCE = LIBRARY.source


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             residual: Optional[torch.Tensor] = None, *,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of ``x`` (+ ``residual``) over its last dim on the card.

    x: (..., d) CUDA tensor of float32/float64/float16/bfloat16, contiguous;
    residual: None or like x; w: (d,), any float dtype (read as float32).
    Returns a new tensor like x.

    The kernel reads each row once into registers, with 16-byte accesses
    where d and the pointers allow (a view at an odd storage offset, or a d
    that is not a multiple of 16 bytes, takes its scalar path), and writes
    it once: its bound is bytes over the card's memory rate.  The launch
    goes to the current stream; the device guard is taken only when x is
    not on the current device.
    """
    name = "rms_norm"
    code = _DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(have {sorted(map(str, _DTYPE_CODE))})")
    _check(x, w, residual, name)
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    if w.dtype != torch.float32 or not w.is_contiguous():
        w = w.to(torch.float32).contiguous()
    d = x.shape[-1]
    err = call(LIBRARY.load().rms_norm_launch, x.get_device(), code,
               x.data_ptr(),
               None if residual is None else residual.data_ptr(),
               w.data_ptr(), out.data_ptr(), n // d, d, float(eps))
    raise_on(err, name)
    rms_norm.launches += 1
    return out


DW_CHUNKS = 256             # blocks of the one-pass kernel, at most
DW_PARTIAL_ELEMENTS = 1 << 21   # dw partials, at most (8 MB in float32)
DW_MIN_ROWS = 32            # rows a chunk, at least


def _dw_chunks(rows: int, d: int):
    """Rows per chunk and chunk count of the one-pass kernel (one block and
    one partial row of dw per chunk): about 256 chunks (two blocks an SM on
    the H100), fewer where the partials would pass 2^21 elements (d past
    8192), at least 32 rows each.  A function of the shape alone, so the
    summation order is fixed on every card."""
    target = max(1, min(DW_CHUNKS, DW_PARTIAL_ELEMENTS // d))
    rpc = max(DW_MIN_ROWS, -(-rows // target))
    return rpc, -(-rows // rpc)


def rms_norm_bwd(x: torch.Tensor, w: torch.Tensor,
                 residual: Optional[torch.Tensor], dy: torch.Tensor, *,
                 eps: float = 1e-6):
    """The gradients of ``rms_norm(x, w, residual, eps)`` for the output
    cotangent ``dy``, on the card: (dx, dw).  dx, like x, is also the
    residual's gradient; dw is in w's dtype.  x, residual, dy: contiguous
    float32, float64 or bfloat16 CUDA tensors of one shape and dtype
    (another dtype raises ``TypeError``); w: (d,), read in the compute type
    (x's dtype; float32 for bfloat16), in which dw is summed."""
    name = "rms_norm_bwd"
    code = _BWD_DTYPE_CODE.get(x.dtype)
    if code is None:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(have {sorted(map(str, _BWD_DTYPE_CODE))})")
    _check(x, w, residual, name)
    if dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous() \
            or dy.device != x.device:
        raise ValueError(f"{name}: dy {dy.dtype} {tuple(dy.shape)} on "
                         f"{dy.device} is not a contiguous tensor like x "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    d = x.shape[-1]
    dx = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return dx, torch.zeros_like(w)
    acc = torch.promote_types(x.dtype, torch.float32)
    wt = w.to(acc).contiguous()
    rpc, nchunks = _dw_chunks(rows, d)
    dw = torch.empty(d, dtype=acc, device=x.device)
    partial = torch.empty((nchunks, d), dtype=acc, device=x.device)
    err = call(LIBRARY.load().rms_norm_bwd_launch, x.get_device(), code,
               x.data_ptr(),
               None if residual is None else residual.data_ptr(),
               wt.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(),
               partial.data_ptr(), rows, d, rpc, nchunks, float(eps))
    raise_on(err, name)
    rms_norm_bwd.launches += 1
    return dx, dw.to(w.dtype)


def _check(x: torch.Tensor, w: torch.Tensor,
           residual: Optional[torch.Tensor], name: str):
    shape = x.shape
    if not shape or w.shape != (shape[-1],):
        raise ValueError(f"{name}: weight shape {tuple(w.shape)} is not "
                         f"(d,) for x of shape {tuple(shape)}")
    if residual is not None and (residual.dtype != x.dtype or
                                 residual.shape != shape):
        raise ValueError(f"{name}: residual {residual.dtype} "
                         f"{tuple(residual.shape)} is not like x {x.dtype} "
                         f"{tuple(shape)}")
    if not x.is_contiguous() or (residual is not None and
                                 not residual.is_contiguous()):
        t = residual if x.is_contiguous() else x
        raise ValueError(f"{name}: x and residual must be contiguous "
                         f"(got strides {tuple(t.stride())})")
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    index = x.get_device()
    if w.get_device() != index or (residual is not None and
                                   residual.get_device() != index):
        t = w if w.get_device() != index else residual
        raise ValueError(f"{name}: tensors on {t.device} and {x.device}")


rms_norm.launches = 0
rms_norm_bwd.launches = 0
