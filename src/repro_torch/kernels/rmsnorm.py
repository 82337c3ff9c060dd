"""CUDA kernel for RMSNorm with an optional fused residual add (Hopper,
sm_90a), in ``csrc/rmsnorm.cu``:

    rms_norm(x, w, residual=None, eps)
        = (x [+ residual]) * 1/sqrt(mean((x [+ residual])^2) + eps) * w

in float32 over the last dim, stored in ``x.dtype`` (replaces the JAX
package's ``rms_norm_pallas``).  The plain PyTorch version is
``kernels/ref.py::rms_norm_ref``; ``kernels/ops.py`` routes CPU tensors
there and CUDA tensors here.

The wrapper counts its kernel launches in ``rms_norm.launches``, a plain
integer that callers may reset.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import CudaLibrary, call, raise_on

__all__ = ["rms_norm", "SOURCE"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}
_vp = ctypes.c_void_p
LIBRARY = CudaLibrary("rmsnorm", {
    "rms_norm_launch": [ctypes.c_int, _vp, _vp, _vp, _vp, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_float, _vp],
})
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
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    if w.dtype != torch.float32 or not w.is_contiguous():
        w = w.to(torch.float32).contiguous()
    d = shape[-1]
    err = call(LIBRARY.load().rms_norm_launch, index, code, x.data_ptr(),
               None if residual is None else residual.data_ptr(),
               w.data_ptr(), out.data_ptr(), n // d, d, float(eps))
    raise_on(err, name)
    rms_norm.launches += 1
    return out


rms_norm.launches = 0
