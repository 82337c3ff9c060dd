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

from ._build import CudaLibrary, raise_on

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
    """
    name = "rms_norm"
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(have {sorted(map(str, _DTYPE_CODE))})")
    if x.ndim < 1 or tuple(w.shape) != (x.shape[-1],):
        raise ValueError(f"{name}: weight shape {tuple(w.shape)} is not "
                         f"(d,) for x of shape {tuple(x.shape)}")
    if residual is not None and (residual.dtype != x.dtype or
                                 residual.shape != x.shape):
        raise ValueError(f"{name}: residual {residual.dtype} "
                         f"{tuple(residual.shape)} is not like x {x.dtype} "
                         f"{tuple(x.shape)}")
    for t in (x, residual):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: x and residual must be contiguous "
                             f"(got strides {tuple(t.stride())})")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    for t in (w, residual):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    out = torch.empty_like(x)
    d = x.shape[-1]
    if x.numel() == 0:
        return out
    wf = w.to(torch.float32).contiguous()
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rms_norm_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(),
            None if residual is None else residual.data_ptr(), wf.data_ptr(),
            out.data_ptr(), x.numel() // d, d, float(eps), stream)
    raise_on(err, name)
    rms_norm.launches += 1
    return out


rms_norm.launches = 0
