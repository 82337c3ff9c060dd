"""Dispatch for the kernels: a CPU tensor goes to the plain PyTorch
version (``kernels/ref.py``); any other tensor goes to the CUDA kernel
(``kernels/butcher_combine.py``, ``rmsnorm.py``, ``flash_attention.py``),
whose wrapper launches it or raises.  There is no fallback from the kernel
to the plain version.

``rms_norm`` and ``attention`` take ``use_kernels``, the counterpart of the
JAX package's ``use_pallas``: None picks by device as above; False takes
the plain version on any device, on purpose (a reference run on the card);
True takes the kernel, which raises for a CPU tensor.

``hc``/``sc`` of the combines are the final coefficient rows, already
multiplied by the step size, in ``promote(x.dtype, float32)`` on x's
device: one row for the whole buffer, or one row per lane (the leading
axis of x) for a lane-batched solve.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import butcher_combine as _kernels
from . import flash_attention as _flash
from . import ref
from . import rmsnorm as _rmsnorm


def butcher_combine(x: torch.Tensor, ks: torch.Tensor,
                    hc: torch.Tensor) -> torch.Tensor:
    """out = x + sum_i hc[i] * ks[i]."""
    if x.device.type == "cpu":
        return ref.butcher_combine_ref(x, ks, hc, 1.0)
    return _kernels.butcher_combine(x, ks, hc)


def butcher_combine_rows(x: torch.Tensor, ks: torch.Tensor, hc: torch.Tensor,
                         sc: torch.Tensor) -> torch.Tensor:
    """out[r] = sc[r] * x + sum_i hc[r, i] * ks[i]; (m,) + x.shape."""
    if x.device.type == "cpu":
        return ref.butcher_combine_rows_ref(x, ks, hc, sc, 1.0)
    return _kernels.butcher_combine_rows(x, ks, hc, sc)


def _use_kernel(x: torch.Tensor, use_kernels: Optional[bool],
                *inputs: Optional[torch.Tensor]) -> bool:
    use = x.device.type != "cpu" if use_kernels is None else use_kernels
    if use and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        raise NotImplementedError(
            "the rms_norm and flash_attention kernels have no backward yet "
            "(ROADMAP queue 1, item 14): run them under torch.no_grad(), or "
            "pass use_kernels=False to differentiate the plain version")
    return use


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             residual: Optional[torch.Tensor] = None, *, eps: float = 1e-6,
             use_kernels: Optional[bool] = None) -> torch.Tensor:
    """(x [+ residual]) * rsqrt(mean((x [+ residual])^2) + eps) * weight
    over the last dim, in float32, returned in x.dtype."""
    if _use_kernel(x, use_kernels, x, weight, residual):
        return _rmsnorm.rms_norm(x, weight, residual, eps=eps)
    return ref.rms_norm_ref(x, weight, residual, eps=eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, scale: Optional[float] = None,
              use_kernels: Optional[bool] = None) -> torch.Tensor:
    """GQA attention, q: (B, H, Sq, D), k, v: (B, Hkv, Sk, D) -> (B, H, Sq,
    D).  The plain version materialises the (Sq, Sk) scores; the JAX
    package's query-blocked plain path for long sequences
    (``attention_blocked_ref``) is not ported."""
    if _use_kernel(q, use_kernels, q, k, v):
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, scale=scale)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
