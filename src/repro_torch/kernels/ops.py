"""Dispatch for the kernels: a CPU tensor goes to the plain PyTorch
version (``kernels/ref.py``); any other tensor goes to the CUDA kernel
(``kernels/butcher_combine.py``, ``rmsnorm.py``, ``flash_attention.py``),
whose wrapper launches it or raises.  There is no fallback from the kernel
to the plain version.

``rms_norm`` and ``attention`` take ``use_kernels``, the counterpart of the
JAX package's ``use_pallas``: None picks by device as above; False takes
the plain version on any device, on purpose (a reference run on the card);
True takes the kernel, which raises for a CPU tensor.

``rms_norm`` and ``attention`` are differentiable on both paths: a CPU
tensor is differentiated by autograd through the plain version; on the
kernel path a tensor that requires grad goes through a
``torch.autograd.Function`` whose forward is the kernel (attention also
writes the rows' log-sum-exp, saved with q, k, v and the output; rms_norm
saves its inputs) and whose backward is the backward kernel
(``rms_norm_bwd``, ``flash_attention_bwd``): never the plain backward.
Without grad the forward kernel alone runs (attention then writes no
log-sum-exp).

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


def _use_kernel(x: torch.Tensor, use_kernels: Optional[bool]) -> bool:
    return x.device.type != "cpu" if use_kernels is None else use_kernels


def _needs_grad(*inputs: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)


class _RmsNorm(torch.autograd.Function):
    """rms_norm on the kernel path with its backward kernel."""

    @staticmethod
    def forward(ctx, x, weight, residual, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, weight, residual)
        return _rmsnorm.rms_norm(x, weight, residual, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, residual = ctx.saved_tensors
        dx, dw = _rmsnorm.rms_norm_bwd(x, weight, residual, dy.contiguous(),
                                       eps=ctx.eps)
        return dx, dw, (None if residual is None else dx), None


class _Attention(torch.autograd.Function):
    """Flash attention on the kernel path with its backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        out, lse = _flash.flash_attention(q, k, v, causal=causal,
                                          window=window, q_offset=q_offset,
                                          scale=scale, return_lse=True)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset,
                        scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if not _flash.tma_ready(dout):
            dout = dout.contiguous()
        dq, dk, dv = _flash.flash_attention_bwd(q, k, v, out, lse, dout,
                                                **ctx.mask)
        return dq, dk, dv, None, None, None, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             residual: Optional[torch.Tensor] = None, *, eps: float = 1e-6,
             use_kernels: Optional[bool] = None) -> torch.Tensor:
    """(x [+ residual]) * rsqrt(mean((x [+ residual])^2) + eps) * weight
    over the last dim, in float32, returned in x.dtype."""
    if _use_kernel(x, use_kernels):
        if _needs_grad(x, weight, residual):
            return _RmsNorm.apply(x, weight, residual, eps)
        return _rmsnorm.rms_norm(x, weight, residual, eps=eps)
    return ref.rms_norm_ref(x, weight, residual, eps=eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, scale: Optional[float] = None,
              use_kernels: Optional[bool] = None) -> torch.Tensor:
    """GQA attention, q: (B, H, Sq, D), k, v: (B, Hkv, Sk, D) -> (B, H, Sq,
    D).  The plain path takes the JAX package's route: the query-blocked
    ``attention_blocked_ref`` when Sq >= 1024 and Sq * Sk > 2048 * 4096
    (it never holds the (Sq, Sk) scores), else ``attention_ref``.  On the
    kernel path a head dim that the backward kernels do not take raises
    when a gradient is asked for, before any launch."""
    if _use_kernel(q, use_kernels):
        if _needs_grad(q, k, v):
            _flash.check_bwd_head_dim(q.shape[-1])
            return _Attention.apply(q, k, v, causal, window, q_offset, scale)
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, scale=scale)
    Sq, Sk = q.shape[2], k.shape[2]
    if Sq * Sk > 2048 * 4096 and Sq >= 1024:
        return ref.attention_blocked_ref(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         scale=scale)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
