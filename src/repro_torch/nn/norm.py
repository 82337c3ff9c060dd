"""RMSNorm (kernel-dispatched) and LayerNorm (plain torch ops: the JAX
package has no kernel for it)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops


def init_rmsnorm(d: int, dtype: torch.dtype = torch.float32, device="cuda"):
    return {"w": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, *, eps: float = 1e-6,
            use_kernels: Optional[bool] = None) -> torch.Tensor:
    return kops.rms_norm(x, p["w"], eps=eps, use_kernels=use_kernels)


def init_layernorm(d: int, dtype: torch.dtype = torch.float32,
                   device="cuda"):
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * w + b over the last axis, computed in
    float32 (the population variance), returned in x's dtype."""
    f32 = torch.float32
    xf = x.to(f32)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps))
    return (out * p["w"].to(f32) + p["b"].to(f32)).to(x.dtype)


def layernorm_split(p, x: torch.Tensor, tp, *, eps: float = 1e-5):
    """``layernorm`` over a last axis split over "model" (``tp``, a
    ``parallel.tensor.TensorParallel``): ``x`` holds the rank's block of
    it, ``p`` the whole weight and bias.  The mean and the population
    variance take their row sums over every block (two all_reduces, each
    with an all_reduce of its gradient: ``TensorParallel.summed``), in the
    plain version's two passes; the rank's block of the output."""
    f32 = torch.float32
    n = x.shape[-1]
    total = n * tp.size
    lo = tp.rank * n
    xf = x.to(f32)
    mu = tp.summed(xf.sum(-1, keepdim=True)) / total
    dx = xf - mu
    var = tp.summed((dx * dx).sum(-1, keepdim=True)) / total
    out = dx * torch.reciprocal(torch.sqrt(var + eps))
    return (out * p["w"][lo:lo + n].to(f32)
            + p["b"][lo:lo + n].to(f32)).to(x.dtype)
