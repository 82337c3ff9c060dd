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
