"""Rotary position embeddings (full and partial).

Angles, cos and sin are float32 whatever the input dtype, as in the JAX
package; the rotation runs in promote(x.dtype, float32): float32 for
float32 and 16-bit inputs (the JAX package's arithmetic), float64 for a
float64 input, so that its gradient is not rounded to float32 (the float64
exactness checks of node mode rest on that); there the result differs from
the JAX package's by float32 rounding."""
from __future__ import annotations

from typing import Optional

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               rotary_dim: Optional[int] = None, device="cpu") -> torch.Tensor:
    rd = rotary_dim if rotary_dim is not None else head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32, device=device) / rd
    return 1.0 / (theta ** exps)  # (rd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freqs: torch.Tensor,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """x: (B, H, S, D); positions: (S,) or (B, S) absolute positions."""
    D = x.shape[-1]
    rd = rotary_dim if rotary_dim is not None else D
    pos = positions.to(torch.float32)
    if positions.ndim == 1:
        ang = (pos[:, None] * inv_freqs[None, :])[None, None]  # (1,1,S,rd/2)
    else:
        ang = pos[:, None, :, None] * inv_freqs[None, None, None, :]
    acc = torch.promote_types(x.dtype, torch.float32)
    cos, sin = torch.cos(ang).to(acc), torch.sin(ang).to(acc)
    xr = x[..., :rd].to(acc)
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    rot = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    if rd < D:
        rot = torch.cat([rot, x[..., rd:].to(acc)], dim=-1)
    return rot.to(x.dtype)
