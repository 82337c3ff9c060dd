"""Rotary position embeddings (full and partial), in float32 whatever the
input dtype, as in the JAX package."""
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
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :rd].to(torch.float32)
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    rot = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    if rd < D:
        rot = torch.cat([rot, x[..., rd:].to(torch.float32)], dim=-1)
    return rot.to(x.dtype)
