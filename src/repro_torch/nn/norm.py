"""RMSNorm (kernel-dispatched).  LayerNorm comes with the enc-dec model
(ROADMAP queue 1, item 13)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops


def init_rmsnorm(d: int, dtype: torch.dtype = torch.float32, device="cuda"):
    return {"w": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x: torch.Tensor, *, eps: float = 1e-6,
            use_kernels: Optional[bool] = None) -> torch.Tensor:
    return kops.rms_norm(x, p["w"], eps=eps, use_kernels=use_kernels)
