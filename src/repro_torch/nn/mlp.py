"""SwiGLU MLP (llama-family feed-forward)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init


def init_swiglu(generator: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype = torch.float32, device="cuda"):
    return {
        "wg": dense_init((d_model, d_ff), dtype, generator, device),
        "wu": dense_init((d_model, d_ff), dtype, generator, device),
        "wd": dense_init((d_ff, d_model), dtype, generator, device),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
