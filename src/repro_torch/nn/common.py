"""Shared helpers: initializers."""
from __future__ import annotations

import math

import torch


def dense_init(shape, dtype: torch.dtype, generator: torch.Generator,
               device="cuda", in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1/fan_in) cut at two standard
    deviations, drawn in float32 from ``generator`` (a CPU generator, so a
    seed gives the same weights on every device) and cast to ``dtype``."""
    fan_in = shape[in_axis]
    std = fan_in ** -0.5
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    return (z.clamp(-2.0, 2.0) * std).to(device=device, dtype=dtype)
