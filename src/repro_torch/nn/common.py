"""Shared helpers: initializers.

Each draws in float32 from ``generator`` on the generator's own device and
casts to ``dtype`` on ``device``: a CPU generator gives the same weights on
every device; a CUDA generator draws full-width weights on the card
without a host round trip (different numbers from the same seed).  With no
generator they draw on ``device`` itself: the ``meta`` device's shapes
(``models.lm.init_lm(..., device="meta")``, the dryrun's state bytes).
"""
from __future__ import annotations

import math

import torch


def _draw_device(generator, device):
    return device if generator is None else generator.device


def dense_init(shape, dtype: torch.dtype, generator: torch.Generator,
               device="cuda", in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1/fan_in) cut at two standard
    deviations."""
    fan_in = shape[in_axis]
    std = fan_in ** -0.5
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=_draw_device(generator, device))
    z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    return (z.clamp(-2.0, 2.0) * std).to(device=device, dtype=dtype)


def embed_init(shape, dtype: torch.dtype, generator: torch.Generator,
               device="cuda") -> torch.Tensor:
    """Embedding init: N(0, 0.02^2)."""
    z = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=_draw_device(generator, device))
    return (z * 0.02).to(device=device, dtype=dtype)
