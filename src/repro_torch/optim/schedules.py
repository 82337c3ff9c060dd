"""LR schedules: constant, cosine and WSD (Warmup-Stable-Decay, MiniCPM);
the JAX package's ``repro.optim.schedules``.  Each returns fn(step) ->
0-dim float32 tensor on the step's device; ``step`` is an integer tensor
(the optimizer's step counter) or a Python int."""
from __future__ import annotations

import math

import torch


def _as_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def constant_schedule(lr: float):
    def fn(step):
        s = _as_f32(step)
        return torch.full((), lr, dtype=torch.float32, device=s.device)
    return fn


def cosine_schedule(lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    def fn(step):
        s = _as_f32(step)
        warm = lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * \
            0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return fn


def wsd_schedule(lr: float, warmup: int, stable: int, decay: int,
                 final_frac: float = 0.01):
    """MiniCPM's Warmup-Stable-Decay: linear warmup, flat plateau, then
    exponential-style decay over ``decay`` steps."""
    def fn(step):
        s = _as_f32(step)
        warm = lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup - stable) / max(decay, 1), 0.0, 1.0)
        dec = lr * torch.pow(torch.tensor(final_frac, dtype=torch.float32,
                                          device=s.device), prog)
        flat = torch.full((), lr, dtype=torch.float32, device=s.device)
        return torch.where(s < warmup, warm,
                           torch.where(s < warmup + stable, flat, dec))
    return fn
