"""Synthetic heterogeneous request streams for the serve engine.

Requests vary in everything a real client would vary: initial state,
horizon length (which drives the number of accepted steps), and solve
tolerances — the heterogeneity is the point, because it is exactly what
defeats lockstep offline batching (every trajectory in a fixed batch waits
for the stiffest lane AND the longest horizon) and what the masked slot
model absorbs.  Host-side numpy randomness, with the JAX package's draws:
one seed gives the same requests in both packages.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .engine import Request


def synthetic_stream(n_requests: int, dim: int, seed: int = 0,
                     t1_range=(0.5, 2.0),
                     tol_choices: Sequence[tuple] = ((1e-4, 1e-6),
                                                     (1e-5, 1e-7),
                                                     (1e-6, 1e-8)),
                     dtype: torch.dtype = torch.float32,
                     device="cuda") -> List[Request]:
    """A heterogeneous stream of (dim,)-vector requests: unit-ball initial
    states, horizons uniform in ``t1_range``, tolerances drawn from
    ``tol_choices``; x0 in ``dtype`` on ``device``."""
    rng = np.random.RandomState(seed)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    reqs = []
    for _ in range(n_requests):
        x0 = rng.randn(dim).astype(np_dtype)
        x0 = x0 / max(1.0, float(np.linalg.norm(x0)))
        t1 = float(rng.uniform(*t1_range))
        rtol, atol = tol_choices[rng.randint(len(tol_choices))]
        reqs.append(Request(x0=torch.as_tensor(x0, dtype=dtype,
                                               device=device),
                            t0=0.0, t1=t1, rtol=float(rtol),
                            atol=float(atol)))
    return reqs


def poisson_arrivals(n_requests: int, rate_per_s: float,
                     seed: int = 0) -> np.ndarray:
    """Cumulative arrival times (seconds) of a Poisson stream at
    ``rate_per_s`` — the offered-load axis of the serve benchmark."""
    rng = np.random.RandomState(seed + 1)
    gaps = rng.exponential(1.0 / rate_per_s, size=n_requests)
    return np.cumsum(gaps)


def latency_summary(results) -> dict:
    """p50/p99/mean serving latency (ms) over a {rid: Result} map — latency
    is completion minus submission, so queue wait counts."""
    lats = np.array([r.completed_at - r.submitted_at
                     for r in results.values()])
    return {"p50_ms": float(np.percentile(lats, 50) * 1e3),
            "p99_ms": float(np.percentile(lats, 99) * 1e3),
            "mean_ms": float(lats.mean() * 1e3)}
