"""Continuous-batching ODE solve serving (the JetStream slot model).

``SolveEngine`` drives the same lane-batched ``AdaptiveStepper`` attempt
as the offline drivers over a masked ``BatchedSolverState``, in place:
requests are inserted into free lanes of the RUNNING state at step
boundaries, finished lanes are harvested and freed, and the state grows
through lane buckets as offered load rises.  ``params_from_jax`` takes the
JAX package's params as numpy arrays (e.g. the ode launcher's w1, b1, w2,
b2) into tensors.
"""
from repro_torch.models.cnf import params_from_jax

from .engine import (EngineConfig, Request, Result, SolveEngine,
                     naive_sequential_solve, params_from_checkpoint,
                     serve_timed)
from .stream import latency_summary, poisson_arrivals, synthetic_stream

__all__ = [
    "EngineConfig", "Request", "Result", "SolveEngine",
    "naive_sequential_solve", "params_from_checkpoint", "serve_timed",
    "synthetic_stream", "poisson_arrivals", "latency_summary",
]
