"""Probe-case enumeration: every legal solve configuration, as recorded runs
(the JAX package's ``repro.analysis.cases``).

The case list is ENUMERATED from ``GRADIENT_REGISTRY``, the same
``capabilities`` / ``batched_cells()`` frozensets ``solve`` enforces, so a
newly registered strategy (or a capability change) is analysed
automatically.  Its keys are the JAX package's.

Each case runs a small tanh-MLP solve in float64 (so any hardcoded
narrower dtype shows as a demotion) under an ``OpRecorder``: a ``value``
run always, and a ``grad`` run (one loss and its gradient) where the cell
is reverse-differentiable: every fixed cell, and the adaptive cells of the
custom-gradient strategies (symplectic, adjoint).  DirectBackprop's
adaptive cells are differentiable in the port too, but stay value-only
here as in the JAX package, whose reverse mode cannot cross the while
loop; dense output is value-only.

Eager code has no abstract trace, so the probes run for real, on inputs
drawn from a seeded ``torch.Generator`` on the CPU and moved to the device
(the same numbers on every device).  Zero inputs would let an adaptive
controller take trivial steps.  ``PROBE_SEED`` is chosen so that every
adaptive probe succeeds (``case_records(...)["succeeded"]``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import socket
from typing import Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import AdaptiveConfig, SaveAt, solve
from repro_torch.core.api import GRADIENT_REGISTRY
from .traversal import OpCounter, count_ops, record

__all__ = ["Case", "enumerate_cases", "case_records", "case_op_counts",
           "mlp_field",
           "make_probe", "mlp_params", "CUSTOM_VJP_STRATEGIES",
           "engine_advance_probe", "sharded_solve_probe",
           "SHARDED_PROBE_CELLS", "PROBE_SEED", "OBS_SPACING",
           "observation_times", "world_of_one"]

# strategies whose adaptive drivers are custom autograd Functions (the
# reverse-differentiable adaptive cells of the JAX package)
CUSTOM_VJP_STRATEGIES = frozenset({"symplectic", "adjoint"})

PROBE_SEED = 0
# SaveAt(ts) probes observe at OBS_SPACING * (1, ..., n_obs), so the step grid
# of n observations is a prefix of the grid of 2n (the per-observation
# flatness rule compares them); dense output observes linspace(1/n, 1, n),
# one solve to 1 whose grid does not depend on n.  At 4 observations both
# are the JAX probe's linspace(1/4, 1, 4).
OBS_SPACING = 0.25


def observation_times(dense: bool, n_obs: int, dtype=torch.float64,
                      device="cuda") -> torch.Tensor:
    """The probes' observation times (see ``OBS_SPACING``)."""
    k = torch.arange(1, n_obs + 1, dtype=dtype, device=device)
    return k / n_obs if dense else OBS_SPACING * k


@dataclasses.dataclass(frozen=True)
class Case:
    """One (strategy, stepping, saveat, batched, method) probe cell."""
    strategy: str
    stepping: str                 # "fixed" | "adaptive"
    saveat: str                   # "t1" | "ts" | "dense"
    batched: bool
    method: str = "dopri5"

    @property
    def key(self) -> str:
        mode = "batched" if self.batched else "single"
        return "/".join([self.strategy, self.method, self.stepping,
                         self.saveat, mode])

    @property
    def differentiable(self) -> bool:
        """Reverse mode probed for this cell (the JAX package's cells)."""
        if self.saveat == "dense":
            return False
        return self.stepping == "fixed" \
            or self.strategy in CUSTOM_VJP_STRATEGIES


def enumerate_cases(methods: Tuple[str, ...] = ("dopri5",)):
    """Every legal cell of every registered strategy, single and batched."""
    cases = []
    for name in sorted(GRADIENT_REGISTRY):
        cls = GRADIENT_REGISTRY[name]
        for method in methods:
            for sk, vk in sorted(cls.capabilities):
                cases.append(Case(name, sk, vk, False, method))
            for sk, vk in sorted(cls.batched_cells()):
                cases.append(Case(name, sk, vk, True, method))
    return cases


def mlp_field(x, t, params):
    """Tiny tanh-MLP vector field f(x, t, params); dim-generic, so it serves
    (dim,) and (B, dim) states."""
    h = torch.tanh(x @ params["w1"] + params["b1"] + t * params["bt"])
    return h @ params["w2"] + params["b2"]


def mlp_params(dim: int, hidden: int, *, dtype=torch.float64, device="cuda",
               seed: int = PROBE_SEED, x_shape=None):
    """(x0, params) of ``mlp_field`` from ``seed``: weights N(0, 1/fan_in)
    scaled by 0.5, biases N(0, 0.01), x0 N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64)
                * scale).to(dtype=dtype, device=device)
    params = {"w1": draw(dim, hidden, scale=0.5 * dim ** -0.5),
              "b1": draw(hidden, scale=0.1),
              "bt": draw(hidden, scale=0.1),
              "w2": draw(hidden, dim, scale=0.5 * hidden ** -0.5),
              "b2": draw(dim, scale=0.1)}
    x0 = draw(*(x_shape or (dim,)))
    return x0, params


def _loss(ys):
    return sum(torch.sum(torch.sin(l) ** 2) for l in pytree.tree_leaves(ys))


def make_probe(case: Case, *, dim: int = 4, hidden: int = 16,
               batch: int = 3, n_steps: int = 3, max_steps: int = 8,
               n_obs: int = 4, dtype=torch.float64, device="cuda",
               backend: str = "auto", seed: int = PROBE_SEED):
    """(solve_fn, differentiable, (x0, params)) for one case; ``solve_fn``
    returns the ``Solution``."""
    x0, params = mlp_params(dim, hidden, dtype=dtype, device=device,
                            seed=seed,
                            x_shape=(batch, dim) if case.batched else None)
    stepping = n_steps if case.stepping == "fixed" else \
        AdaptiveConfig(max_steps=max_steps)
    if case.saveat == "t1":
        saveat = SaveAt(t1=1.0)
    else:
        dense = case.saveat == "dense"
        saveat = SaveAt(ts=observation_times(dense, n_obs, dtype, device),
                        dense=dense)

    def solve_fn(x0, params):
        return solve(mlp_field, x0, params, saveat=saveat,
                     method=case.method, gradient=case.strategy,
                     stepping=stepping, backend=backend,
                     batch_axis=0 if case.batched else None)
    return solve_fn, case.differentiable, (x0, params)


def _grad_fn(solve_fn, x0, params):
    """(fn, args) of one loss and its gradient; the leaves require grad
    from outside the recorder."""
    x0 = x0.clone().requires_grad_()
    params = pytree.tree_map(lambda l: l.clone().requires_grad_(), params)
    leaves = [x0] + pytree.tree_leaves(params)

    def run(x0, params):
        return torch.autograd.grad(_loss(solve_fn(x0, params).ys), leaves)
    return run, (x0, params)


def case_records(case: Case, **knobs) -> Dict[str, object]:
    """Run one case: {"value": OpRecorder, "grad": OpRecorder | None,
    "succeeded": bool}."""
    solve_fn, differentiable, args = make_probe(case, **knobs)
    sol, rec = record(solve_fn, *args)
    out = {"value": rec, "grad": None,
           "succeeded": bool(torch.all(torch.as_tensor(sol.success)))}
    if differentiable:
        fn, grad_args = _grad_fn(solve_fn, *args)
        out["grad"] = record(fn, *grad_args)[1]
    return out


def case_op_counts(case: Case, **knobs) -> Dict[str, Optional[int]]:
    """``count_ops`` of one case's value and grad runs, counted only (the
    flatness rule's probes): {"value": n, "grad": n | None}."""
    solve_fn, differentiable, args = make_probe(case, **knobs)
    runs = {"value": (solve_fn, args)}
    if differentiable:
        runs["grad"] = _grad_fn(solve_fn, *args)
    out = {"grad": None}
    for kind, (fn, fn_args) in runs.items():
        with OpCounter() as counter:
            fn(*fn_args)
        out[kind] = count_ops(counter)
    return out


def _state_buffers(state) -> Dict[str, Tuple[int, int]]:
    """{field[/i]: (data_ptr, nbytes)} of a lane-batched state's tensors."""
    out = {}
    for name, v in state._asdict().items():
        leaves = pytree.tree_leaves(v)
        for i, l in enumerate(leaves):
            if isinstance(l, torch.Tensor):
                key = name if len(leaves) == 1 else f"{name}/{i}"
                out[key] = (l.untyped_storage().data_ptr(),
                            l.untyped_storage().nbytes())
    return out


def engine_advance_probe(method: str = "dopri5", *, dim: int = 32,
                         hidden: int = 16, lanes: int = 8,
                         max_steps: int = 64, dtype=torch.float64,
                         device="cuda", backend: str = "auto",
                         seed: int = PROBE_SEED):
    """The serve engine's hot entry point: one
    ``AdaptiveStepper.advance_in_place`` over a lane-batched state with
    tolerances as data, sized so the checkpoint buffers ((max_steps + 1,
    lanes, dim) float64, 130 KiB) clear the in-place rule's 64 KiB floor.
    Returns {"rec", "before", "after"} (the state's buffers around the
    attempt) for ``donation_findings(..., severity="error")``."""
    from repro_torch.core.stepper import AdaptiveStepper
    from repro_torch.core.tableau import get_tableau
    x0, params = mlp_params(dim, hidden, dtype=dtype, device=device,
                            seed=seed, x_shape=(lanes, dim))
    cfg = AdaptiveConfig(max_steps=max_steps)
    stepper = AdaptiveStepper(mlp_field, get_tableau(method), cfg,
                              combine_backend=backend)
    state = stepper.init_state(x0, 0.0, 1.0, lanes=lanes, rtol=cfg.rtol,
                               atol=cfg.atol)
    before = _state_buffers(state)
    _, rec = record(stepper.advance_in_place, state, params)
    return {"rec": rec, "before": before, "after": _state_buffers(state)}


# (strategy, stepping) cells audited by the collective-count rule: the
# custom-gradient strategies' mesh-reachable t1 cells (fixed once: the fixed
# grid is strategy-independent at the shard boundary)
SHARDED_PROBE_CELLS = (("symplectic", "adaptive"), ("adjoint", "adaptive"),
                       ("symplectic", "fixed"))


@contextlib.contextmanager
def world_of_one(device_type: str):
    """A lane mesh of 1 over an in-process gloo world of 1 (gloo takes CPU
    and CUDA tensors); an existing world of 1 is reused as it is."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_lane_mesh
    if dist.is_initialized():
        yield make_lane_mesh((1,), device_type=device_type)
        return
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield make_lane_mesh((1,), device_type=device_type)
    finally:
        dist.destroy_process_group()


def sharded_solve_probe(strategy: str, stepping_kind: str,
                        method: str = "dopri5", *, dim: int = 4,
                        hidden: int = 16, batch: int = 3, n_steps: int = 3,
                        max_steps: int = 8, dtype=torch.float64,
                        device="cuda", backend: str = "auto",
                        seed: int = PROBE_SEED):
    """One ``solve(..., batch_axis=0, mesh=)`` cell on a world of 1, for the
    collective-count rule.  Each rank runs the same program whatever the
    world size, so a world of 1 makes the same collectives per rank as N.
    Returns {kind: (recorder, comm counts)} for "value" and "grad", and
    "param_shapes"."""
    from repro_torch.parallel import comm
    x0, params = mlp_params(dim, hidden, dtype=dtype, device=device,
                            seed=seed, x_shape=(batch, dim))
    stepping = n_steps if stepping_kind == "fixed" else \
        AdaptiveConfig(max_steps=max_steps)
    out = {"param_shapes": [tuple(p.shape)
                            for p in pytree.tree_leaves(params)]}
    with world_of_one(torch.device(device).type) as mesh:
        def solve_fn(x0, params):
            sol = solve(mlp_field, x0, params, method=method,
                        gradient=strategy, stepping=stepping,
                        backend=backend, batch_axis=0, mesh=mesh)
            # the lane-sharded ys as this rank's block
            return dataclasses.replace(sol, ys=sol.ys.to_local())

        comm.reset_counts()
        _, rec = record(solve_fn, x0, params)
        out["value"] = (rec, comm.counts())
        comm.reset_counts()
        fn, grad_args = _grad_fn(solve_fn, x0, params)
        _, rec = record(fn, *grad_args)
        out["grad"] = (rec, comm.counts())
    return out

