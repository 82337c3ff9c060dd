"""Continuous-batching solve engine over a lane-batched ``BatchedSolverState``.

The slot model (after JetStream's decode slots): the engine owns ONE
lane-batched state of B slots and repeatedly applies the same
``AdaptiveStepper`` attempt the offline lane-batched driver runs, in its
in-place form (``advance_in_place``): each attempt writes t, x, h and the
counters into the engine's slot tensors, and the checkpoint buffers take
their rows in place, so the slot state keeps its storage across steps (the
counterpart of the JAX package's donated executables).  A slot is either
OCCUPIED (a request mid-solve; its lane is live controller state) or FREE
(an inactive lane: ``t0 == t1`` makes it fail ``lanes_active``, so the
attempt passes it through untouched at the cost of one wasted lane of each
f evaluation and combine).

Requests are heterogeneous: each carries its own x0, [t0, t1] horizon, and
rtol/atol.  Tolerances ride the state as per-lane tensors (``rtol``/
``atol``, tolerances as data), cast per leaf in the error norm, so each
lane's accept/reject decisions are those of a single solve at its
tolerances.

Insertion and eviction happen at step boundaries, against the RUNNING
state: ``_insert`` rewrites one lane (clock, state, a fresh h carry, zeroed
counters and checkpoint column, tolerances) by fills and one copy on the
device, while every other lane's mid-flight controller state is untouched.
``_evict`` reads the lanes' liveness and counters in ONE device-to-host
read per sweep, copies each finished lane's final state (on the device) and
marks the slot free on the host; the lane itself is already self-masking.

On a mesh (``EngineConfig(mesh=)``), SPMD: every rank runs the same engine
on the same request stream, and holds its block of B / n lanes of the slot
state (n lane shards over the mesh's data axes, ``parallel.lane_axes``);
``resident_state`` presents it as DTensors on the lane axis (axis 1 for the
step-major checkpoint buffers).  A slot keeps its (shard, local lane) for
life: growth adds B' / n - B / n lanes to every rank's block, so no lane
ever moves between ranks.  Which slot takes which request is host logic
every rank computes alike.  The attempt is rank-local; an eviction sweep
makes ONE collective (an all_gather of every rank's liveness and counter
table, so every rank sees every lane), and a sweep that harvests makes one
more (an all_gather of the lanes' final states, so every rank returns the
same results): at most 2 collectives per engine step, 1 when nothing
finishes, counted in ``parallel.comm.COUNTS``.  With one shard the slot
order is the no-mesh engine's and so are the results, bit for bit.

Bucketing: the engine starts at the smallest configured bucket and GROWS
through ``EngineConfig.buckets`` as concurrent demand (occupied + queued)
rises.  Each bucket's attempt runs once at construction on a blank state
(kernels loaded, ``torch.func``'s caches built), so growth at a step
boundary is a pad, not a first-call stall.  The engine never shrinks.

The engine computes no gradient: it holds its params detached and steps
under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.rk import rk_solve_adaptive
from repro_torch.core.stepper import (AdaptiveConfig, AdaptiveStepper,
                                      BatchedSolverState)
from repro_torch.core.tableau import ButcherTableau

Pytree = Any


class Request(NamedTuple):
    """One trajectory to solve: its own state, horizon, and tolerances."""
    x0: Pytree
    t0: float
    t1: float
    rtol: float
    atol: float


class Result(NamedTuple):
    """Harvested per-request outcome: host scalars, and the final state on
    the engine's device."""
    x_final: Pytree
    succeeded: bool
    n_accepted: int
    n_fevals: int
    n_attempts: int
    submitted_at: float      # perf_counter stamps; latency = completed -
    completed_at: float      # submitted (includes queue wait — serving time)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    buckets: tuple = (4, 8, 16)   # the lane counts the slot state takes
    check_every: int = 1          # attempts between eviction sweeps
    mesh: Any = None              # lane sharding over a device mesh

    def __post_init__(self):
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be strictly increasing, got "
                             f"{self.buckets}")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.mesh is not None:
            from ..parallel.solve import lane_axes, shard_count
            axes = lane_axes(self.mesh, self.buckets[0], require=True)
            n = shard_count(self.mesh, axes)
            bad = [B for B in self.buckets if B % n]
            if bad:
                raise ValueError(
                    f"EngineConfig.mesh shards lanes {n}-way over axes "
                    f"{axes}, but bucket(s) {bad} are not divisible by {n}:"
                    " every bucket's slot state must fill whole lane "
                    "shards")


def params_from_checkpoint(directory: str, like: Pytree,
                           step: Optional[int] = None, shardings=None):
    """Load the params leaf out of a TRAINING checkpoint (the full
    ``train.TrainState`` saved by ``runtime.Checkpointer``).

    ``like`` must be a state with the same tree structure as what training
    saved, e.g. ``train.init_train_state`` with the training arch and
    config (its values are overwritten; dtypes and devices are kept).
    Returns ``(params, step)``: the train -> serve handoff.  A mismatched
    template raises ``ValueError`` (shape-contract mismatch).
    ``shardings`` (``runtime.mesh_shardings``) lays the restored leaves out
    on a mesh."""
    from ..runtime import Checkpointer
    state, step = Checkpointer(directory).restore(like, step=step,
                                                  shardings=shardings)
    return state["params"], step


def _detached(tree: Pytree) -> Pytree:
    """Detached leaves; a DTensor leaf (replicated params) as its local
    tensor, which is what a rank computes with."""
    from torch.distributed.tensor import DTensor

    def one(l):
        if isinstance(l, DTensor):
            l = l.to_local()
        return l.detach() if isinstance(l, torch.Tensor) else l

    return pytree.tree_map(one, tree)


def _pack_rows(tree: Pytree, B: int) -> torch.Tensor:
    """(B, bytes) uint8: each lane's leaves, their bytes side by side."""
    return torch.cat([l.reshape(B, -1).contiguous().view(torch.uint8)
                      for l in pytree.tree_leaves(tree)], 1)


def _unpack_row(row: torch.Tensor, like: Pytree) -> Pytree:
    """One lane's leaves out of a ``_pack_rows`` row (shapes and dtypes of
    the per-lane template ``like``)."""
    leaves, spec = pytree.tree_flatten(like)
    out, off = [], 0
    for l in leaves:
        nb = l.numel() * l.element_size()
        out.append(row[off:off + nb].clone().view(l.dtype).reshape(l.shape))
        off += nb
    return pytree.tree_unflatten(out, spec)


class SolveEngine:
    """Continuous-batching adaptive-solve server.

    ``submit`` enqueues requests; ``run`` drives the slot state until the
    queue and every occupied lane drain, returning {request_id: Result}.
    ``step`` exposes one fill -> attempt -> evict boundary for tests and
    incremental driving.  All requests must share the template's state
    pytree structure and shapes; values, horizons, and tolerances are free
    per request.  The slot state lives on the template's device and in its
    dtypes.
    """

    def __init__(self, f, tab: ButcherTableau, cfg: AdaptiveConfig, params,
                 x0_template: Pytree, engine_cfg: EngineConfig = None,
                 combine_backend: str = "auto"):
        self.stepper = AdaptiveStepper(f, tab, cfg, combine_backend)
        self.cfg = cfg
        self.engine_cfg = engine_cfg or EngineConfig()
        self.params = _detached(params)
        self._template = pytree.tree_map(torch.zeros_like,
                                         _detached(x0_template))
        self._treedef = pytree.tree_structure(self._template)
        self._queue: deque = deque()
        self._pending_meta: Dict[int, float] = {}
        self._next_rid = 0
        self._steps_total = 0
        self._inserted_while_running = 0
        self._buckets = tuple(self.engine_cfg.buckets)
        self._mesh = mesh = self.engine_cfg.mesh
        self._n_shards, self._shard = 1, 0
        if mesh is not None:
            from ..parallel.layout import axes_group, block_index
            from ..parallel.solve import lane_axes, shard_count
            self._axes = lane_axes(mesh, self._buckets[0], require=True)
            self._n_shards = shard_count(mesh, self._axes)
            self._shard = block_index(mesh, self._axes)
            self._group, self._order, _ = axes_group(mesh, self._axes)
        for B in self._buckets:
            self.stepper.advance_in_place(self._blank_state(self._local(B)),
                                          self.params)
        B0 = self._buckets[0]
        self._state = self._blank_state(self._local(B0))
        self._lane_rid: List[Optional[int]] = [None] * B0
        # slot -> (lane shard, lane in that shard's block), fixed for life
        self._slot = [(s, j) for s in range(self._n_shards)
                      for j in range(self._local(B0))]
        self.restored_step: Optional[int] = None

    @classmethod
    def from_checkpoint(cls, f, tab: ButcherTableau, cfg: AdaptiveConfig,
                        directory: str, like: Pytree, x0_template: Pytree,
                        engine_cfg: EngineConfig = None,
                        combine_backend: str = "auto",
                        step: Optional[int] = None,
                        shardings=None) -> "SolveEngine":
        """Boot an engine from a TRAINING checkpoint: the params leaf of the
        ``train.TrainState`` saved by ``launch.train`` becomes the field
        parameters (``like`` supplies the saved tree structure, see
        ``params_from_checkpoint``; ``shardings`` lays the restored state out
        on a mesh); ``restored_step`` records the step."""
        params, step = params_from_checkpoint(directory, like, step,
                                              shardings)
        engine = cls(f, tab, cfg, params, x0_template, engine_cfg,
                     combine_backend)
        engine.restored_step = step
        return engine

    # -- slot-state construction / resizing ---------------------------------
    def _local(self, B: int) -> int:
        """Lanes of this rank's block of a B-lane slot state."""
        return B // self._n_shards

    def _blank_state(self, B: int) -> BatchedSolverState:
        """All-free state: t0 == t1 == 0 makes every lane inactive, so an
        attempt is the identity on it until something is inserted."""
        x0 = pytree.tree_map(
            lambda l: torch.zeros((B,) + tuple(l.shape), dtype=l.dtype,
                                  device=l.device), self._template)
        return self.stepper.init_state(x0, 0.0, 0.0, lanes=B,
                                       rtol=self.cfg.rtol, atol=self.cfg.atol)

    def _grow(self, new_B: int) -> None:
        old, new = self._local(self._lanes), self._local(new_B)
        s, b = self._state, self._blank_state(new - old)

        def pad0(l, r):
            return torch.cat([l, r], 0)

        def pad1(l, r):
            return torch.cat([l, r], 1)

        self._state = s._replace(
            t0=pad0(s.t0, b.t0), t1=pad0(s.t1, b.t1), t=pad0(s.t, b.t),
            x=pytree.tree_map(pad0, s.x, b.x), h=pad0(s.h, b.h),
            n_accepted=pad0(s.n_accepted, b.n_accepted),
            n_attempts=pad0(s.n_attempts, b.n_attempts),
            n_fevals=pad0(s.n_fevals, b.n_fevals),
            xs=pytree.tree_map(pad1, s.xs, b.xs),
            ts=pad1(s.ts, b.ts), hs=pad1(s.hs, b.hs),
            lanes=pad0(s.lanes, b.lanes + old),
            live=pad0(s.live, b.live),
            rtol=pad0(s.rtol, b.rtol), atol=pad0(s.atol, b.atol))
        self._lane_rid.extend([None] * (new_B - self._lanes))
        self._slot.extend((sh, j) for sh in range(self._n_shards)
                          for j in range(old, new))

    @property
    def _lanes(self) -> int:
        return len(self._lane_rid)

    @property
    def resident_state(self) -> BatchedSolverState:
        """The slot state: on a mesh, every rank's block as DTensors (no
        copy, no communication): per-lane fields on axis 0, the step-major
        checkpoint buffers on axis 1.  Without a mesh, the local state."""
        s = self._state
        if self._mesh is None:
            return s
        from ..parallel.layout import from_local
        from ..parallel.solve import lane_spec
        lane = lane_spec(self._mesh, self._axes)
        step = lane_spec(self._mesh, self._axes, lane_axis=1)

        def put(name, v):
            if v is None or isinstance(v, bool):
                return v
            place = step if name in ("xs", "ts", "hs") else lane
            return pytree.tree_map(lambda l: from_local(l, self._mesh,
                                                        place), v)

        return s._replace(**{n: put(n, getattr(s, n)) for n in s._fields})

    # -- lane insert / harvest ------------------------------------------------
    def _insert(self, slot: int, req: Request) -> None:
        """Rewrite ONE lane of the running state for a fresh request: clock
        at t0, fresh h carry (sign(t1 - t0) * initial_step, the seed a
        single solve with h0=None uses, rounded as there), zeroed counters
        and checkpoint column, its tolerances.  Fills and one device copy;
        every other lane is untouched.  On a mesh only the rank that holds
        the slot's lane writes."""
        shard, lane = self._slot[slot]
        if shard != self._shard:
            return
        s = self._state
        np_dt = torch.empty((), dtype=s.t.dtype).numpy().dtype.type
        t0, t1 = np_dt(req.t0), np_dt(req.t1)
        h = np.sign(t1 - t0) * np_dt(self.cfg.initial_step)
        for buf, v in ((s.t0, t0), (s.t1, t1), (s.t, t0), (s.h, h),
                       (s.rtol, req.rtol), (s.atol, req.atol)):
            buf[lane].fill_(float(v))
        for buf in (s.n_accepted, s.n_attempts, s.n_fevals):
            buf[lane].fill_(0)
        for buf, v in zip(pytree.tree_leaves(s.x),
                          pytree.tree_leaves(req.x0)):
            buf[lane].copy_(v)
        for buf in pytree.tree_leaves(s.xs) + [s.ts, s.hs]:
            buf[:, lane].zero_()

    def _harvest(self, slot: int, table, rows):
        """Slot ``slot``'s final state (a copy, on the device) and its
        (succeeded, n_accepted, n_fevals, n_attempts) from the sweep's
        host table; on a mesh its state comes out of the gathered ``rows``
        (``_pack_rows`` of every rank's block, in block order)."""
        _, ok, n_acc, n_fe, n_try = (row[slot] for row in table)
        shard, lane = self._slot[slot]
        if rows is None:
            x = pytree.tree_map(lambda l: l[lane].clone(), self._state.x)
        else:
            x = _unpack_row(rows[shard][lane], self._template)
        return x, bool(ok), n_acc, n_fe, n_try

    # -- public API ---------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Queue a request; its x0 goes to the engine's device and dtypes
        here, so the step boundary copies on the device only."""
        if pytree.tree_structure(request.x0) != self._treedef:
            raise ValueError("request x0 pytree structure does not match "
                             "the engine's template")
        x0 = pytree.tree_map(
            lambda v, l: torch.as_tensor(v, dtype=l.dtype, device=l.device),
            request.x0, self._template)
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, request._replace(x0=x0),
                            time.perf_counter()))
        return rid

    @property
    def occupancy(self) -> int:
        return sum(rid is not None for rid in self._lane_rid)

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _fill(self) -> None:
        demand = self.occupancy + len(self._queue)
        target = self._lanes
        for B in self._buckets:
            if B >= min(demand, self._buckets[-1]):
                target = max(self._lanes, B)
                break
        if target > self._lanes:
            self._grow(target)
        running = self.occupancy > 0
        inserted = False
        for lane in range(self._lanes):
            if not self._queue:
                break
            if self._lane_rid[lane] is not None:
                continue
            rid, req, t_sub = self._queue.popleft()
            self._insert(lane, req)
            self._lane_rid[lane] = rid
            self._pending_meta[rid] = t_sub
            if running:
                self._inserted_while_running += 1
            running = inserted = True
        if inserted:
            self._state.live.copy_(self.stepper.lanes_active(self._state))

    def _evict(self, results: Dict[int, Result]) -> None:
        """Harvest every occupied lane that is no longer live.  The sweep's
        one device-to-host read: liveness, success and the three counters
        of every lane."""
        s = self._state
        table = torch.stack([s.live.int(), self.stepper.succeeded(s).int(),
                             s.n_accepted, s.n_fevals, s.n_attempts])
        if self._mesh is not None:
            # every rank's table, in block order: the sweep's collective
            from ..parallel import comm
            parts = comm.all_gather(table, self._group)
            table = torch.stack([parts[g] for g in self._order])
        now = time.perf_counter()
        table = table.cpu().tolist()
        if self._mesh is not None:    # (shard, row, lane) -> (row, slot)
            table = [[table[sh][r][j] for sh, j in self._slot]
                     for r in range(5)]
        done = [slot for slot, rid in enumerate(self._lane_rid)
                if rid is not None and not table[0][slot]]
        rows = None
        if done and self._mesh is not None:
            # the harvested lanes' final states reach every rank
            from ..parallel import comm
            parts = comm.all_gather(
                _pack_rows(s.x, self._local(self._lanes)), self._group)
            rows = [parts[g] for g in self._order]
        for slot in done:
            rid = self._lane_rid[slot]
            results[rid] = Result(*self._harvest(slot, table, rows),
                                  self._pending_meta.pop(rid), now)
            self._lane_rid[slot] = None

    def step(self, results: Dict[int, Result]) -> None:
        """One step boundary: fill free lanes, one in-place attempt over the
        whole slot state, evict finished lanes (every ``check_every``
        boundaries)."""
        with torch.no_grad():
            self._fill()
            self.stepper.advance_in_place(self._state, self.params)
            self._steps_total += 1
            if self._steps_total % self.engine_cfg.check_every == 0:
                self._evict(results)

    def run(self, requests=None) -> Dict[int, Result]:
        """Drain the queue (plus ``requests``, submitted first): returns
        {request_id: Result} once every lane is free again."""
        for r in requests or []:
            self.submit(r)
        results: Dict[int, Result] = {}
        while self._queue or self.occupancy:
            self.step(results)
        return results

    @property
    def stats(self) -> Dict[str, int]:
        return {"steps_total": self._steps_total,
                "lanes": self._lanes,
                "inserted_while_running": self._inserted_while_running}


def serve_timed(engine: SolveEngine, requests,
                arrivals=None) -> Dict[int, Result]:
    """Drive ``engine`` over ``requests`` with optional arrival pacing.

    ``arrivals`` is a monotone array of offsets in seconds from the start
    (``poisson_arrivals``): each request is submitted once its arrival time
    has passed, so reported latencies include real queue wait under the
    offered load.  ``arrivals=None`` submits everything up front (drain
    mode — equivalent to ``engine.run(requests)``).
    """
    if arrivals is None:
        return engine.run(requests)
    if len(arrivals) != len(requests):
        raise ValueError("one arrival time per request required")
    results: Dict[int, Result] = {}
    start = time.perf_counter()
    i = 0
    while i < len(requests) or engine.pending or engine.occupancy:
        now = time.perf_counter() - start
        while i < len(requests) and arrivals[i] <= now:
            engine.submit(requests[i])
            i += 1
        if engine.pending or engine.occupancy:
            engine.step(results)
        else:                       # idle: nothing in flight, wait it out
            time.sleep(min(float(arrivals[i]) - now, 0.01))
    return results


def naive_sequential_solve(f, tab, cfg: AdaptiveConfig, params, requests,
                           combine_backend: str = "auto",
                           warmup: bool = True):
    """The no-batching baseline: one single-trajectory adaptive solve per
    request, sequentially, at the request's tolerances as the config's
    Python floats (the offline drivers' path), with no gradient.
    ``warmup`` (default) runs every request once untimed first, so the
    reported numbers measure steady-state solving, not kernel loads.
    Returns (solutions, per-request wall seconds, each ending in a
    device synchronisation)."""
    params = _detached(params)

    def solve(req):
        c = dataclasses.replace(cfg, rtol=float(req.rtol),
                                atol=float(req.atol))
        return rk_solve_adaptive(f, tab, req.x0, req.t0, req.t1, params, c,
                                 combine_backend)

    def sync(sol):
        for leaf in pytree.tree_leaves(sol.x_final):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)

    with torch.no_grad():
        if warmup:
            for req in requests:
                sync(solve(req))
        results, lat = [], []
        for req in requests:
            t0 = time.perf_counter()
            sol = solve(req)
            sync(sol)
            lat.append(time.perf_counter() - t0)
            results.append(sol)
    return results, lat
