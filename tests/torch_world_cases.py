"""What each rank of the mesh tests' gloo worlds runs (``torch_world``).

``mesh_cases`` is the port of ``tests/test_parallel.py``'s multi-device
scripts (solve, grids, saveat, scalar leaf, engine, sharder) on meshes (4,)
and (2, 2) of a 4-rank world (solve and saveat for both adjoints, fixed
and adaptive, on both meshes), float64, at that file's sizes (B 8, dim 4,
hidden 8).  Each rank holds its block of a sharded solve against the port's
own single-process solves: integer stats and success exactly, values within
1e-11 of the full-width batch, its block bitwise the single-process solve
of that block, gradients within 1e-12.  Every rank checks; every rank
records what it saw.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import AdaptiveConfig, SaveAt, get_tableau, solve
from repro_torch.launch.mesh import make_debug_mesh, make_lane_mesh
from repro_torch.parallel import comm, gather
from repro_torch.parallel.layout import block_index
from torch_world import case

B, DIM, HIDDEN = 8, 4, 8
CFG = AdaptiveConfig(rtol=1e-8, atol=1e-10, max_steps=96)
VALUE_ATOL = 1e-11
GRAD_ATOL = 1e-12


def problem():
    rng = np.random.default_rng(0)

    def t(a):
        return torch.tensor(a, dtype=torch.float64)

    params = {"w1": t(rng.standard_normal((DIM, HIDDEN)) * 0.3),
              "b1": t(np.zeros(HIDDEN)),
              "w2": t(rng.standard_normal((HIDDEN, DIM)) * 0.3),
              "b2": t(np.zeros(DIM))}
    # heterogeneous magnitudes -> heterogeneous per-lane accepted grids
    x0 = t(rng.standard_normal((B, DIM))
           * np.linspace(0.5, 3.0, B)[:, None])
    return params, x0


def field(x, t, p):
    h = torch.tanh(x @ p["w1"] + p["b1"] + t)
    return h @ p["w2"] + p["b2"]


def _meshes():
    return [(make_lane_mesh((4,), device_type="cpu"), ("data",)),
            (make_lane_mesh((2, 2), device_type="cpu"), ("pod", "data"))]


def _grads(loss, params, x0):
    leaves = pytree.tree_leaves(params) + [x0]
    return torch.autograd.grad(loss, leaves)


def _live(params, x0):
    return (pytree.tree_map(lambda l: l.clone().requires_grad_(), params),
            x0.clone().requires_grad_())


def _max_abs(a, b):
    return float((a - b).abs().max())


def _check_solve(mesh, axes, grad, stepping, saveat=None):
    params, x0 = problem()
    kw = dict(gradient=grad, stepping=stepping, batch_axis=0)
    if saveat is not None:
        kw["saveat"] = saveat
    ref = solve(field, x0, params, **kw)
    sol = solve(field, x0, params, mesh=mesh, **kw)
    for k in ("n_steps", "n_fevals", "n_attempts"):
        assert torch.equal(gather(sol.stats[k]), ref.stats[k]), k
    assert torch.equal(gather(sol.success), ref.success)
    assert _max_abs(gather(sol.ys), ref.ys) <= VALUE_ATOL
    assert _max_abs(gather(sol.final_state), ref.final_state) <= VALUE_ATOL
    # load metrics: shard totals partition the lane sum
    ss = gather(sol.stats["shard_steps"])
    assert tuple(ss.shape) == (4,), ss.shape
    assert int(ss.sum()) == int(ref.stats["n_steps"].sum())
    assert float(sol.stats["load_imbalance"]) >= 1.0
    # rank-local exactness: this rank's block IS the single-process solve
    per = B // 4
    b = block_index(mesh, axes)
    blk = solve(field, x0[b * per:(b + 1) * per], params, **kw)
    assert torch.equal(blk.ys, sol.ys.to_local())
    for k in ("n_steps", "n_fevals", "n_attempts"):
        assert torch.equal(blk.stats[k], sol.stats[k].to_local()), k
    # gradients: params all-reduced (one all_reduce per leaf, none in the
    # forward), x0's lane-local
    p_ref, x_ref = _live(params, x0)
    g_ref = _grads(torch.sum(torch.sin(
        solve(field, x_ref, p_ref, **kw).ys) ** 2), p_ref, x_ref)
    p_sh, x_sh = _live(params, x0)
    comm.reset_counts()
    sh = solve(field, x_sh, p_sh, mesh=mesh, **kw)
    fwd = comm.counts()
    loss = torch.sum(torch.sin(sh.ys.to_local()) ** 2)
    g_sh = _grads(loss, p_sh, x_sh)
    bwd = comm.counts()
    assert fwd == {}, fwd
    assert bwd == {"all_reduce": len(pytree.tree_leaves(params))}, bwd
    for a, c in zip(g_ref[:-1], g_sh[:-1]):
        assert _max_abs(a, c) <= GRAD_ATOL, (grad, _max_abs(a, c))
    gx, gx_ref = g_sh[-1], g_ref[-1]
    rows = slice(b * per, (b + 1) * per)
    assert _max_abs(gx[rows], gx_ref[rows]) <= GRAD_ATOL
    mask = torch.ones(B, dtype=torch.bool)
    mask[rows] = False
    assert not bool(gx[mask].any())


def _check_grids(mesh, axes):
    """Every field of a sharded batched solution (accepted grids, h carry,
    checkpoint buffers) gathered through ``batched_solution_specs`` is, per
    block, bitwise the single-process solve of that block."""
    from repro_torch.core.rk import rk_solve_adaptive_batched
    from repro_torch.parallel import batched_solution_specs
    from repro_torch.parallel.layout import from_local
    params, x0 = problem()
    tab = get_tableau("dopri5")
    per = B // 4
    b = block_index(mesh, axes)
    with torch.no_grad():
        loc = rk_solve_adaptive_batched(field, tab, x0[b * per:(b + 1) * per],
                                        0.0, 1.0, params, CFG)
        specs = batched_solution_specs(mesh, axes)
        full = {name: gather(from_local(getattr(loc, name), mesh,
                                        getattr(specs, name)))
                for name in loc._fields}
        for s in range(4):
            want = rk_solve_adaptive_batched(
                field, tab, x0[s * per:(s + 1) * per], 0.0, 1.0, params, CFG)
            for name in loc._fields:
                axis = 1 if name in ("xs", "ts", "hs") else 0
                got = full[name].narrow(axis, s * per, per)
                assert torch.equal(got, getattr(want, name)), (s, name)


def _check_scalar_leaf(mesh, axes):
    """A rank-0 param leaf crosses the solve boundary as it is: its
    gradient comes back rank-0 and exact."""
    params, x0 = problem()
    sparams = {"gain": torch.tensor(0.7, dtype=torch.float64),
               "w": params["w1"][:DIM, :DIM].clone()}

    def sfield(x, t, p):
        return p["gain"] * torch.tanh(x @ p["w"])

    for strat, stepping in (("symplectic", CFG), ("adjoint", 8)):
        kw = dict(gradient=strat, stepping=stepping, batch_axis=0)
        p_ref, x_ref = _live(sparams, x0)
        g_ref = _grads(torch.sum(solve(sfield, x_ref, p_ref, **kw).ys ** 2),
                       p_ref, x_ref)
        p_sh, x_sh = _live(sparams, x0)
        g_sh = _grads(torch.sum(solve(sfield, x_sh, p_sh, mesh=mesh,
                                      **kw).ys.to_local() ** 2), p_sh, x_sh)
        assert g_sh[0].dim() == 0, g_sh[0].shape
        for a, c in zip(g_ref[:-1], g_sh[:-1]):
            assert _max_abs(a, c) <= GRAD_ATOL, (strat, _max_abs(a, c))


def _check_engine(mesh, axes):
    from repro_torch.serve.engine import EngineConfig, Request, SolveEngine
    params, x0 = problem()
    tab = get_tableau("dopri5")
    reqs = [Request(x0[i % B], 0.0, 0.5 + 0.05 * i, 1e-6 * (1 + i % 3),
                    1e-8) for i in range(10)]
    plain = SolveEngine(field, tab, CFG, params, x0[0],
                        EngineConfig(buckets=(4, 8))).run(list(reqs))
    eng = SolveEngine(field, tab, CFG, params, x0[0],
                      EngineConfig(buckets=(4, 8), mesh=mesh))
    for r in reqs:
        eng.submit(r)
    comm.reset_counts()
    got, per_step = {}, []
    while eng.pending or eng.occupancy:
        before = sum(comm.counts().values())
        eng.step(got)
        per_step.append(sum(comm.counts().values()) - before)
    assert set(got) == set(plain)
    for rid in got:
        a, c = got[rid], plain[rid]
        assert (a.succeeded, a.n_accepted, a.n_fevals, a.n_attempts) == \
            (c.succeeded, c.n_accepted, c.n_fevals, c.n_attempts), rid
        assert _max_abs(a.x_final, c.x_final) <= GRAD_ATOL, rid
    # one all_gather per sweep, one more when the sweep harvests
    assert max(per_step) <= 2 and min(per_step) >= 1, per_step
    assert comm.counts()["all_gather"] == sum(per_step)
    st = eng.resident_state
    from torch.distributed.tensor import Shard
    assert all(isinstance(p, Shard) and p.dim == 0
               for p in st.t.placements), st.t.placements
    assert all(isinstance(p, Shard) and p.dim == 1
               for p in st.ts.placements), st.ts.placements
    assert tuple(st.ts.shape) == (CFG.max_steps + 1, eng.stats["lanes"])


def _check_sharder():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel import make_sharder
    from repro_torch.parallel.layout import distribute, replicated
    mesh = make_debug_mesh(2, 2, device_type="cpu")     # ("data", "model")
    shard = make_sharder(mesh)
    y = shard(distribute(torch.ones(4, 8), mesh, replicated(mesh)),
              ("batch", "ffn"))
    assert tuple(y.placements) == (Shard(0), Shard(1)), y.placements
    # a non-divisible dim is never constrained
    y5 = shard(distribute(torch.ones(4, 5), mesh, replicated(mesh)),
               ("batch", "ffn"))
    assert tuple(y5.placements) == (Shard(0), Replicate()), y5.placements
    # a plain local tensor is the rank's own block: identity
    x = torch.ones(4, 8)
    assert shard(x, ("batch", "ffn")) is x


def mesh_cases():
    out = {}
    for mesh, axes in _meshes():
        tag = "x".join(str(n) for n in mesh.shape)
        for grad, stepping in (("symplectic", CFG), ("adjoint", CFG),
                               ("symplectic", 12), ("adjoint", 12)):
            step = "adaptive" if isinstance(stepping, AdaptiveConfig) \
                else "fixed"
            case(out, f"solve-{tag}-{grad}-{step}", _check_solve, mesh, axes,
                 grad, stepping)
        ts = SaveAt(ts=torch.linspace(0.25, 1.0, 4, dtype=torch.float64))
        for grad, stepping in (("symplectic", CFG), ("adjoint", CFG),
                               ("symplectic", 6), ("adjoint", 6)):
            step = "adaptive" if isinstance(stepping, AdaptiveConfig) \
                else "fixed"
            case(out, f"saveat-{tag}-{grad}-{step}", _check_solve, mesh,
                 axes, grad, stepping, ts)
        if tag == "4":
            case(out, f"grids-{tag}", _check_grids, mesh, axes)
            case(out, f"scalar-{tag}", _check_scalar_leaf, mesh, axes)
            case(out, f"engine-{tag}", _check_engine, mesh, axes)
    case(out, "sharder-2x2", _check_sharder)
    return out
