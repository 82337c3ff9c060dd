"""What each rank of the elastic and data-parallel gloo worlds runs
(``torch_world``; ``tests/test_torch_elastic.py`` says what is held).

``elastic_cases`` (4 ranks): the smoke qwen3-0.6b ``TrainState`` laid out
(4,) -> (2, 2) -> (4,) by ``runtime.reshard_state`` with
``parallel.state_specs``, bitwise, as ``tests/test_failures.py``'s elastic
script; a checkpoint written under (4,) restores under (2, 2); the solve
engine boots from a checkpoint onto a lane mesh.

``dp_cases`` (2 ranks): one ZeRO-1 and one plain data-parallel train step
(two steps each) at smoke width in float64 against the single-process step
on the same global batch.  The port's plain RMSNorm and attention compute
in float32 whatever their input (the JAX package's rule), so the float64
run takes their ``float32`` to float64
(``repro_torch.float64.Float64Torch``): the gradients are then float64-exact, and the ranks' sum
of half-batch gradients is the full batch's to rounding, not to float32.
"""
from __future__ import annotations

import os

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_smoke_arch
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.float64 import Float64Torch
from repro_torch.launch.mesh import make_debug_mesh, make_lane_mesh
from repro_torch.parallel import comm, make_sharder, state_specs
from repro_torch.runtime import (Checkpointer, OwnedShard, full_leaf,
                                 mesh_shardings, reshard_state)
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.data_parallel import Zero1
from torch_world import case

ARCH = get_smoke_arch("qwen3-0.6b")
REL = 1e-12


def _leaves(state):
    return pytree.tree_leaves(state, is_leaf=lambda x: isinstance(
        x, OwnedShard))


def _whole(state):
    return [full_leaf(l) for l in _leaves(state)]


def _same(got, want, what):
    for i, (a, b) in enumerate(zip(got, want)):
        if a is None or b is None:
            assert a is None and b is None, (what, i)
            continue
        assert torch.equal(a, b), (what, i)


def _opt_bytes(state):
    """Bytes of the float32 m/v leaves this rank holds."""
    from torch.distributed.tensor import DTensor
    n = 0
    for key in ("m", "v"):
        for leaf in _leaves(state.opt[key]):
            t = leaf.to_local() if isinstance(leaf, DTensor) else \
                leaf.local if isinstance(leaf, OwnedShard) else leaf
            n += 0 if t is None else t.numel() * t.element_size()
    return n


def _check_reshard():
    from torch.distributed.tensor import DTensor, Shard
    state = init_train_state(ARCH, TrainConfig(), device="cpu")
    ref = _leaves(state)
    mesh1 = make_lane_mesh((4,), device_type="cpu")         # 4-way data
    mesh2 = make_debug_mesh(2, 2, device_type="cpu")        # after restart
    specs1, specs2 = state_specs(state, mesh1), state_specs(state, mesh2)
    s1 = reshard_state(state, mesh1, specs1)
    s2 = reshard_state(s1, mesh2, specs2)
    s3 = reshard_state(s2, mesh1, specs1)
    _same(_whole(s2), ref, "(2, 2)")
    _same(_whole(s3), ref, "(4,) again")
    # the (2, 2) layout splits something over "model"...
    assert any(isinstance(l, DTensor) and isinstance(l.placements[1], Shard)
               for l in _leaves(s2)), "nothing split over model"
    # ...and ZeRO-1 gives each rank 1/data of the optimizer bytes
    total = _opt_bytes(state)
    assert _opt_bytes(s1) * 4 == total, (_opt_bytes(s1), total)
    assert any(isinstance(l, OwnedShard) for l in _leaves(s2.opt["m"]))
    assert _opt_bytes(s2) * 2 <= total


def _check_restore():
    state = init_train_state(ARCH, TrainConfig(), device="cpu")
    ref = _leaves(state)
    mesh1 = make_lane_mesh((4,), device_type="cpu")
    mesh2 = make_debug_mesh(2, 2, device_type="cpu")
    d = os.path.join(os.environ["TORCH_WORLD_TMP"], "ckpt")
    Checkpointer(d).save(5, reshard_state(state, mesh1,
                                          state_specs(state, mesh1)))
    torch.distributed.barrier()
    sh2 = mesh_shardings(mesh2, state_specs(state, mesh2))
    like = init_train_state(ARCH, TrainConfig(), seed=1, device="cpu")
    restored, step = Checkpointer(d).restore(like, shardings=sh2)
    assert step == 5
    _same(_whole(restored), ref, "restored")
    plain, _ = Checkpointer(d).restore(like)
    _same(_whole(restored), _leaves(plain), "restored vs unsharded boot")
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.layout import placements
    flat = pytree.tree_leaves(sh2, is_leaf=lambda x: x is None or hasattr(
        x, "spec"))
    for leaf, sh in zip(_leaves(restored), flat):
        if isinstance(leaf, DTensor):
            assert tuple(leaf.placements) == placements(mesh2, sh.spec)
        elif isinstance(leaf, OwnedShard):
            assert leaf.sharding == sh


def _check_engine_boot():
    from repro_torch.core import AdaptiveConfig, get_tableau
    from repro_torch.parallel import P
    from repro_torch.serve import EngineConfig, Request, SolveEngine
    from torch_world_cases import B, field, problem
    params, x0 = problem()
    mesh = make_lane_mesh((4,), device_type="cpu")
    d = os.path.join(os.environ["TORCH_WORLD_TMP"], "engine_ckpt")
    saved = {"params": params, "step": torch.zeros((), dtype=torch.int32)}
    Checkpointer(d).save(3, saved)
    torch.distributed.barrier()
    like = pytree.tree_map(torch.zeros_like, saved)
    cfg, tab = AdaptiveConfig(rtol=1e-8, atol=1e-10, max_steps=96), \
        get_tableau("dopri5")
    reqs = [Request(x0[i % B], 0.0, 0.5 + 0.05 * i, 1e-6, 1e-8)
            for i in range(6)]
    shardings = mesh_shardings(mesh, pytree.tree_map(lambda _: P(), saved))
    sharded = SolveEngine.from_checkpoint(
        field, tab, cfg, d, like, x0[0],
        EngineConfig(buckets=(4, 8), mesh=mesh), shardings=shardings)
    plain = SolveEngine.from_checkpoint(field, tab, cfg, d, like, x0[0],
                                        EngineConfig(buckets=(4, 8)))
    assert sharded.restored_step == plain.restored_step == 3
    got, want = sharded.run(list(reqs)), plain.run(list(reqs))
    for rid in want:
        a, b = got[rid], want[rid]
        assert (a.succeeded, a.n_accepted, a.n_fevals) == \
            (b.succeeded, b.n_accepted, b.n_fevals), rid
        assert float((a.x_final - b.x_final).abs().max()) <= 1e-12, rid


def elastic_cases():
    out = {}
    case(out, "reshard", _check_reshard)
    case(out, "restore", _check_restore)
    case(out, "engine_boot", _check_engine_boot)
    return out


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _check_dp(zero1: bool):
    import repro_torch.kernels.ref as ref
    ref.torch = Float64Torch()
    try:
        _dp_steps(zero1)
    finally:
        ref.torch = torch


def _dp_steps(zero1: bool):
    tcfg = TrainConfig(param_dtype="float64")
    state = init_train_state(ARCH, tcfg, device="cpu")
    mesh = make_lane_mesh((2,), device_type="cpu")
    one = make_train_step(ARCH, tcfg)
    if zero1:
        laid = reshard_state(state, mesh, state_specs(state, mesh))
        z = Zero1(mesh, laid)
        dp = make_train_step(ARCH, tcfg, shard=make_sharder(mesh),
                             grad_constraint=z)
    else:
        laid, z = state, None
        dp = make_train_step(ARCH, tcfg, shard=make_sharder(mesh))
    n_leaves = len(pytree.tree_leaves(state.params))
    want_state = state
    for step in range(2):
        b = synthetic_lm_batch(step, 4, 33, ARCH.vocab)
        batch = {k: torch.as_tensor(v, dtype=torch.long)
                 for k, v in b.items()}
        want_state, want = one(want_state, batch)
        comm.reset_counts()
        laid, got = dp(laid, batch)
        counts = comm.counts()
        for k in ("loss", "grad_norm"):
            assert _rel(got[k], want[k]) <= REL, (step, k, got[k], want[k])
        for name in ("params", "opt"):
            for a, c in zip(_whole(getattr(laid, name)),
                            _leaves(getattr(want_state, name))):
                if c.is_floating_point():
                    assert _rel(a, c) <= REL, (step, name, _rel(a, c))
                else:
                    assert torch.equal(a, c), (step, name)
        # one collective per gradient leaf and the loss; with ZeRO-1 the
        # norm and the gathers of the new params
        if z is None:
            assert counts == {"all_reduce": n_leaves + 1}, counts
        else:
            gathers = sum(k != "whole" for k in z.kinds)
            assert sum(counts.values()) == n_leaves + 2 + gathers, counts


def dp_cases():
    out = {}
    case(out, "zero1", _check_dp, True)
    case(out, "plain", _check_dp, False)
    return out

