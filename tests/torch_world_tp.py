"""What each rank of the tensor-parallel gloo worlds runs (``torch_world``;
``tests/test_torch_tensor_parallel.py`` and ``tests/test_torch_dp_accum.py``
say what is held).

Every comparison with the port's one-process functions runs in float64
with the port's float32 casts lifted (``repro_torch.float64.lifted``): the
ranks then compute the one-process function up to the order of float64
sums, so 1e-12 relative holds.  The step cases run on the smoke
qwen3-0.6b (d 32, 4 heads / 2 kv heads, d_ff 64, vocab 128): on "model" 2
each rank holds 2 heads and 1 kv head, 32 ffn columns and 64 vocab rows.

``train.data_parallel.step_collectives`` is the count a step makes, by
kind, from the arch, the mode and the layout (see its docstring); every
rank holds its own count to it exactly.
"""
from __future__ import annotations

import collections
import dataclasses
import os

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_smoke_arch
from repro_torch.configs.base import NodeConfig
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.float64 import lifted
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.optim import CompressionConfig
from repro_torch.parallel import comm, make_sharder, state_specs, tensor
from repro_torch.parallel.layout import axes_group, coordinate
from repro_torch.runtime import (Checkpointer, OwnedShard, full_leaf,
                                 mesh_shardings, reshard_state)
from repro_torch.train import (IGNORE, TrainConfig, init_train_state,
                               make_train_step)
from repro_torch.train.data_parallel import Zero1, step_collectives
from torch_world import case

ARCH = get_smoke_arch("qwen3-0.6b")
REL = 1e-12
F64 = torch.float64


def _rel(a, b):
    a, b = a.to(F64), b.to(F64)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _close(a, b, what, tol=REL):
    err = _rel(a, b)
    assert err <= tol, f"{what}: rel err {err:.3e} > {tol}"


def _leaves(tree):
    return pytree.tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, OwnedShard))


def _whole(tree):
    return [full_leaf(l) for l in _leaves(tree)]


def _rank():
    return torch.distributed.get_rank()


def _batch(step, B, S, vocab=ARCH.vocab, masked=False):
    """A global batch; ``masked``: row r's first 5 r mod S labels IGNORE,
    so that the rows, and the microbatches, hold different token counts."""
    b = synthetic_lm_batch(step, B, S + 1, vocab)
    b = {k: torch.as_tensor(v, dtype=torch.long) for k, v in b.items()}
    if masked:
        for r in range(B):
            b["labels"][r, :5 * r % S] = IGNORE
    return b


# ---------------------------------------------------------------------------
# the regions
# ---------------------------------------------------------------------------

def _model_group(mesh):
    return axes_group(mesh, ["model"])


def _check_regions():
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    g = _model_group(mesh)
    me = coordinate(mesh)[1]                    # this rank's model block
    gen = torch.Generator().manual_seed(7)
    # every rank draws every block's tensors alike, then takes its own
    xs = [torch.randn(3, 4, 5, generator=gen, dtype=F64) for _ in range(2)]
    cots = [torch.randn(3, 4, 5, generator=gen, dtype=F64) for _ in range(2)]

    def run(fn, x, cot):
        x = x.clone().requires_grad_()
        comm.reset_counts()
        y = fn(x)
        fwd = comm.counts()
        comm.reset_counts()
        (gx,) = torch.autograd.grad(y, x, cot)
        return y.detach(), gx, fwd, comm.counts()

    y, gx, fwd, bwd = run(lambda x: comm.copy_to(x, g), xs[me], cots[me])
    assert torch.equal(y, xs[me]) and torch.equal(gx, cots[0] + cots[1])
    assert (fwd, bwd) == ({}, {"all_reduce": 1}), (fwd, bwd)
    y, gx, fwd, bwd = run(lambda x: comm.reduce_from(x, g), xs[me],
                          cots[0])
    assert torch.equal(y, xs[0] + xs[1]) and torch.equal(gx, cots[0])
    assert (fwd, bwd) == ({"all_reduce": 1}, {}), (fwd, bwd)
    # sequence blocks: (3, 2, 5) per rank along dim 1
    blocks = [x[:, 2 * b:2 * b + 2] for b, x in enumerate(xs)]
    y, gx, fwd, bwd = run(lambda x: comm.gather_from_sequence(x, g, 1),
                          blocks[me], cots[me])
    assert torch.equal(y, torch.cat(blocks, 1))
    assert torch.equal(gx, (cots[0] + cots[1])[:, 2 * me:2 * me + 2])
    assert (fwd, bwd) == ({"all_gather": 1}, {"reduce_scatter": 1})
    y, gx, fwd, bwd = run(lambda x: comm.scatter_to_sequence(x, g, 1),
                          xs[me], cots[me][:, :2])
    assert torch.equal(y, (xs[0] + xs[1])[:, 2 * me:2 * me + 2])
    assert torch.equal(gx, torch.cat([c[:, :2] for c in cots], 1))
    assert (fwd, bwd) == ({"reduce_scatter": 1}, {"all_gather": 1})
    # bytes are counted for the backward's collectives too
    comm.reset_counts()
    x = blocks[me].clone().requires_grad_()
    torch.autograd.grad(comm.gather_from_sequence(x, g, 1), x, cots[me])
    assert comm.BYTES == {"all_gather": 2 * blocks[me].numel() * 8,
                          "reduce_scatter": blocks[me].numel() * 8}, \
        comm.BYTES


# ---------------------------------------------------------------------------
# the vocab-parallel lookup and loss
# ---------------------------------------------------------------------------

def _tp(mesh, S, arch=ARCH):
    return tensor.TensorParallel.of(mesh, arch).for_seq(S)


def _check_embed(S):
    from repro_torch.models.lm import _embed
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    tp = _tp(mesh, S)
    gen = torch.Generator().manual_seed(3)
    emb = torch.randn(ARCH.vocab, ARCH.d_model, generator=gen, dtype=F64)
    tokens = torch.randint(0, ARCH.vocab, (3, S), generator=gen)
    cot = torch.randn(3, S, ARCH.d_model, generator=gen, dtype=F64)
    e1 = emb.clone().requires_grad_()
    want = _embed({"embed": e1}, ARCH, tokens, None)
    (gw,) = torch.autograd.grad(want, e1, cot)
    Vl = ARCH.vocab // 2
    el = emb[tp.rank * Vl:(tp.rank + 1) * Vl].clone().requires_grad_()
    got = _embed({"embed": el}, ARCH, tokens, None, tp)
    assert torch.equal(got, tp.rows(want.detach())), "lookup"
    (gl,) = torch.autograd.grad(got, el, tp.rows(cot))
    _close(gl, gw[tp.rank * Vl:(tp.rank + 1) * Vl], "embed grad")


def _check_loss(S, chunk):
    from repro_torch.train.losses import IGNORE, lm_loss_chunked
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    tp = _tp(mesh, S)
    gen = torch.Generator().manual_seed(5)
    d, V = 6, 10
    hidden = torch.randn(2, S, d, generator=gen, dtype=F64)
    head = torch.randn(d, V, generator=gen, dtype=F64)
    labels = torch.randint(0, V, (2, S), generator=gen)
    labels[0, :3] = IGNORE
    labels[-1, -2:] = IGNORE
    h1, w1 = hidden.clone().requires_grad_(), head.clone().requires_grad_()
    want = lm_loss_chunked(h1, w1, labels, chunk)
    gh, gw = torch.autograd.grad(want, (h1, w1))
    tp = dataclasses.replace(tp, vocab_split=True)
    hl = tp.rows(hidden).clone().requires_grad_()
    wl = head[:, tp.rank * 5:(tp.rank + 1) * 5].clone().requires_grad_()
    comm.reset_counts()
    got = lm_loss_chunked(hl, wl, labels, chunk, tp=tp)
    fwd = comm.counts()
    comm.reset_counts()
    ghl, gwl = torch.autograd.grad(got, (hl, wl))
    bwd = comm.counts()
    _close(got, want, "loss")
    _close(ghl, tp.rows(gh), "d hidden")
    _close(gwl, gw[:, tp.rank * 5:(tp.rank + 1) * 5], "d head")
    chunks = -(-S // min(chunk, S))
    enter = "all_gather" if tp.seq_carry else None
    assert fwd == collections.Counter(
        {"all_gather": chunks + (enter is not None)}), fwd
    assert bwd == ({"reduce_scatter": 1} if tp.seq_carry
                   else {"all_reduce": 1}), bwd


# ---------------------------------------------------------------------------
# the train step on a mesh
# ---------------------------------------------------------------------------

def node_arch(arch=ARCH):
    return arch.with_(node=NodeConfig(mode="node", grad_mode="symplectic"))


def mesh_step_check(mesh, arch, tcfg, *, zero1: bool, steps=1, S=16, B=4,
                    masked=False):
    """``steps`` steps on ``mesh`` against the one-process step from the
    same state on the same global batches (``_batch``'s ``masked``): loss,
    grad_norm, params and the
    optimizer state within 1e-12 relative (the caller lifts the float32
    casts), int8's residual within 1e-12 of its leaf's max|g|; the
    collectives per step exactly ``step_collectives``."""
    state = init_train_state(arch, tcfg, device="cpu")
    one = make_train_step(arch, tcfg)
    specs = state_specs(state, mesh, zero1=zero1)
    laid = reshard_state(state, mesh, specs)
    z = Zero1(mesh, laid) if zero1 else None
    step = make_train_step(arch, tcfg, shard=make_sharder(mesh),
                           grad_constraint=z)
    want_state = state
    for i in range(steps):
        batch = _batch(i, B, S, arch.vocab, masked)
        want_state, want = one(want_state, batch)
        comm.reset_counts()
        laid, got = step(laid, batch)
        counts = comm.counts()
        for k in ("loss", "grad_norm"):
            _close(got[k], want[k], f"step {i} {k}")
        for name in ("params", "opt", "compress_err"):
            g, w = getattr(laid, name), getattr(want_state, name)
            if w is None:
                assert g is None, name
                continue
            # int8's residual g - q scale is at most scale / 2 = max|g| / 254:
            # 1e-12 of max|g| is 254e-12 of the residual's own max
            tol = REL * (254 if name == "compress_err" else 1)
            for j, (a, b) in enumerate(zip(_whole(g), _leaves(w))):
                if b.is_floating_point():
                    _close(a, b, f"step {i} {name} leaf {j}", tol)
                else:
                    assert torch.equal(a, b), (i, name, j)
        want_counts = step_collectives(
            arch, mesh, len(pytree.tree_leaves(state.params)), seq_len=S,
            kinds=None if z is None else z.kinds,
            loss_chunk=tcfg.loss_chunk, microbatches=tcfg.microbatches,
            compression=tcfg.compression.mode)
        assert counts == want_counts, (i, counts, want_counts)
    return laid


def _check_step(mode, zero1, S, steps=1, arch=ARCH):
    arch = arch if mode == "discrete" else node_arch(arch)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    mesh_step_check(mesh, arch, TrainConfig(param_dtype="float64"),
                    zero1=zero1, steps=steps, S=S)


#: "model" 2 divides neither: the ffn and the vocab leaves stay whole
WHOLE_FFN_VOCAB = ARCH.with_(d_ff=63, vocab=127)


def step_cases():
    """The regions, the vocab-parallel lookup and loss, and the train step
    on (2, 2) against one process (4 ranks)."""
    out = {}
    with lifted():
        case(out, "regions", _check_regions)
        for S in (8, 7):
            case(out, f"embed-S{S}", _check_embed, S)
        for S, chunk in ((12, 4), (13, 4), (6, 512)):
            case(out, f"loss-S{S}-c{chunk}", _check_loss, S, chunk)
        for mode in ("discrete", "node"):
            for zero1 in (True, False):
                tag = f"{mode}-{'zero1' if zero1 else 'plain'}"
                case(out, f"step-{tag}-seq_carry", _check_step, mode, zero1,
                     16, 2 if mode == "discrete" and zero1 else 1)
        case(out, "step-discrete-zero1-replicated_seq", _check_step,
             "discrete", True, 15)
        case(out, "step-node-plain-replicated_seq", _check_step, "node",
             False, 15)
        for S in (16, 15):
            case(out, f"step-discrete-zero1-whole_ffn_vocab-S{S}",
                 _check_step, "discrete", True, S, 1, WHOLE_FFN_VOCAB)
    return out


# ---------------------------------------------------------------------------
# against JAX, and the checkpoint of a tensor-parallel state
# ---------------------------------------------------------------------------

def _case_dir():
    return os.environ["TORCH_TP_CASE_DIR"]


def _check_jax_step(mode):
    """One (2, 2) ZeRO-1 step from the port's copy of JAX's state (saved by
    the test): rank 0 saves the new state's whole leaves and the metrics
    for the test to hold against JAX's step (float32 casts as they are)."""
    d = _case_dir()
    given = torch.load(os.path.join(d, f"jax_{mode}_in.pt"),
                       weights_only=False)
    arch = ARCH if mode == "discrete" else node_arch()
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    state = given["state"]
    laid = reshard_state(state, mesh, state_specs(state, mesh))
    step = make_train_step(arch, given["tcfg"], shard=make_sharder(mesh),
                           grad_constraint=Zero1(mesh, laid))
    laid, metrics = step(laid, given["batch"])
    whole = {"params": _whole(laid.params),
             "opt": {k: _whole(v) for k, v in laid.opt.items()}}
    if _rank() == 0:
        torch.save({"whole": whole,
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "solver_stats": {k: int(full_leaf(v)) for k, v in
                                     laid.solver_stats.items()}},
                   os.path.join(d, f"jax_{mode}_out.pt"))


def _check_jax_accum(compression):
    """Two (2, 2) ZeRO-1 steps of ``microbatches=2`` with ``compression``
    from the port's copy of JAX's state, on the test's masked batches (the
    caller lifts the casts): rank 0 saves each step's whole leaves and
    metrics for the test to hold against JAX's one-device steps."""
    d = _case_dir()
    given = torch.load(os.path.join(d, f"jax_mb2-{compression}_in.pt"),
                       weights_only=False)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    state = given["state"]
    laid = reshard_state(state, mesh, state_specs(state, mesh))
    step = make_train_step(ARCH, given["tcfg"], shard=make_sharder(mesh),
                           grad_constraint=Zero1(mesh, laid))
    saved = []
    for batch in given["batches"]:
        laid, metrics = step(laid, batch)
        opt = {k: _whole(v) for k, v in laid.opt.items() if k != "step"}
        opt["step"] = int(_whole(laid.opt["step"])[0])
        saved.append({
            "params": _whole(laid.params), "opt": opt,
            "compress_err": None if laid.compress_err is None
            else _whole(laid.compress_err),
            "metrics": {k: float(v) for k, v in metrics.items()}})
    if _rank() == 0:
        torch.save(saved, os.path.join(d, f"jax_mb2-{compression}_out.pt"))


def _check_checkpoint():
    """Two (2, 2) ZeRO-1 steps, the state checkpointed (rank 0 writes full
    arrays) and restored on (4, 1): every leaf bitwise; rank 0 saves the
    whole leaves for the test's (1, 1) restore."""
    d = _case_dir()
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    tcfg = TrainConfig(param_dtype="float64",
                       compression=CompressionConfig(mode="int8"))
    laid = mesh_step_check(mesh, ARCH, tcfg, zero1=True, steps=2)
    ckpt = os.path.join(d, "ckpt")
    Checkpointer(ckpt).save(2, laid)
    torch.distributed.barrier()
    like = init_train_state(ARCH, tcfg, seed=1, device="cpu")
    mesh41 = make_debug_mesh(4, 1, device_type="cpu")
    restored, step = Checkpointer(ckpt).restore(
        like, shardings=mesh_shardings(mesh41, state_specs(like, mesh41)))
    assert step == 2
    want = _whole(laid)
    got = _whole(restored)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"leaf {i} differs after (4, 1) restore"
    if _rank() == 0:
        torch.save(want, os.path.join(d, "ckpt_whole.pt"))


def jax_cases():
    out = {}
    for mode in ("discrete", "node_symplectic"):
        case(out, f"jax-{mode}", _check_jax_step, mode)
    with lifted():
        for compression in ("bf16", "int8"):
            case(out, f"jax-mb2-{compression}", _check_jax_accum,
                 compression)
        case(out, "checkpoint", _check_checkpoint)
    return out


# ---------------------------------------------------------------------------
# microbatches and compression on (2, 1) and (2, 2)
# ---------------------------------------------------------------------------

def _check_accum(compression, zero1, mode="discrete", data=2, B=8):
    """Two steps of ``microbatches=2`` on (``data``, world / ``data``) with
    masked labels (each data rank's share of a microbatch holds its own
    token count) against one process."""
    world = torch.distributed.get_world_size()
    mesh = make_debug_mesh(data, world // data, device_type="cpu")
    arch = ARCH if mode == "discrete" else node_arch()
    tcfg = TrainConfig(param_dtype="float64", microbatches=2,
                       compression=CompressionConfig(mode=compression))
    mesh_step_check(mesh, arch, tcfg, zero1=zero1, steps=2, B=B,
                    masked=True)


def _check_launcher():
    """``launch.train --mesh debug`` on this world (4 ranks: JAX's (2, 2)
    default) against the plain run of the same argv, rows within 1e-12
    (float64: the casts lifted, so ``init_train_state`` makes float64
    params)."""
    from repro_torch.launch import train
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--steps", "2", "--global-batch", "4", "--seq-len", "16",
            "--microbatches", "2", "--compression", "int8"]
    plain = train.main(argv)
    comm.reset_counts()
    meshed = train.main(argv + ["--mesh", "debug"])
    counts = comm.counts()
    assert next(iter(meshed["state"].params["unit"][0][0]["attn"]
                     .values())).device_mesh.shape == (2, 2)
    for a, b in zip(meshed["rows"], plain["rows"]):
        assert a["step"] == b["step"] and a["lr"] == b["lr"], (a, b)
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= REL * abs(b[k]), (k, a, b)
    assert counts.get("reduce_scatter", 0) > 0 and \
        counts.get("all_gather", 0) > 0, counts


def accum_cases():
    """Microbatches 2 with bf16 and int8 compression (and int8's error
    feedback) on (2, world / 2) against one process; on 4 ranks also the
    launcher on (2, 2)."""
    out = {}
    world = torch.distributed.get_world_size()
    tag = f"2x{world // 2}"
    with lifted():
        for compression in ("bf16", "int8"):
            for zero1 in (True, False):
                z = "zero1" if zero1 else "plain"
                case(out, f"mb2-{compression}-{z}-{tag}", _check_accum,
                     compression, zero1)
        case(out, f"mb2-int8-zero1-node-{tag}", _check_accum, "int8", True,
             "node")
        if world == 4:
            case(out, "launcher-2x2", _check_launcher)
            # microbatches of 2 rows on 4 data ranks: each stays whole on
            # every rank (the data axis does not divide it)
            case(out, "mb2-int8-zero1-rows_whole-4x1", _check_accum, "int8",
                 True, "discrete", 4, 4)
    return out
