"""What each rank of the recurrent and enc-dec archs' tensor-parallel gloo
worlds runs (``torch_world``; ``tests/test_torch_tensor_parallel_rec.py``
says what is held).

The archs are the smoke jamba-v0.1-52b (one 8-layer unit: Mamba layers
with dense and MoE FFNs, one GQA layer; d_inner 128, so each rank of
"model" 2 scans 64 channels), trained with its Mamba laid out by channel
and laid out whole (``state_specs(..., extra_replicated=
MAMBA_PARAM_NAMES)``, the JAX dryrun's ``--replicate-mamba``);
xlstm-1.3b (7 mLSTM and 1 sLSTM layers of 4 heads: 2 per rank),
discrete and node-symplectic (euler); and seamless-m4t-medium (2 encoder
and 2 decoder layers of 4 heads, vocab 256), with the encoder's and the
decoder's sequences of different lengths, so that ``seq_carry`` holds for
one and not the other.  Every comparison runs in float64 with the port's
float32 casts lifted (``repro_torch.float64.lifted``): the ranks compute
the one-process function up to the order of float64 sums, so 1e-12
relative holds.
"""
from __future__ import annotations

import os

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import get_smoke_arch
from repro_torch.float64 import lifted
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.parallel import comm, make_sharder, state_specs
from repro_torch.parallel.shardings import MAMBA_PARAM_NAMES
from repro_torch.runtime import reshard_state
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.data_parallel import Zero1, step_collectives
from torch_world import case
from torch_world_tp import REL, _batch, _close, _leaves, _rank, _whole, \
    node_arch
from torch_world_tp_zoo import check_routes, routes

SEAMLESS = get_smoke_arch("seamless-m4t-medium")
#: name -> (arch, the Mamba leaves laid out whole)
ARCHS = {
    "jamba": (get_smoke_arch("jamba-v0.1-52b"), False),
    "jamba_whole": (get_smoke_arch("jamba-v0.1-52b"), True),
    "xlstm": (get_smoke_arch("xlstm-1.3b"), False),
    "seamless": (SEAMLESS, False),
}
#: per arch, (mode, ZeRO-1, S, the enc-dec source's length): "model" 2
#: divides S 16 (``seq_carry``) and not 15
STEPS = {
    "jamba": (("discrete", True, 16, 0), ("discrete", False, 15, 0)),
    "jamba_whole": (("discrete", True, 16, 0), ("discrete", False, 15, 0)),
    "xlstm": (("discrete", True, 16, 0), ("discrete", False, 15, 0),
              ("node", True, 16, 0), ("node", False, 15, 0)),
    "seamless": (("discrete", True, 16, 16), ("discrete", False, 15, 16),
                 ("discrete", True, 16, 15)),
}
#: (arch, mode) of the steps held against JAX's one-device step
JAX_CASES = (("jamba", "discrete"), ("xlstm", "node"),
             ("seamless", "discrete"))
#: the archs ``launch.train --mesh debug`` takes on (2, 2)
LAUNCHED = ("jamba-v0.1-52b", "xlstm-1.3b", "seamless-m4t-medium")


def extra_replicated(name):
    return MAMBA_PARAM_NAMES if ARCHS[name][1] else frozenset()


def rec_batch(arch, step, B, S, S_enc=0):
    """``torch_world_tp._batch`` with the enc-dec model's source frames (B,
    S_enc, d_frontend), drawn from ``step``."""
    b = _batch(step, B, S, arch.vocab)
    if arch.encdec:
        b["frames"] = torch.randn(
            (B, S_enc, arch.d_frontend), dtype=torch.float64,
            generator=torch.Generator().manual_seed(100 + step))
    return b


def counted(arch, mesh, state, z, tcfg, S, S_enc, whole):
    """``step_collectives`` for a step of ``arch`` on ``mesh``."""
    return step_collectives(
        arch, mesh, len(pytree.tree_leaves(state.params)), seq_len=S,
        kinds=None if z is None else z.kinds, loss_chunk=tcfg.loss_chunk,
        source_len=S_enc, whole_mamba=whole)


def rec_step_check(mesh, name, mode, zero1, S, S_enc, B=4):
    """One step on ``mesh`` against the one-process step from the same
    state on the same batch: loss, grad_norm, params and the optimizer
    state within 1e-12 relative; the MoE routing as one process's and
    alike on every rank of "model"; the collectives exactly
    ``step_collectives``."""
    arch, whole = ARCHS[name]
    arch = arch if mode == "discrete" else node_arch(arch)
    tcfg = TrainConfig(param_dtype="float64")
    state = init_train_state(arch, tcfg, device="cpu")
    laid = reshard_state(state, mesh, state_specs(
        state, mesh, zero1=zero1, extra_replicated=extra_replicated(name)))
    z = Zero1(mesh, laid) if zero1 else None
    step = make_train_step(arch, tcfg, shard=make_sharder(mesh),
                           grad_constraint=z)
    batch = rec_batch(arch, 0, B, S, S_enc)
    with routes() as want_routes:
        want_state, want = make_train_step(arch, tcfg)(state, batch)
    comm.reset_counts()
    with routes() as got_routes:
        laid, got = step(laid, batch)
    counts = comm.counts()
    check_routes(got_routes, want_routes, mesh)
    for k in ("loss", "grad_norm"):
        _close(got[k], want[k], k)
    close_step(laid, want_state, state, tcfg)
    want_counts = counted(arch, mesh, state, z, tcfg, S, S_enc, whole)
    assert counts == want_counts, (counts, want_counts)


def close_step(laid, want, old, tcfg):
    """The laid-out state after a step against the one-process state
    ``want``: each float leaf within 1e-12 of its largest entry; but a
    parameter that was zero before the step (``old``: the Mamba, mLSTM,
    sLSTM and LayerNorm biases) is its first AdamW update alone, lr g /
    (|g| + eps), whose derivative in g reaches lr / eps: it is held to what
    a gradient within 1e-12 of its largest entry can move it by, 1e-12 lr
    max|g| / eps (g = m / (1 - b1), ``torch_zoo_rec.close_leaves``'s rule
    at this bound)."""
    adamw = tcfg.adamw
    zero = [not bool(l.abs().max()) for l in _leaves(old.params)]
    gmax = [float(l.abs().max()) / (1 - adamw.b1)
            for l in _leaves(want.opt["m"])]
    for part in ("params", "opt"):
        g, w = getattr(laid, part), getattr(want, part)
        for j, (a, b) in enumerate(zip(_whole(g), _leaves(w))):
            if not b.is_floating_point():
                assert torch.equal(a, b), (part, j)
            elif part == "params" and zero[j]:
                err = float((a - b).abs().max())
                bound = REL * tcfg.lr * gmax[j] / adamw.eps
                assert err <= bound, f"params leaf {j}: {err} > {bound}"
            else:
                _close(a, b, f"{part} leaf {j}")


def step_name(name, mode, zero1, S, S_enc) -> str:
    src = f"-src{S_enc}" if S_enc else ""
    return f"{name}-{mode}-{'zero1' if zero1 else 'plain'}-S{S}{src}"


def _check_launcher(arch_id):
    """``launch.train --arch ARCH --smoke --mesh debug`` on this world (4
    ranks: (2, 2)) against the plain run of the same argv, rows within
    1e-12 (float64: the casts lifted, so ``init_train_state`` makes float64
    params)."""
    from repro_torch.launch import train
    argv = ["--arch", arch_id, "--smoke", "--device", "cpu", "--steps", "2",
            "--global-batch", "4", "--seq-len", "16"]
    plain = train.main(argv)
    meshed = train.main(argv + ["--mesh", "debug"])
    leaf = meshed["state"].params["embed"]
    assert leaf.device_mesh.shape == (2, 2), leaf.device_mesh.shape
    for a, b in zip(meshed["rows"], plain["rows"]):
        assert a["step"] == b["step"] and a["lr"] == b["lr"], (a, b)
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= REL * abs(b[k]), (k, a, b)


def step_cases():
    """Each arch's steps on (2, 2) against one process, and the launcher
    (4 ranks)."""
    out = {}
    with lifted():
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        for name, steps in STEPS.items():
            for mode, zero1, S, S_enc in steps:
                case(out, step_name(name, mode, zero1, S, S_enc),
                     rec_step_check, mesh, name, mode, zero1, S, S_enc)
        for arch_id in LAUNCHED:
            case(out, f"launcher-{arch_id}", _check_launcher, arch_id)
    return out


# ---------------------------------------------------------------------------
# the exact count on (1, 2), and against JAX
# ---------------------------------------------------------------------------

def _count_on_1x2(name, S, S_enc):
    """One ZeRO-1 step on ("data" 1, "model" 2): the collectives by kind
    exactly ``step_collectives``, on each rank (float32, as the card
    runs)."""
    arch, whole = ARCHS[name]
    mesh = make_debug_mesh(1, 2, device_type="cpu")
    tcfg = TrainConfig()
    state = init_train_state(arch, tcfg, device="cpu")
    laid = reshard_state(state, mesh, state_specs(
        state, mesh, extra_replicated=extra_replicated(name)))
    z = Zero1(mesh, laid)
    step = make_train_step(arch, tcfg, shard=make_sharder(mesh),
                           grad_constraint=z)
    comm.reset_counts()
    step(laid, rec_batch(arch, 0, 2, S, S_enc))
    want = counted(arch, mesh, state, z, tcfg, S, S_enc, whole)
    assert comm.counts() == want, (comm.counts(), want)


def build_cases():
    """``make_train_step`` of each arch on ("data" 1, "model" 2)."""
    out = {}
    mesh = make_debug_mesh(1, 2, device_type="cpu")
    for arch_id in LAUNCHED:
        case(out, arch_id, make_train_step, get_smoke_arch(arch_id),
             TrainConfig(), None, make_sharder(mesh))
    return out


#: (arch, S, S_enc) of the counts on (1, 2)
COUNT_CASES = (("jamba", 16, 0), ("jamba_whole", 15, 0), ("xlstm", 16, 0),
               ("seamless", 15, 16))


def count_cases():
    out = {}
    for name, S, S_enc in COUNT_CASES:
        case(out, f"count-{name}", _count_on_1x2, name, S, S_enc)
    return out


def _check_jax_step(name, mode):
    """One (2, 2) ZeRO-1 step from the port's copy of JAX's state (saved by
    the test; casts lifted by the caller): rank 0 saves the new state's
    whole leaves and the metrics for the test to hold against JAX's
    one-device step."""
    d = os.environ["TORCH_TP_CASE_DIR"]
    given = torch.load(os.path.join(d, f"jax_{name}_{mode}_in.pt"),
                       weights_only=False)
    arch = ARCHS[name][0]
    arch = arch if mode == "discrete" else node_arch(arch)
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
                    "metrics": {k: float(v) for k, v in metrics.items()}},
                   os.path.join(d, f"jax_{name}_{mode}_out.pt"))


def jax_cases():
    out = {}
    with lifted():
        for name, mode in JAX_CASES:
            case(out, f"jax-{name}-{mode}", _check_jax_step, name, mode)
    return out
