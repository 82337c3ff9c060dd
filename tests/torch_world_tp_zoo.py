"""What each rank of the zoo's tensor-parallel gloo worlds runs
(``torch_world``; ``tests/test_torch_tensor_parallel_zoo.py`` says what is
held).

The archs are the smoke deepseek-v2-lite-16b (a dense MLA prefix layer and
two MLA + MoE units: 8 experts top-2, 2 shared), trained with TP-in-expert
(each rank holds 16 of every expert's 32 ffn columns) and with expert
parallelism (a state laid out by ``state_specs(..., ep=True)``: 4 experts
whole per rank); mixtral-8x7b (GQA, 4 experts top-2); and internvl2-1b
(the patch frontend: 4 patches before the tokens), at vocab 256, which
"model" 2 splits, and at 255, which it does not (the full model's 151655
is odd: the embed, the tied head and the loss then stay whole, the path the
card takes).  Every comparison runs in float64 with the port's float32
casts lifted (``repro_torch.float64.lifted``): the ranks compute the
one-process function up to the order of float64 sums, so 1e-12 relative
holds, and the MoE ranks route as one process does.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

import repro_torch.nn.moe as moe
from repro_torch.configs import get_smoke_arch
from repro_torch.float64 import lifted
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.parallel import comm, make_sharder, state_specs
from repro_torch.parallel.layout import axes_group, coordinate
from repro_torch.runtime import Checkpointer, reshard_state
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.data_parallel import Zero1, local_tensor, \
    step_collectives
from torch_world import case
from torch_world_tp import REL, _batch, _close, _leaves, _rank, _whole, \
    node_arch

PATCHES = 4
INTERNVL2 = get_smoke_arch("internvl2-1b")
#: name -> (arch, the state laid out with ep=True)
ARCHS = {
    "deepseek": (get_smoke_arch("deepseek-v2-lite-16b"), False),
    "deepseek_ep": (get_smoke_arch("deepseek-v2-lite-16b"), True),
    "mixtral": (get_smoke_arch("mixtral-8x7b"), False),
    "internvl2": (INTERNVL2, False),
    "internvl2_v255": (INTERNVL2.with_(vocab=255), False),
}
#: (arch, mode) of the steps held against JAX's one-device step
JAX_CASES = tuple((name, "discrete") for name in ARCHS) + \
    (("deepseek", "node"),)
#: (mode, ZeRO-1, "model" divides the sequence: S 16, or 15; PATCHES is
#: even, so P + S goes with S): every pair of two factors' values occurs
STEPS = (("discrete", True, True), ("discrete", False, False),
         ("node", False, True), ("node", True, False))


def zoo_batch(arch, step, B, S):
    """``torch_world_tp._batch`` with the patch frontend's embeddings (B,
    PATCHES, d_frontend), drawn from ``step``."""
    b = _batch(step, B, S, arch.vocab)
    if arch.frontend == "patch":
        b["patch_embeds"] = torch.randn(
            (B, PATCHES, arch.d_frontend), dtype=torch.float64,
            generator=torch.Generator().manual_seed(100 + step))
    return b


@contextlib.contextmanager
def routes():
    """The top-k expert ids of every MoE call while active, in call order
    (``repro_torch.nn.moe.route`` wrapped)."""
    calls, plain = [], moe.route

    def route(p, x, cfg):
        out = plain(p, x, cfg)
        calls.append(out[2].detach().clone())
        return out
    moe.route = route
    try:
        yield calls
    finally:
        moe.route = plain


def check_routes(got, want, mesh):
    """This rank's top-k choices equal one process's for its data rows at
    every call, and every rank of "model" made the same, bitwise (an
    all_gather outside ``comm``, so the step's counts are untouched)."""
    assert len(got) == len(want), (len(got), len(want))
    group = axes_group(mesh, ["model"]).group
    data = coordinate(mesh)[0]
    for i, (a, b) in enumerate(zip(got, want)):
        rows = b[data * len(a):(data + 1) * len(a)]
        assert torch.equal(a, rows), \
            f"MoE call {i}: routed unlike one process"
        parts = [torch.empty_like(a) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, a.contiguous(), group=group)
        assert all(torch.equal(p, a) for p in parts), \
            f"MoE call {i}: the ranks of 'model' routed differently"


def zoo_step_check(mesh, arch, tcfg, *, zero1: bool, ep: bool, S: int,
                   B: int = 4, steps: int = 1):
    """``steps`` steps on ``mesh`` (the state laid out with ``ep``) against
    the one-process step from the same state on the same batches: loss,
    grad_norm, params and the optimizer state within 1e-12 relative; the
    MoE routing as one process's and alike on every rank of "model"; the
    collectives per step exactly ``step_collectives``.  Returns the laid-
    out state."""
    state = init_train_state(arch, tcfg, device="cpu")
    one = make_train_step(arch, tcfg)
    laid = reshard_state(state, mesh, state_specs(state, mesh, zero1=zero1,
                                                  ep=ep))
    if ep:
        wg = local_tensor(laid.params["unit"][0][0]["moe"]["wg"])
        assert wg.shape[0] == arch.moe_experts // 2, wg.shape
    z = Zero1(mesh, laid) if zero1 else None
    step = make_train_step(arch, tcfg, shard=make_sharder(mesh),
                           grad_constraint=z)
    want_state = state
    for i in range(steps):
        batch = zoo_batch(arch, i, B, S)
        with routes() as want_routes:
            want_state, want = one(want_state, batch)
        comm.reset_counts()
        with routes() as got_routes:
            laid, got = step(laid, batch)
        counts = comm.counts()
        check_routes(got_routes, want_routes, mesh)
        for k in ("loss", "grad_norm"):
            _close(got[k], want[k], f"step {i} {k}")
        for name in ("params", "opt"):
            g, w = getattr(laid, name), getattr(want_state, name)
            for j, (a, b) in enumerate(zip(_whole(g), _leaves(w))):
                if b.is_floating_point():
                    _close(a, b, f"step {i} {name} leaf {j}")
                else:
                    assert torch.equal(a, b), (i, name, j)
        want_counts = step_collectives(
            arch, mesh, len(pytree.tree_leaves(state.params)), seq_len=S,
            kinds=None if z is None else z.kinds,
            loss_chunk=tcfg.loss_chunk,
            patches=PATCHES if arch.frontend == "patch" else 0)
        assert counts == want_counts, (i, counts, want_counts)
    return laid


def _check_step(name, mode, zero1, divides, shape=(2, 2)):
    arch, ep = ARCHS[name]
    arch = arch if mode == "discrete" else node_arch(arch)
    mesh = make_debug_mesh(*shape, device_type="cpu")
    zoo_step_check(mesh, arch, TrainConfig(param_dtype="float64"),
                   zero1=zero1, ep=ep, S=16 if divides else 15)


def step_name(name, mode, zero1, divides) -> str:
    return (f"{name}-{mode}-{'zero1' if zero1 else 'plain'}-"
            f"{'seq_carry' if divides else 'replicated_seq'}")


#: MoE archs also stepped on (4, 1), data parallel alone
DATA_ONLY = ("deepseek", "mixtral")
#: the archs ``launch.train --mesh debug`` takes on (2, 2)
LAUNCHED = ("deepseek-v2-lite-16b", "mixtral-8x7b", "internvl2-1b")


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
        for name in ARCHS:
            for mode, zero1, divides in STEPS:
                case(out, step_name(name, mode, zero1, divides),
                     _check_step, name, mode, zero1, divides)
        for arch_id in LAUNCHED:
            case(out, f"launcher-{arch_id}", _check_launcher, arch_id)
        # data parallel alone: the aux loss's sums over 4 data ranks
        for name in DATA_ONLY:
            case(out, f"{name}-discrete-4x1", _check_step, name, "discrete",
                 True, True, (4, 1))
    return out


# ---------------------------------------------------------------------------
# against JAX, and the checkpoint of an expert-parallel state
# ---------------------------------------------------------------------------

def _case_dir():
    return os.environ["TORCH_TP_CASE_DIR"]


def _check_jax_step(name, mode):
    """One (2, 2) ZeRO-1 step from the port's copy of JAX's state (saved by
    the test; casts lifted by the caller): rank 0 saves the new state's
    whole leaves and the metrics for the test to hold against JAX's
    one-device step."""
    d = _case_dir()
    given = torch.load(os.path.join(d, f"jax_{name}_{mode}_in.pt"),
                       weights_only=False)
    arch, ep = ARCHS[name]
    arch = arch if mode == "discrete" else node_arch(arch)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    state = given["state"]
    laid = reshard_state(state, mesh, state_specs(state, mesh, ep=ep))
    step = make_train_step(arch, given["tcfg"], shard=make_sharder(mesh),
                           grad_constraint=Zero1(mesh, laid))
    laid, metrics = step(laid, given["batch"])
    whole = {"params": _whole(laid.params),
             "opt": {k: _whole(v) for k, v in laid.opt.items()}}
    if _rank() == 0:
        torch.save({"whole": whole,
                    "metrics": {k: float(v) for k, v in metrics.items()}},
                   os.path.join(d, f"jax_{name}_{mode}_out.pt"))


def _check_checkpoint(ep):
    """A (2, 2) ZeRO-1 step of deepseek with the state laid out with
    ``ep``, checkpointed (rank 0 writes full arrays): rank 0 saves the
    whole leaves for the test's (1, 1) restore."""
    d = _case_dir()
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    arch, _ = ARCHS["deepseek"]
    laid = zoo_step_check(mesh, arch, TrainConfig(param_dtype="float64"),
                          zero1=True, ep=ep, S=16)
    tag = "ep" if ep else "tp"
    Checkpointer(os.path.join(d, f"ckpt_{tag}")).save(1, laid)
    dist.barrier()
    want = _whole(laid)
    if _rank() == 0:
        torch.save(want, os.path.join(d, f"ckpt_{tag}_whole.pt"))


def jax_cases():
    out = {}
    with lifted():
        for name, mode in JAX_CASES:
            case(out, f"jax-{name}-{mode}", _check_jax_step, name, mode)
        for ep in (False, True):
            case(out, f"checkpoint-{'ep' if ep else 'tp'}",
                 _check_checkpoint, ep)
    return out

