"""How far a float32 tensor-parallel training step lies from the one-process
float32 step, against a float64 reference, on the CPU: the rounding under
``chip_smoke.py`` phases 52's, 53's and 54's comparisons with a single-
process run, whose bounds a tensor-parallel fault must exceed.

    PYTHONPATH=src python tools/tp_rounding.py [--arch qwen3-0.6b] \\
        [--seq 64] [--batch 8] [--mutate NAME]

Runs a phase's schedule at the arch's smoke width from the seed-0 state,
on the launcher's 3-step cosine schedule, three ways: on a ("data" 1,
"model" 2) mesh of 2 gloo ranks in float32, in one process in float32, and
in one process in float64 with the float32 casts lifted
(``repro_torch.float64.lifted``):

* qwen3-0.6b (phase 52): 2 discrete steps (remat), 1 node-symplectic step
  (euler, one step per unit);
* deepseek-v2-lite-16b (phase 53): the same, then 1 discrete step from the
  seed-0 state laid out with ``state_specs(..., ep=True)`` (the TP-in-
  expert runs lay it out with ``ep=False``);
* internvl2-1b (phase 53): 1 discrete step of ``--seq`` positions, the
  first quarter patch embeddings (phase 53's 256 of 1024);
* jamba-v0.1-52b (phase 54): 1 discrete step with Mamba laid out by
  channel, 1 with it laid out whole (``extra_replicated=
  MAMBA_PARAM_NAMES``);
* xlstm-1.3b (phase 54): 1 discrete and 1 node-symplectic step, the labels
  past the first half of each row IGNORE (phase 54 keeps 32 of 1024);
* seamless-m4t-medium (phase 54): 1 discrete step of ``--seq`` source
  frames and a quarter as many target tokens (phase 54's 1024 and 256).

An MoE arch's runs replay the one-process float32 run's expert choices at
every MoE call (the card's comparison does so too: random routers reroute
under rounding), so the three differ by rounding alone.  ``--mutate``
plants a fault in the tensor-parallel run, to show that the bounds catch
it: ``partials`` leaves the router's and MLA's partial gradients
(``wdkv``, ``kv_norm``, ``wkr``) unsummed over "model"; ``aux`` counts
the MoE aux loss's gradient once per rank of "model" (``TensorParallel.
once`` a no-op); ``frontend`` gives the frontend's column gather the
backward of the other sequence layout; ``recurrent`` leaves the recurrent
mixers' channel and head leaves (``tensor.PARTIAL_IN``) unsummed;
``summed`` drops the backward sum of ``TensorParallel.summed`` (Mamba's
x_proj product, the mLSTM skip norm's statistics).

Prints, per step, the relative difference of loss and grad_norm between
each float32 run and the float64 one and between the two float32 runs,
whether the two ranks' unsplit params agree bitwise after each run, and
the maxima as the last line (JSON).
"""
import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import tempfile

#: per arch, the runs of its phase: (name, mode, steps, layout: "tp",
#: "ep" (expert parallel) or "whole" (Mamba laid out whole))
SCHEDULES = {
    "qwen3-0.6b": (("discrete", "discrete", 2, "tp"),
                   ("node_symplectic", "node", 1, "tp")),
    "deepseek-v2-lite-16b": (("discrete", "discrete", 2, "tp"),
                             ("node_symplectic", "node", 1, "tp"),
                             ("ep", "discrete", 1, "ep")),
    "internvl2-1b": (("discrete", "discrete", 1, "tp"),),
    "jamba-v0.1-52b": (("split", "discrete", 1, "tp"),
                       ("whole", "discrete", 1, "whole")),
    "xlstm-1.3b": (("discrete", "discrete", 1, "tp"),
                   ("node_symplectic", "node", 1, "tp")),
    "seamless-m4t-medium": (("discrete", "discrete", 1, "tp"),),
}
MUTATIONS = ("partials", "aux", "frontend", "recurrent", "summed")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@contextlib.contextmanager
def _routing(forced=None):
    """Records each MoE call's top-k expert ids, in call order; with
    ``forced`` (another run's records) each call takes those instead, its
    gate weights from its own probabilities (``chip_smoke.py::_Gates``)."""
    import torch

    import repro_torch.nn.moe as moe
    calls, plain = [], moe.route

    def route(p, x, cfg):
        probs, w, idx = plain(p, x, cfg)
        if forced is not None:
            idx = forced[len(calls)].to(idx.device)
            w = torch.gather(probs, -1, idx)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        calls.append(idx)
        return probs, w, idx
    moe.route = route
    try:
        yield calls
    finally:
        moe.route = plain


def _mutate(name):
    """Plant ``name`` (see the module note) in ``repro_torch.parallel``."""
    from repro_torch.parallel import comm, tensor
    if name == "partials":
        plain = tensor.partial_leaves
        names = {"router", "wdkv", "kv_norm", "wkr"}

        def partial_leaves(params, mesh, seq_carry, source_carry=None):
            from torch.utils import _pytree as pytree
            paths = [p for p, _ in pytree.tree_flatten_with_path(params)[0]]
            return [flag and names.isdisjoint(tensor._path_names(path))
                    for flag, path in zip(plain(params, mesh, seq_carry,
                                                source_carry), paths)]
        tensor.partial_leaves = partial_leaves
    elif name == "recurrent":
        tensor.PARTIAL_IN = {k: (anchor, frozenset())
                             for k, (anchor, _) in tensor.PARTIAL_IN.items()}
    elif name == "summed":
        tensor.TensorParallel.summed = \
            lambda self, t: comm.reduce_from(t, self.group)
    elif name == "aux":
        tensor.TensorParallel.once = lambda self, t: t
    elif name == "frontend":
        tensor.TensorParallel.join_columns = \
            lambda self, w: comm.gather_columns(w, self.group,
                                                not self.seq_carry)


def _runs(arch_id, batch, seq, mesh=None, dtype="float32", forced=None):
    """{run: {"rows": [(loss, grad_norm) per step], "routes": [...],
    "digest": sha256 of the unsplit params (on a mesh)}} of the arch's
    schedule."""
    import hashlib

    import torch

    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import NodeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.optim import cosine_schedule
    from repro_torch.parallel import make_sharder, state_specs, tensor
    from repro_torch.parallel.shardings import MAMBA_PARAM_NAMES
    from repro_torch.runtime import reshard_state
    from repro_torch.train import IGNORE, TrainConfig, init_train_state, \
        make_train_step
    from repro_torch.train.data_parallel import Zero1, local_tensor
    from torch.utils import _pytree as pytree
    base = get_smoke_arch(arch_id)
    patches = seq // 4 if base.frontend == "patch" else 0
    tokens = seq // 4 if base.encdec else seq - patches
    out = {}
    for run, mode, steps, layout in SCHEDULES[arch_id]:
        arch = base if mode == "discrete" else base.with_(node=NodeConfig(
            mode="node", method="euler", grad_mode="symplectic"))
        tcfg = TrainConfig(param_dtype=dtype)
        state = init_train_state(arch, tcfg, device="cpu")
        kw = {}
        if mesh is not None:
            state = reshard_state(state, mesh, state_specs(
                state, mesh, ep=layout == "ep",
                extra_replicated=MAMBA_PARAM_NAMES if layout == "whole"
                else frozenset()))
            kw = {"shard": make_sharder(mesh),
                  "grad_constraint": Zero1(mesh, state)}
        step = make_train_step(arch, tcfg, lr_fn=cosine_schedule(3e-4, 5, 3),
                               **kw)
        pipe = iter(TokenPipeline(batch, tokens, arch.vocab, device="cpu"))
        rows = []
        with _routing(None if forced is None else forced[run]["routes"]) \
                as calls:
            for i in range(steps):
                b = next(pipe)
                if patches:
                    b["patch_embeds"] = torch.randn(
                        (batch, patches, arch.d_frontend),
                        generator=torch.Generator().manual_seed(i)).to(
                            getattr(torch, dtype))
                if arch.encdec:
                    b["frames"] = torch.randn(
                        (batch, seq, arch.d_frontend),
                        generator=torch.Generator().manual_seed(i)).to(
                            getattr(torch, dtype))
                if arch_id == "xlstm-1.3b":
                    b["labels"][:, tokens // 2:] = IGNORE
                state, m = step(state, b)
                rows.append((float(m["loss"]), float(m["grad_norm"])))
        digest = None
        if mesh is not None:
            h = hashlib.sha256()
            for leaf, split in zip(pytree.tree_leaves(state.params),
                                   tensor.model_split(state.params, mesh)):
                if not split:
                    h.update(local_tensor(leaf).numpy().tobytes())
            digest = h.hexdigest()
        out[run] = {"rows": rows, "routes": [c.clone() for c in calls],
                    "digest": digest}
        del state, step
    return out


def _rank(rank, port, d, arch_id, batch, seq, mutate):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    torch.set_num_threads(1)
    if mutate != "none":
        _mutate(mutate)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    forced = torch.load(os.path.join(d, "one32.pt"))
    runs = _runs(arch_id, batch, seq, make_debug_mesh(1, 2,
                                                      device_type="cpu"),
                 forced=forced)
    dist.destroy_process_group()
    with open(os.path.join(d, f"tp_{rank}.json"), "w") as f:
        json.dump({k: {"rows": v["rows"], "digest": v["digest"]}
                   for k, v in runs.items()}, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list(SCHEDULES))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--mutate", default="none",
                    choices=("none",) + MUTATIONS)
    args = ap.parse_args()
    import torch

    from repro_torch.float64 import lifted
    one32 = _runs(args.arch, args.batch, args.seq)
    with lifted():
        one64 = _runs(args.arch, args.batch, args.seq, dtype="float64",
                      forced=one32)
    with tempfile.TemporaryDirectory() as d:
        torch.save({k: {"routes": v["routes"]} for k, v in one32.items()},
                   os.path.join(d, "one32.pt"))
        port = str(_free_port())
        procs = [subprocess.Popen([sys.executable, __file__, "--rank",
                                   str(r), port, d, args.arch,
                                   str(args.batch), str(args.seq),
                                   args.mutate]) for r in range(2)]
        if any(p.wait(timeout=900) for p in procs):
            sys.exit("a rank failed")
        tp = []
        for r in range(2):
            with open(os.path.join(d, f"tp_{r}.json")) as f:
                tp.append(json.load(f))
    worst = {}
    for run in one32:
        alike = tp[0][run]["digest"] == tp[1][run]["digest"]
        print(f"{run}: the ranks' unsplit params "
              f"{'agree bitwise' if alike else 'DIFFER'}")
        worst["ranks_agree"] = worst.get("ranks_agree", True) and alike
        for i, (a, b, c) in enumerate(zip(tp[0][run]["rows"],
                                          one32[run]["rows"],
                                          one64[run]["rows"])):
            for k, name in enumerate(("loss", "grad_norm")):
                errs = {"tp32_vs_f64": abs(a[k] - c[k]) / abs(c[k]),
                        "one32_vs_f64": abs(b[k] - c[k]) / abs(c[k]),
                        "tp32_vs_one32": abs(a[k] - b[k]) / abs(b[k])}
                print(f"{run} step {i} {name}: "
                      + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
                for n, e in errs.items():
                    key = f"{name} {n}"
                    worst[key] = max(worst.get(key, 0.0), e)
    print(json.dumps(worst))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
              int(sys.argv[6]), int(sys.argv[7]), sys.argv[8])
    else:
        main()
