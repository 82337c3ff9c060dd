"""How far a float32 tensor-parallel training step lies from the one-process
float32 step, against a float64 reference, on the CPU: the rounding under
``chip_smoke.py`` phase 52's comparison with phase 32, whose bounds a
tensor-parallel fault (a partial gradient left unsummed) must exceed.

    PYTHONPATH=src python tools/tp_rounding.py [--seq 64] [--batch 8]

Runs phase 52's schedule at the smoke qwen3-0.6b: 2 discrete steps (remat)
and 1 node-symplectic step (euler, one step per unit) from the seed-0
state, on the launcher's 3-step cosine schedule, three ways: on a
("data" 1, "model" 2) mesh of 2 gloo ranks in float32, in one process in
float32, and in one process in float64 with the float32 casts lifted
(``repro_torch.float64.lifted``).  Prints, per step, the relative
difference of loss and grad_norm between each float32 run and the float64
one and between the two float32 runs, and their maxima as the last line
(JSON).
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _runs(batch, seq, mesh=None, dtype="float32"):
    """{mode: [(loss, grad_norm) per step]} of phase 52's schedule."""
    import torch

    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import NodeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.optim import cosine_schedule
    from repro_torch.parallel import make_sharder, state_specs
    from repro_torch.runtime import reshard_state
    from repro_torch.train import TrainConfig, init_train_state, \
        make_train_step
    from repro_torch.train.data_parallel import Zero1
    base = get_smoke_arch("qwen3-0.6b")
    out = {}
    for mode, steps in (("discrete", 2), ("node_symplectic", 1)):
        arch = base if mode == "discrete" else base.with_(node=NodeConfig(
            mode="node", method="euler", grad_mode="symplectic"))
        tcfg = TrainConfig(param_dtype=dtype)
        state = init_train_state(arch, tcfg, device="cpu")
        kw = {}
        if mesh is not None:
            state = reshard_state(state, mesh, state_specs(state, mesh))
            kw = {"shard": make_sharder(mesh),
                  "grad_constraint": Zero1(mesh, state)}
        step = make_train_step(arch, tcfg, lr_fn=cosine_schedule(3e-4, 5, 3),
                               **kw)
        pipe = iter(TokenPipeline(batch, seq, arch.vocab, device="cpu"))
        rows = []
        for _ in range(steps):
            state, m = step(state, next(pipe))
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        out[mode] = rows
        del state, step
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return out


def _rank(rank, port, out, batch, seq):
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    rows = _runs(batch, seq, make_debug_mesh(1, 2, device_type="cpu"))
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(rows, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()
    from repro_torch.float64 import lifted
    one32 = _runs(args.batch, args.seq)
    with lifted():
        one64 = _runs(args.batch, args.seq, dtype="float64")
    with tempfile.TemporaryDirectory() as d:
        out, port = os.path.join(d, "tp.json"), str(_free_port())
        procs = [subprocess.Popen([sys.executable, __file__, "--rank",
                                   str(r), port, out, str(args.batch),
                                   str(args.seq)]) for r in range(2)]
        if any(p.wait(timeout=600) for p in procs):
            sys.exit("a rank failed")
        with open(out) as f:
            tp32 = json.load(f)
    worst = {}
    for mode in one32:
        for i, (a, b, c) in enumerate(zip(tp32[mode], one32[mode],
                                          one64[mode])):
            for k, name in enumerate(("loss", "grad_norm")):
                errs = {"tp32_vs_f64": abs(a[k] - c[k]) / abs(c[k]),
                        "one32_vs_f64": abs(b[k] - c[k]) / abs(c[k]),
                        "tp32_vs_one32": abs(a[k] - b[k]) / abs(b[k])}
                print(f"{mode} step {i} {name}: "
                      + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
                for n, e in errs.items():
                    key = f"{name} {n}"
                    worst[key] = max(worst.get(key, 0.0), e)
    print(json.dumps(worst))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5]),
              int(sys.argv[6]))
    else:
        main()
