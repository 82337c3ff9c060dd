"""LM training launcher with fault tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        [--smoke] [--steps 20 | --epochs 3 --steps-per-epoch 20] \\
        [--grad-mode symplectic --node-method euler] \\
        [--ckpt-dir runs/ckpt --ckpt-every 10 [--resume]] \\
        [--metrics-out runs/metrics.jsonl] [--device cpu] [--layers 14]

The JAX launcher's flags, plus ``--device`` (default ``cuda``; raises when
there is no CUDA device) and ``--layers`` (the depth cut to whole repeat
units at full width, as ``launch.serve lm --layers``).  ``--grad-mode``
trains the arch in node mode (the paper: depth as ODE time,
``--node-method`` with one step per repeat unit) with that gradient
strategy; without it the discrete stack trains.
``--mesh debug`` trains data-parallel with ZeRO-1 over a ("data", "model")
mesh (``launch.mesh.make_debug_mesh``): (2, 2) on a world of 4, JAX's
default, which is also tensor-parallel over "model" (every arch of the
zoo: the GQA and MLA decoders, dense or MoE, the patch frontend, Mamba,
the xLSTM and the enc-dec model, whose source frames are drawn per step:
``parallel.tensor``), else (world, 1); one
process per rank, started by ``torchrun --nproc-per-node N`` (or alone: a
world of 1), each data rank taking its rows of the one global batch, so
the run equals the single-process run (bitwise on a world of 1, to
rounding otherwise); ``--microbatches`` and ``--compression`` run there in
JAX's order.  The state is laid out by ``parallel.state_specs`` and
checkpoints hold full arrays, written by rank 0.  ``--mesh pod`` and
``multipod`` (the TPU pod layouts) raise; the JAX launcher's
``--tpu-flags`` (XLA flags for TPU collectives) has no counterpart here and
is not taken.

The full train state (``train.TrainState``: params, AdamW state with the
schedule step, the training generator's state, the data cursor, solver
counters, compression error feedback) is checkpointed as one tree through
``runtime.Checkpointer`` with async saves.  On boot the launcher restores the
newest valid checkpoint if there is one; ``--resume`` makes that mandatory
(exit 3 without one).  The data pipeline is keyed by step, so the token
stream resumes exactly, and on ``cuda`` the launcher sets
``torch.use_deterministic_algorithms(True)`` and ``CUBLAS_WORKSPACE_CONFIG``
before CUDA starts, so that a resumed run is bit-identical to an
uninterrupted one.  ``--metrics-out`` appends one JSON line per step
(flushed, so a killed run leaves a complete prefix); ``--fail-at-step``
injects one failure into a step (retried by ``run_with_retries``) and
``--step-delay-s`` paces the loop for the fault-injection tests.  ``main``
returns the metrics rows, each step's seconds (host clock around the step
and the read of its metrics), the final state and the arch.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence


def _args(argv):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=20,
                    help="total steps (ignored when --steps-per-epoch is "
                    "given)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--steps-per-epoch", type=int, default=None,
                    help="with --epochs: total = epochs * steps_per_epoch")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "constant"])
    ap.add_argument("--grad-mode", default=None,
                    help="node-mode gradient scheme (symplectic/...)")
    ap.add_argument("--node-method", default="euler")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true",
                    help="REQUIRE a valid checkpoint in --ckpt-dir and "
                    "boot from it (without this flag a present checkpoint "
                    "is still used, but an empty dir starts fresh)")
    ap.add_argument("--metrics-out", default=None,
                    help="append one JSON line per step (step/epoch/loss/"
                    "grad_norm/lr), flushed — for resume-divergence checks")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "pod", "multipod", "debug"])
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a failure (fault-tolerance demo)")
    ap.add_argument("--step-delay-s", type=float, default=0.0,
                    help="sleep after each step — paces the loop so the "
                    "fault harness can SIGKILL mid-epoch deterministically")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a whole "
                    "number of the arch's repeat units), at full width, "
                    "as launch.serve lm --layers")
    return ap.parse_args(argv)


def _join_world(device) -> bool:
    """Join the process group torchrun describes (``env://``), or make a
    world of 1 on a free localhost port; True when this call made it."""
    import socket

    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        dist.init_process_group(backend,
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=1, rank=0)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    return True


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = _args(argv)
    if args.device.startswith("cuda"):
        # before CUDA starts: cuBLAS picks deterministic reductions only
        # with a fixed workspace
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    from repro_torch.configs import get_arch, get_smoke_arch
    from repro_torch.configs.base import NodeConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.optim import (CompressionConfig, constant_schedule,
                                   cosine_schedule, wsd_schedule)
    from repro_torch.runtime import Checkpointer, RetryConfig, \
        run_with_retries
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)

    from repro_torch.launch.mesh import (make_debug_mesh,
                                         make_production_mesh)
    from repro_torch.parallel import comm, make_sharder, state_specs
    from repro_torch.runtime import mesh_shardings, reshard_state
    from repro_torch.train.data_parallel import Zero1, local_tensor

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to train on the CPU)")
        if device.index is None and "LOCAL_RANK" in os.environ:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.use_deterministic_algorithms(True)
    mesh, own_world = None, False
    if args.mesh in ("pod", "multipod"):
        make_production_mesh(multi_pod=args.mesh == "multipod")
    elif args.mesh == "debug":
        import torch.distributed as dist
        own_world = _join_world(device)
        world = dist.get_world_size()
        # a world of 4 takes JAX's make_debug_mesh() default, (2, 2): data
        # and tensor parallel; other worlds are all data
        mesh = make_debug_mesh(*((2, 2) if world == 4 else (world, 1)),
                               device_type=device.type)
    writer = comm.is_writer()
    arch = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    if args.layers is not None:
        arch = arch.with_(n_layers=args.layers)
        if arch.n_repeats < 1:     # n_repeats raises for a part of a unit
            raise ValueError(f"--layers {args.layers}: no whole unit")
    if args.grad_mode:
        arch = arch.with_(node=NodeConfig(mode="node",
                                          method=args.node_method,
                                          grad_mode=args.grad_mode))
    tcfg = TrainConfig(lr=args.lr, microbatches=args.microbatches,
                       compression=CompressionConfig(mode=args.compression))

    if args.steps_per_epoch is not None:
        total_steps = args.epochs * args.steps_per_epoch
        steps_per_epoch = args.steps_per_epoch
    else:
        total_steps = args.steps
        steps_per_epoch = max(1, (args.steps + args.epochs - 1)
                              // args.epochs)

    sched = {"cosine": lambda: cosine_schedule(args.lr, 5, total_steps),
             "wsd": lambda: wsd_schedule(args.lr, 5,
                                         int(total_steps * 0.7),
                                         int(total_steps * 0.25)),
             "constant": lambda: constant_schedule(args.lr)}[args.schedule]()

    state = init_train_state(arch, tcfg, device=device)
    specs = state_specs(state, mesh) if mesh is not None else None
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = Checkpointer(args.ckpt_dir, keep=3, async_save=True)
        latest = ckpt.latest_step()
        if latest is None and args.resume:
            print(f"[train] --resume: no valid checkpoint in "
                  f"{args.ckpt_dir}", file=sys.stderr)
            sys.exit(3)
        if latest is not None:
            state, start_step = ckpt.restore(
                state, shardings=None if mesh is None
                else mesh_shardings(mesh, specs))
            # the data cursor IS the checkpoint step: the pipeline resumes
            # the exact sample stream
            assert int(local_tensor(state["data_step"])) == start_step, \
                (int(local_tensor(state["data_step"])), start_step)
            print(f"[train] resumed from step {start_step} "
                  f"(epoch {start_step // steps_per_epoch})")
    elif args.resume:
        print("[train] --resume requires --ckpt-dir", file=sys.stderr)
        sys.exit(3)

    if mesh is not None and start_step == 0:
        state = reshard_state(state, mesh, specs)
    step_fn = make_train_step(
        arch, tcfg, lr_fn=sched, shard=make_sharder(mesh),
        grad_constraint=None if mesh is None else Zero1(mesh, state))
    pipe = iter(TokenPipeline(args.global_batch, args.seq_len, arch.vocab,
                              start_step=start_step, device=str(device)))
    metrics_f = None
    if args.metrics_out and writer:
        out_dir = os.path.dirname(args.metrics_out)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        metrics_f = open(args.metrics_out, "a")

    rows, step_seconds = [], []
    t0 = time.time()
    epoch_losses = []
    for step in range(start_step, total_steps):
        batch = next(pipe)
        if arch.encdec:
            # the enc-dec model's source: random fbank-stacked frames (one
            # per target position), keyed by step, as the JAX launcher's
            batch["frames"] = torch.randn(
                (args.global_batch, args.seq_len, arch.d_frontend),
                generator=torch.Generator().manual_seed(step)).to(device)
        if arch.frontend == "patch":
            # the JAX launcher's 4 random patch embeddings, keyed by step
            batch["patch_embeds"] = torch.randn(
                (args.global_batch, 4, arch.d_frontend),
                generator=torch.Generator().manual_seed(step)).to(device)

        def do_step():
            if step == args.fail_at_step:
                args.fail_at_step = -1   # fail once
                raise RuntimeError("injected failure (demo)")
            return step_fn(state, batch)

        def on_failure():
            print(f"[train] step {step} failed; state intact, retrying")

        t_step = time.perf_counter()
        state, metrics = run_with_retries(do_step, RetryConfig(),
                                          on_failure)
        epoch = step // steps_per_epoch
        # reading the metrics waits for the step's device work
        row = {"step": step, "epoch": epoch, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"])}
        step_seconds.append(time.perf_counter() - t_step)
        rows.append(row)
        epoch_losses.append(row["loss"])
        if metrics_f is not None:
            # json round-trips python floats exactly (repr-based), so the
            # resume check compares bit-identical values
            metrics_f.write(json.dumps(row) + "\n")
            metrics_f.flush()
        if writer and (step % 5 == 0 or step == total_steps - 1):
            print(f"[train] step {step:5d} loss {row['loss']:.4f}"
                  f" gnorm {row['grad_norm']:.3f}"
                  f" lr {row['lr']:.2e}"
                  f" {time.time() - t0:.1f}s")
        if (step + 1) % steps_per_epoch == 0:
            if writer:
                print(f"[train] epoch {epoch} done: mean loss "
                      f"{sum(epoch_losses) / len(epoch_losses):.4f} "
                      f"({len(epoch_losses)} steps)")
            epoch_losses = []
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            # async: the host transfer is the only stall; the file write
            # overlaps the next step
            ckpt.save(step + 1, state, block=False)
        if args.step_delay_s:
            time.sleep(args.step_delay_s)
    if ckpt is not None:
        # the final state, unless the loop's last (async) save wrote it
        if start_step >= total_steps or total_steps % args.ckpt_every:
            ckpt.save(total_steps, state)
        ckpt.wait()
    if metrics_f is not None:
        metrics_f.close()
    sstats = {k: int(local_tensor(v)) for k, v in state["solver_stats"].items()}
    if writer:
        print(f"[train] done (solver stats {sstats})")
    if own_world:
        import torch.distributed as dist

        from repro_torch.parallel.layout import forget_groups
        dist.destroy_process_group()
        forget_groups()
    return {"rows": rows, "step_seconds": step_seconds, "state": state,
            "arch": arch}


if __name__ == "__main__":
    main()
