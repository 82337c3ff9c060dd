"""An SPMD world of gloo ranks on the CPU for the port's mesh tests.

    results = run_world("torch_world_cases:solve_cases", world=4)

starts ``world`` processes of this file (``python tests/torch_world.py``),
each of which joins a gloo process group on ``tcp://127.0.0.1:<free
port>``, calls the named function with no arguments (``TORCH_WORLD_TMP`` names a
directory every rank shares), and writes the dict
of ``{case: "ok" | error text}`` it returns to a JSON file.  A case that
raises inside the function is the function's to catch (each rank must go
on calling the same collectives, so a case records its error and the next
case runs).  ``run_world`` returns the per-rank dicts, rank 0 first; a rank
that dies or hangs fails the call with its output.

Mesh tests run on the CPU this way (``torch.distributed`` with the gloo
backend, ``device_type="cpu"`` meshes): JAX's forced host devices have no
counterpart, and a world of processes is what the card runs as well.
"""
from __future__ import annotations

import importlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import traceback

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(target: str, world: int, timeout: float = 300.0):
    """Run ``module:function`` on ``world`` gloo ranks; returns the list of
    each rank's result dict."""
    port = _free_port()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               PYTHONPATH=os.pathsep.join([str(SRC), str(HERE),
                                           os.environ.get("PYTHONPATH",
                                                          "")]),
               OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        env["TORCH_WORLD_TMP"] = tmp
        procs = [subprocess.Popen(
            [sys.executable, __file__, target, str(r), str(world), str(port),
             tmp], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(procs)
               if p.returncode != 0]
        if bad:
            raise AssertionError(
                f"world {target} x{world}: ranks {bad} failed\n"
                + "\n".join(f"--- rank {r} ---\n{o[-6000:]}"
                            for r, o in enumerate(outs)))
        return [json.loads(pathlib.Path(tmp, f"rank_{r}.json").read_text())
                for r in range(world)]


def _rank_main(target, rank, world, port, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mod, fn = target.split(":")
        result = getattr(importlib.import_module(mod), fn)()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    pathlib.Path(out_dir, f"rank_{rank}.json").write_text(json.dumps(result))


def case(results: dict, name: str, fn, *args) -> None:
    """Run one case, recording "ok" or its error under ``name``."""
    try:
        fn(*args)
        results[name] = "ok"
    except Exception:  # noqa: BLE001 - the error text is the result
        results[name] = traceback.format_exc()[-3000:]


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
               int(sys.argv[4]), sys.argv[5])
