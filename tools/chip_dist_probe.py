"""Which ``torch.distributed`` collectives work on this machine's card, for
2 ranks sharing one GPU over gloo (the layout of ``chip_smoke.py`` phase
38) and for a world of 1 over NCCL.

    python3 tools/chip_dist_probe.py

Each case runs in a rank process of its own and prints one line per
collective ("ok" or the error); a rank that crashes (a segfault shows as
return code -11) is reported with its return code, and the lines it
printed before the crash show how far it got.  Exits 0 when every rank
returned 0.
"""
import faulthandler
import os
import socket
import subprocess
import sys


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank(rank: int, world: int, port: int, backend: str) -> None:
    import torch
    import torch.distributed as dist
    faulthandler.enable()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)

    def run(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            print(f"{backend} x{world} rank {rank} {name}: ok", flush=True)
        except Exception as e:  # noqa: BLE001 - the error is the result
            print(f"{backend} x{world} rank {rank} {name}: "
                  f"{type(e).__name__}: {str(e)[:160]}", flush=True)

    x = torch.arange(8, dtype=torch.float64, device=dev) + rank
    run("all_reduce", lambda: dist.all_reduce(x.clone()))
    run("all_gather", lambda: dist.all_gather(
        [torch.empty_like(x) for _ in range(world)], x))
    run("reduce_scatter", lambda: dist.reduce_scatter(
        torch.empty(8 // world, dtype=x.dtype, device=dev),
        list(x.chunk(world))))
    run("reduce", lambda: dist.reduce(x.clone(), dst=0))
    run("broadcast", lambda: dist.broadcast(x.clone(), 0))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    box = {}
    run("init_device_mesh", lambda: box.update(mesh=init_device_mesh(
        "cuda", (world,), mesh_dim_names=("data",))))
    run("DTensor.from_local", lambda: box.update(d=DTensor.from_local(
        torch.ones(4, 3, device=dev, dtype=torch.float64) * rank,
        box["mesh"], [Shard(0)], run_check=False)))
    run("DTensor.full_tensor", lambda: box["d"].full_tensor())
    dist.destroy_process_group()


def main() -> int:
    import torch
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    bad = 0
    for backend, world in (("nccl", 1), ("gloo", 2)):
        port = str(_free_port())
        procs = [subprocess.Popen([sys.executable, __file__, "--rank",
                                   str(r), str(world), port, backend],
                                  env=dict(os.environ))
                 for r in range(world)]
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                rc = p.wait()
            print(f"{backend} x{world} rank {r}: return code {rc}",
                  flush=True)
            bad += rc != 0
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
              sys.argv[5])
    else:
        sys.exit(main())
