"""Run chosen phases of ``chip_smoke.py`` for one or more source trees, one
process per tree in the order given, so that two versions of the port are
compared on one card in turns (parent, change, change, parent).

    python3 tools/chip_phases.py --trees runs/parent . . runs/parent \\
        --phases 31 32 33 34 35

A tree is a directory holding ``chip_smoke.py`` and ``src/`` (for the
parent commit: ``git archive <commit> | tar -x -C runs/parent``).  Each run
builds the kernels (phase 1), then calls the phases' functions of that
tree's ``chip_smoke.py``; 35 runs 36 after it; 40 takes phase 32's
metrics when 32 runs before it in the list, else it runs phase 32 first,
in its own process, to compare with.  Each run's whole output goes
to ``<log-dir>/phases_<i>.log`` (``--log-dir``, default ``runs/phases``);
the lines that carry numbers are printed.  Exits 1 when a run fails.
"""
import argparse
import os
import pathlib
import subprocess
import sys
import time

PHASES = {24: ["saveat_cells"],
          25: ["saveat_exactness"],
          31: ["backward_kernels_vs_plain"],
          32: ["lm_train_main_path"],
          33: ["lm_exactness"],
          34: ["lm_memory"],
          35: ["lm_resume", "lm_train_to_serve"],
          37: ["mesh_solve_phase"],
          38: ["mesh_gloo_phase"],
          39: ["mesh_engine_phase"],
          40: ["mesh_train_phase"],
          41: ["analysis_phase"],
          52: ["mesh_tp_phase"],
          53: ["zoo_tp_phase"],
          54: ["rec_tp_phase"]}
KEEP = ("==", "phase seconds", "s/step", "launches per step", "wall",
        "ms (device", "peak", "bitwise", "rel err", "dopri8 grid", "FAILED",
        "Error", "error", "ptxas flash_attention_bwd", "collectives",
        "rank", "req/s", "peak", "recorder", "analysis", "error(s)")


def _child(tree: str, names):
    root = pathlib.Path(tree).resolve()
    os.chdir(root)
    sys.path.insert(0, str(root))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as cs
    cs.build()
    out, train = None, None
    for name in names:
        t = time.perf_counter()
        fn = getattr(cs, name)
        if name == "lm_train_to_serve":
            out = fn(out)
        elif name == "mesh_train_phase":
            out = fn(train)
        else:
            out = fn()
        if name == "lm_train_main_path":
            train = out
        print(f"phase seconds {name} {time.perf_counter() - t:.1f}",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--phases", nargs="+", type=int, required=True,
                    choices=sorted(PHASES))
    ap.add_argument("--log-dir", default="runs/phases")
    args = ap.parse_args(argv)
    names = [n for p in args.phases for n in PHASES[p]]
    out_dir = pathlib.Path(args.log_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    bad = 0
    for i, tree in enumerate(args.trees):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--child", tree,
                               *names], capture_output=True, text=True)
        log = out_dir / f"phases_{i}.log"
        log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        print(f"### run {i}: tree {tree} rc {proc.returncode} "
              f"{time.perf_counter() - t:.1f} s (log {log})", flush=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            if any(k in line for k in KEEP):
                print("  " + line[:400])
        bad += proc.returncode != 0
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        _child(sys.argv[2], sys.argv[3:])
    else:
        sys.exit(main())
