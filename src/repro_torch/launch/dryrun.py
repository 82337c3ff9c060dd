"""Dry run: what each (arch x shape) cell and each gradient strategy costs
in device memory, with nothing trained (the JAX package's
``repro.launch.dryrun``).

The JAX dry run lowers and compiles every cell on a 16x16 (or 2x16x16) TPU
pod mesh and reads memory and cost from the compiled module.  Those pod
layouts have no H100 counterpart (``launch.mesh.make_production_mesh``
raises), and eager PyTorch has no compiled module.  What is left per cell
is the state a card must hold, from a ``meta``-device init (nothing is
allocated): the parameters, and for a training shape their gradients and
the AdamW state (``optim.adamw``), or for a serving shape the KV caches;
against the card's memory (``launch.analysis.hbm_headroom``).  No
activations are counted.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k [--out runs/dryrun.jsonl] [--all]

``--analysis`` runs the ``repro_torch.analysis`` memory audit of every
registered gradient strategy under the integrators the named configs use
(``configs.NodeConfig`` for the node depth stack, ``models.cnf.CNFConfig``
for the CNF): one recorded loss+gradient at N and 8N fixed steps each,
the Table-1 table and its findings; exit 1 on a finding:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --analysis \\
        [--analysis-config node,cnf] [--out runs/analysis.jsonl] \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback

import torch
from torch.utils import _pytree as pytree

from repro_torch.analysis.traversal import tensor_bytes
from repro_torch.configs import (ARCH_IDS, SHAPES, NodeConfig,
                                 cell_is_applicable, get_arch)
from repro_torch.launch.analysis import (count_params, device_memory_bytes,
                                         hbm_headroom, model_flops_per_step)

__all__ = ["run_cell", "run_static_analysis", "iter_cells", "main",
           "active_params", "ANALYSIS_CONFIGS"]

ANALYSIS_CONFIGS = ("node", "cnf")


def _nbytes(tree) -> int:
    return sum(tensor_bytes(l) for l in pytree.tree_leaves(tree)
               if isinstance(l, torch.Tensor))


def run_cell(arch_id: str, shape_name: str, *, device="cuda",
             verbose: bool = True) -> dict:
    """The state bytes of one (arch, shape) cell on one card."""
    from repro_torch.models.lm import init_caches, init_lm
    from repro_torch.train.train_step import TrainConfig, init_train_state
    shape = SHAPES[shape_name]
    arch = get_arch(arch_id)
    B, S = shape.global_batch, shape.seq_len
    parts = {"params": 0, "grads": 0, "opt_state": 0, "caches": 0}
    if shape.kind == "train":
        state = init_train_state(arch, TrainConfig(), device="meta")
        params = state.params
        parts["params"] = _nbytes(params)
        parts["grads"] = parts["params"]
        parts["opt_state"] = _nbytes(state.opt)
        n_tokens = B * S
    else:
        params = init_lm(arch, device="meta")
        parts["params"] = _nbytes(params)
        parts["caches"] = _nbytes(init_caches(arch, B, S, device="meta"))
        n_tokens = B * S if shape.kind == "prefill" else B
    n_params = count_params(params)
    n_active = active_params(arch, n_params)
    total = sum(parts.values())
    capacity = device_memory_bytes(device)
    result = {"arch": arch_id, "shape": shape_name, "mesh": "1",
              "n_chips": 1, "kind": shape.kind, "n_params": n_params,
              "n_active_params": n_active, "n_tokens": n_tokens,
              "bytes_per_device": parts,
              "state_gb": round(total / 2**30, 3),
              "device_bytes": capacity,
              "hbm_headroom": hbm_headroom(total, capacity),
              "model_flops_global": model_flops_per_step(
                  n_active, n_tokens, shape.kind)}
    if verbose:
        print(json.dumps(result))
    return result


def active_params(arch, n_params: int) -> int:
    """The parameters one token meets: an MoE arch's experts beyond its
    top-k do not count (the JAX package's ``active_params``)."""
    if arch.moe_experts == 0:
        return n_params
    moe = arch.moe_config()
    per_expert = 3 * moe.d_ff * moe.d_model
    n_moe_layers = sum(1 for s in (list(arch.prefix)
                                   + list(arch.pattern) * arch.n_repeats)
                       if s.ffn == "moe")
    return n_params - n_moe_layers * (moe.n_experts - moe.top_k) * per_expert


def run_static_analysis(targets=ANALYSIS_CONFIGS, out=None,
                        verbose: bool = True, device="cuda") -> list:
    """Per-strategy memory audit of the named model configs.

    For each named config this reads off the integrator it uses
    (configs/base.py NodeConfig for the node depth stack, models/cnf.py
    CNFConfig for the CNF likelihood solves), then asks
    ``repro_torch.analysis`` for the Table-1 memory table of every
    registered gradient strategy under that integrator: one loss+gradient
    recorded at N and 8N fixed steps each, peak live bytes read off the
    recorder."""
    from repro_torch.analysis.memory import (memory_findings, memory_rows,
                                             memory_table_markdown)
    from repro_torch.models.cnf import CNFConfig

    methods = {}
    if "node" in targets:
        methods.setdefault(NodeConfig().method, []).append("node")
    if "cnf" in targets:
        methods.setdefault(CNFConfig(dim=4).method, []).append("cnf")
    if not methods:
        raise SystemExit(f"--analysis: no known config in {targets!r}; "
                         f"have {ANALYSIS_CONFIGS}")

    rows = memory_rows(methods=tuple(sorted(methods)), device=device)
    findings = memory_findings(rows)
    capacity = device_memory_bytes(device)
    results = []
    for r in rows:
        results.append({"mode": "static_analysis",
                        "configs": methods[r.method],
                        "strategy": r.strategy, "method": r.method,
                        "peak_bytes_small": r.peak_small,
                        "peak_bytes_big": r.peak_big,
                        "n_small": r.n_small, "n_big": r.n_big,
                        "growth": round(r.growth, 3),
                        **hbm_headroom(r.peak_big, capacity)})
    if verbose:
        used = ", ".join(f"{m} <- {'+'.join(cs)}"
                         for m, cs in sorted(methods.items()))
        print(f"per-strategy memory audit on {device} (integrators: {used})")
        print(memory_table_markdown(rows))
        for f in findings:
            print(str(f))
    if out:
        with open(out, "a") as fh:
            for res in results:
                fh.write(json.dumps(res) + "\n")
    if findings:
        print(f"FAILED: {len(findings)} memory-bound findings",
              file=sys.stderr)
        sys.exit(1)
    print("static analysis OK")
    return results


def iter_cells():
    for arch_id in ARCH_IDS:
        for shape_name in SHAPES:
            if cell_is_applicable(arch_id, shape_name):
                yield arch_id, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true",
                    help="the JAX package's 2x16x16 pod cell: no H100 "
                         "counterpart, raises")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the JAX package's 16x16 and 2x16x16 pod cells: "
                         "no H100 counterpart, raises")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape) cell")
    ap.add_argument("--analysis", action="store_true",
                    help="per-strategy memory audit (repro_torch.analysis) "
                         "of the named configs")
    ap.add_argument("--analysis-config", default=",".join(ANALYSIS_CONFIGS),
                    help="comma list of configs for --analysis: node, cnf")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    if args.multipod or args.both_meshes:
        from repro_torch.launch.mesh import make_production_mesh
        make_production_mesh(multi_pod=True)
    if args.analysis:
        return run_static_analysis(
            tuple(t for t in args.analysis_config.split(",") if t),
            out=args.out, device=args.device)

    cells = list(iter_cells()) if args.all else [(args.arch, args.shape)]
    failures, results = [], []
    for arch_id, shape_name in cells:
        try:
            res = run_cell(arch_id, shape_name, device=args.device)
        except Exception as e:  # noqa: BLE001 -- one cell's fault is a row
            res = {"arch": arch_id, "shape": shape_name,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            failures.append((arch_id, shape_name))
            print(json.dumps({k: res[k] for k in
                              ("arch", "shape", "error")}))
        results.append(res)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res, default=str) + "\n")
    if failures:
        print(f"FAILED cells: {failures}", file=sys.stderr)
        sys.exit(1)
    print("dry-run OK")
    return results


if __name__ == "__main__":
    main()
