"""Train a continuous normalizing flow on tabular data (paper Sec. 5.1).

FFJORD-style CNF with dopri5 and the symplectic adjoint (or any other
registered gradient strategy: ``--grad-mode``), plain SGD, on the synthetic
stand-ins for the paper's UCI datasets (data/tabular.py), at the widths of
the JAX package's ``examples/cnf_tabular.py``:

    PYTHONPATH=src python -m repro_torch.launch.train_cnf \\
        --dataset miniboone --steps 200 [--adaptive [--per-sample]] \\
        [--grad-mode symplectic|backprop|remat_step|remat_solve|adjoint] \\
        [--device cpu]

Runs on ``cuda`` unless ``--device`` says otherwise.  ``main`` returns the
per-step history (loss, gradient norm, seconds) it prints.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import GRADIENT_REGISTRY
from repro_torch.data.tabular import PAPER_DIMS, PAPER_M, make_tabular_dataset
from repro_torch.models.cnf import CNFConfig, cnf_nll, init_cnf

def make_config(dataset: str, *, grad_mode: str = "symplectic",
                adaptive: bool = False, n_steps: int = 8,
                hidden: Sequence[int] = (64, 64),
                per_sample: bool = False) -> CNFConfig:
    """The example's configuration for ``dataset``: dopri5 with the
    Hutchinson trace, fixed grid of ``n_steps`` or adaptive rtol 1e-4 /
    atol 1e-6 / max_steps 48 (with ``per_sample``, a controller per
    sample)."""
    return CNFConfig(dim=PAPER_DIMS[dataset], hidden=tuple(hidden),
                     n_components=PAPER_M[dataset], trace="hutchinson",
                     method="dopri5", grad_mode=grad_mode, n_steps=n_steps,
                     adaptive=adaptive, rtol=1e-4, atol=1e-6, max_steps=48,
                     per_sample=per_sample)


def train(cfg: CNFConfig, data, *, steps: int, batch: int, lr: float,
          device="cuda", seed: int = 0,
          label: str = "") -> List[Dict[str, float]]:
    """``steps`` float32 SGD steps of ``cnf_nll`` on consecutive batches of
    ``data`` (numpy, (n, dim)), from weights and Hutchinson noise seeded
    with ``seed``.  Returns one record per step."""
    dtype = torch.float32
    params = init_cnf(cfg, seed=seed, device=device, dtype=dtype)
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    noise = torch.Generator(device=device).manual_seed(seed)
    n_batches = max(1, len(data) // batch - 1)
    history = []
    t_start = time.perf_counter()
    for i in range(steps):
        lo = (i % n_batches) * batch
        u = torch.as_tensor(data[lo:lo + batch], dtype=dtype, device=device)
        eps = torch.randn(u.shape, generator=noise, dtype=dtype,
                          device=device)
        nll = cnf_nll(params, u, eps, cfg)
        grads = torch.autograd.grad(nll, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(g, alpha=lr)
        gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                              for g in grads))
        rec = {"step": i, "nll": float(nll.detach()), "grad_norm": gnorm,
               "seconds": time.perf_counter() - t_start}
        history.append(rec)
        if i % 25 == 0 or i == steps - 1:
            print(f"[cnf{label} M={cfg.n_components} {cfg.grad_mode}] "
                f"step {i:4d} nll {rec['nll']:8.4f} "
                f"|g| {gnorm:9.4f} {rec['seconds']:6.1f}s")
    return history


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="miniboone",
                    choices=sorted(PAPER_DIMS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--grad-mode", default="symplectic",
                    choices=sorted(GRADIENT_REGISTRY),
                    help="gradient strategy (core/api.py; remat_step and "
                         "remat_solve take a fixed grid only)")
    ap.add_argument("--adaptive", action="store_true",
                    help="dopri5 adaptive stepping (the paper's setting)")
    ap.add_argument("--n-steps", type=int, default=8,
                    help="fixed-grid steps (without --adaptive)")
    ap.add_argument("--per-sample", action="store_true",
                    help="with --adaptive: a step controller per sample "
                         "(solve(..., batch_axis=0))")
    ap.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = make_config(args.dataset, grad_mode=args.grad_mode,
                      adaptive=args.adaptive, n_steps=args.n_steps,
                      hidden=args.hidden, per_sample=args.per_sample)
    data = make_tabular_dataset(args.dataset, n=args.batch * 8)
    history = train(cfg, data, steps=args.steps, batch=args.batch,
                    lr=args.lr, device=args.device,
                    label=f":{args.dataset}")
    print("done")
    return history


if __name__ == "__main__":
    main()
