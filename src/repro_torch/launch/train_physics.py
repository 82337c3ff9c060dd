"""Learn KdV (or Cahn-Hilliard) dynamics with an HNN++ energy net (paper
Sec. 5.2, reduced), the port of the JAX package's
``examples/physics_kdv.py``.

Dormand-Prince 8 (12 stages) + the symplectic adjoint (or any registered
gradient strategy: ``--grad-mode``), plain SGD on one-interval pairs
(``physics_loss``), then the held-out trajectory observed through ONE
``SaveAt(ts=...)`` solve over 7 snapshot intervals (``rollout``):

    PYTHONPATH=src python -m repro_torch.launch.train_physics \\
        --system kdv --steps 150 \\
        [--grad-mode symplectic|backprop|remat_step|remat_solve|adjoint] \\
        [--device cpu]

Runs on ``cuda`` unless ``--device`` says otherwise.  The settings are the
example's (grid 64, dx 0.5, channels 16, hidden 64, n_steps 4, 6
trajectories x 16 snapshots of 80 RK4 substeps, batch 32, lr 3e-3).
``main`` returns the per-step history and the rollout's MSE per horizon;
``train`` and ``held_out_rollout`` take any ``PhysicsConfig`` and data.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Dict, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import GRADIENT_REGISTRY
from repro_torch.data.physics_gen import generate_trajectories
from repro_torch.models.physics import (PhysicsConfig, init_energy_net,
                                        physics_loss, rollout)

HORIZON = 7          # snapshot intervals of the held-out rollout


def train(cfg: PhysicsConfig, trajs, *, steps: int, batch: int, lr: float,
          device="cuda", seed: int = 0):
    """``steps`` float32 SGD steps of ``physics_loss`` on the one-interval
    pairs of all trajectories but the last (numpy ``trajs``, (n_traj,
    n_snapshots, grid)).  Returns (params, one record per step)."""
    dtype = torch.float32
    grid = cfg.grid
    u_k = torch.as_tensor(trajs[:-1, :-1].reshape(-1, grid), dtype=dtype,
                          device=device)
    u_k1 = torch.as_tensor(trajs[:-1, 1:].reshape(-1, grid), dtype=dtype,
                           device=device)
    params = init_energy_net(cfg, seed=seed, device=device, dtype=dtype)
    leaves = pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    history = []
    t_start = time.perf_counter()
    for i in range(steps):
        lo = (i * batch) % max(1, u_k.shape[0] - batch)
        mse = physics_loss(params, u_k[lo:lo + batch], u_k1[lo:lo + batch],
                           cfg)
        grads = torch.autograd.grad(mse, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(g, alpha=lr)
        gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                              for g in grads))
        rec = {"step": i, "mse": float(mse.detach()), "grad_norm": gnorm,
               "seconds": time.perf_counter() - t_start}
        history.append(rec)
        if i % 25 == 0 or i == steps - 1:
            print(f"[{cfg.system} {cfg.method} {cfg.grad_mode}] step "
                  f"{i:4d} one-step mse {rec['mse']:.6f} "
                  f"{rec['seconds']:6.1f}s")
    return params, history


def held_out_rollout(params, trajs, cfg: PhysicsConfig, device="cuda",
                     horizon: int = HORIZON):
    """MSE per horizon of ONE SaveAt(ts) solve from the last trajectory's
    first snapshot, against its next ``horizon`` snapshots."""
    u0 = torch.as_tensor(trajs[-1, 0:1], dtype=torch.float32, device=device)
    want = torch.as_tensor(trajs[-1, 1:horizon + 1], dtype=torch.float32,
                           device=device)
    with torch.no_grad():
        preds = rollout(params, u0, cfg, horizon)
    return [float(e) for e in torch.mean((preds[:, 0] - want) ** 2, dim=-1)]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--system", default="kdv",
                    choices=["kdv", "cahn_hilliard"])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--grad-mode", default="symplectic",
                    choices=sorted(GRADIENT_REGISTRY),
                    help="gradient strategy (core/api.py)")
    ap.add_argument("--method", default="dopri8")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = PhysicsConfig(system=args.system, method=args.method,
                        grad_mode=args.grad_mode)
    print(f"generating {args.system} trajectories...")
    trajs = generate_trajectories(args.system, n_traj=6, grid=cfg.grid,
                                  n_snapshots=16, substeps=80)
    params, history = train(cfg, trajs, steps=args.steps, batch=32,
                            lr=args.lr, device=args.device)
    errs = held_out_rollout(params, trajs, cfg, args.device)
    print("rollout MSE per horizon:", " ".join(f"{e:.5f}" for e in errs))
    return {"history": history, "rollout_mse": errs, "params": params}


if __name__ == "__main__":
    main()
