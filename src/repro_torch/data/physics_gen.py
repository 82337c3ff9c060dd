"""Ground-truth PDE trajectory generation (KdV, Cahn-Hilliard).

Fine-step RK4 on periodic finite-difference discretizations; snapshots at
interval ``dt`` form (u_k, u_{k+1}) training pairs, matching the HNN++
experimental protocol the paper follows (Sec. 5.2).

This module is numpy-only and is the PyTorch package's own copy of the JAX
package's generator: the same seed gives the same arrays.
"""
from __future__ import annotations

import numpy as np


def _dx(u, dx):
    return (np.roll(u, -1, -1) - np.roll(u, 1, -1)) / (2 * dx)


def _lap(u, dx):
    return (np.roll(u, -1, -1) - 2 * u + np.roll(u, 1, -1)) / (dx * dx)


def _kdv_rhs(u, dx, delta2=0.022 ** 2 * 100):
    return -u * _dx(u, dx) - delta2 * _dx(_lap(u, dx), dx)


def _ch_rhs(u, dx, gamma=0.01):
    return _lap(u ** 3 - u - gamma * _lap(u, dx), dx)


def generate_trajectories(system: str, n_traj: int = 8, grid: int = 64,
                          dx: float = 0.5, dt: float = 0.1,
                          n_snapshots: int = 32, seed: int = 0,
                          substeps: int = 200):
    """Returns snapshots (n_traj, n_snapshots, grid) float32."""
    rng = np.random.default_rng(seed)
    rhs = {"kdv": _kdv_rhs, "cahn_hilliard": _ch_rhs}[system]
    L = grid * dx
    xg = np.arange(grid) * dx
    trajs = np.zeros((n_traj, n_snapshots, grid), np.float32)
    for t in range(n_traj):
        if system == "kdv":
            # sum of two random solitons
            u = np.zeros(grid)
            for _ in range(2):
                c = rng.uniform(0.5, 2.0)
                x0 = rng.uniform(0, L)
                arg = np.sqrt(c) / 2 * ((xg - x0 + L / 2) % L - L / 2)
                u += 3 * c / np.cosh(np.clip(arg, -20, 20)) ** 2 * 0.1
        else:
            u = 0.1 * rng.normal(size=grid)
        h = dt / substeps
        for s in range(n_snapshots):
            trajs[t, s] = u
            for _ in range(substeps):
                k1 = rhs(u, dx)
                k2 = rhs(u + 0.5 * h * k1, dx)
                k3 = rhs(u + 0.5 * h * k2, dx)
                k4 = rhs(u + h * k3, dx)
                u = u + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return trajs
