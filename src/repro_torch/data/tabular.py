"""Synthetic tabular datasets standing in for the paper's UCI benchmarks.

The paper trains CNFs on MiniBooNE/GAS/POWER/HEPMASS/BSDS300.  Offline we
generate Gaussian-mixture data with matching dimensionalities so the Table 2
benchmark exercises identical model/solver shapes and produces meaningful
NLL curves.
"""
from __future__ import annotations

import numpy as np

PAPER_DIMS = {"miniboone": 43, "gas": 8, "power": 6, "hepmass": 21,
              "bsds300": 63}
# number of stacked CNF components the paper used per dataset
PAPER_M = {"miniboone": 1, "gas": 5, "power": 5, "hepmass": 10,
           "bsds300": 2}


def make_tabular_dataset(name: str, n: int = 4096, seed: int = 0):
    dim = PAPER_DIMS[name]
    rng = np.random.default_rng(seed)
    k = 5
    means = rng.normal(0, 2.0, size=(k, dim))
    scales = rng.uniform(0.3, 0.8, size=(k, dim))
    comps = rng.integers(0, k, size=n)
    x = means[comps] + rng.normal(size=(n, dim)) * scales[comps]
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    return x.astype(np.float32)
