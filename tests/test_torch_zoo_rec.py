"""PyTorch port: the LM zoo's recurrent and enc-dec archs (jamba-v0.1-52b,
xlstm-1.3b, seamless-m4t-medium) served whole at smoke width on the CPU,
against the JAX package from JAX's weights: prefill, then three
teacher-forced decode steps (``torch_zoo_rec.pairs``; seamless-m4t-medium
decodes on the JAX side through its memory route, see there).  Training:
``test_torch_zoo_rec_train.py``, ``test_torch_zoo_rec_node.py``.

Tolerances, relative to the largest logit (``test_torch_zoo.py``'s):
float64, both packages' float32 casts lifted, float64 cache: 1e-12;
float32 with a float32 cache: 1e-5; with the serving path's bfloat16
cache: 1e-3.
"""
import pytest

import torch_zoo
from torch_zoo_rec import REC_ARCHS, pairs

single_thread = pytest.fixture(autouse=True)(torch_zoo.one_thread)


@pytest.mark.parametrize("arch_id", REC_ARCHS)
def test_serving_float64_matches_jax(arch_id, monkeypatch):
    for j, t in pairs(arch_id, "float64", monkeypatch):
        torch_zoo.rel(t, j, 1e-12)


@pytest.mark.parametrize("cache, tol", [("float32", 1e-5),
                                        ("bfloat16", 1e-3)])
@pytest.mark.parametrize("arch_id", REC_ARCHS)
def test_serving_float32_matches_jax(arch_id, cache, tol, monkeypatch):
    for j, t in pairs(arch_id, "float32", monkeypatch, cache):
        torch_zoo.rel(t, j, tol)
