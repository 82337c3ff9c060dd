"""PyTorch port: one training step of xlstm-1.3b and of seamless-m4t-medium
at smoke width, and xlstm-1.3b's node-mode step (euler, symplectic: its
one 8-block unit as one depth step; ``tests/test_arch_smoke.py::
test_node_mode_smoke``), against the JAX package on the CPU from JAX's
``init_train_state``, at ``test_torch_zoo_rec_train.py``'s tolerances
(``torch_zoo_rec.close_leaves``).
"""
import pytest

import torch_zoo
from torch_zoo_rec import step_pair

single_thread = pytest.fixture(autouse=True)(torch_zoo.one_thread)


@pytest.mark.parametrize("arch_id", ["xlstm-1.3b", "seamless-m4t-medium"])
def test_train_step_matches_jax(arch_id):
    step_pair(arch_id)


def test_node_mode_step_matches_jax():
    ts = step_pair("xlstm-1.3b", node=True)
    assert int(ts.solver_stats["n_steps"]) == 1
