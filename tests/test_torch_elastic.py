"""PyTorch port: elastic restart, sharded checkpoints and data-parallel
training on a mesh (``runtime.elastic``, ``Checkpointer(...,
shardings=)``, ``train.data_parallel``), in spawned gloo worlds on the CPU
(``torch_world``; what each rank runs is in ``torch_world_elastic``).

* ELASTIC (4 ranks) — the smoke qwen3-0.6b ``TrainState`` laid out by
  ``parallel.state_specs`` goes (4,) -> (2, 2) -> (4,) bitwise (the JAX
  package's ``tests/test_failures.py`` elastic script); the (2, 2) layout
  splits leaves over "model", and ZeRO-1 leaves each rank 1/data of the
  optimizer bytes (units held whole by their data rank on (2, 2)).
* CHECKPOINTS — a state saved under (4,) (full arrays, rank 0 writes)
  restores under (2, 2) with ``restore(..., shardings=)``, bitwise the
  unsharded boot, every leaf in its sharding; ``SolveEngine.from_checkpoint
  (..., shardings=)`` on a (4,) lane mesh serves what the unsharded boot
  serves (stats exact, x_final within 1e-12).
* DATA PARALLEL (2 ranks) — two ZeRO-1 steps and two plain data-parallel
  steps at smoke width in float64 against the single-process step on the
  same global batch: loss, grad norm, params and optimizer state within
  1e-12 relative (the ranks sum two half-batch gradients, which is not
  bitwise the full batch's); the collectives per step are one per gradient
  leaf plus the loss (plain), plus the norm and one gather per split or
  owned leaf (ZeRO-1).
"""
import pytest

from torch_world import run_world


@pytest.fixture(scope="module")
def elastic_world():
    return run_world("torch_world_elastic:elastic_cases", world=4)


@pytest.fixture(scope="module")
def dp_world():
    return run_world("torch_world_elastic:dp_cases", world=2)


@pytest.mark.parametrize("name", ["reshard", "restore", "engine_boot"])
def test_elastic_world(elastic_world, name):
    for rank, res in enumerate(elastic_world):
        assert res.get(name) == "ok", f"rank {rank}: {res.get(name)}"


@pytest.mark.parametrize("name", ["zero1", "plain"])
def test_data_parallel_world(dp_world, name):
    for rank, res in enumerate(dp_world):
        assert res.get(name) == "ok", f"rank {rank}: {res.get(name)}"


def test_launcher_mesh_debug_world_of_one_is_the_plain_run():
    """``launch.train --mesh debug`` alone is a world of 1 (ZeRO-1 over one
    data rank): its rows equal the plain run's bit for bit, since each
    reduction is a copy and each weight n_r / N is exactly 1."""
    import torch.distributed as dist

    from repro_torch.launch import train
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--steps", "3", "--global-batch", "4", "--seq-len", "16"]
    plain = train.main(argv)["rows"]
    meshed = train.main(argv + ["--mesh", "debug"])["rows"]
    assert meshed == plain
    assert not dist.is_initialized()
