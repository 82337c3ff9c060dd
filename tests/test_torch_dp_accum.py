"""PyTorch port: data-parallel training with microbatches and gradient
compression (``train.data_parallel``, ``train.train_step``), in spawned gloo
worlds on the CPU (``torch_world``; what each rank runs is in
``torch_world_tp``), at the smoke qwen3-0.6b in float64 with the float32
casts lifted.

* (2, 1) and (2, 2) — two steps of ``microbatches=2`` with bf16 and int8
  compression (int8 with its error feedback), with and without ZeRO-1,
  and an int8 ZeRO-1 node-symplectic pair, against the one-process step on
  the same global batch of 8 (labels masked unevenly, so each data rank's
  share of a microbatch has its own weight n_r,i / N_i), and microbatches
  of 2 rows on (4, 1), which the data axis does not divide (each rank
  holds them whole, weighted by 1 / 4): loss, grad_norm, params, the
  optimizer state within 1e-12 relative, the int8 residual within 1e-12 of
  its leaf's max|g|; the collectives per step exactly
  ``train.data_parallel.step_collectives`` (one per gradient leaf whatever
  the microbatches; compression reduces every leaf whole).
* the launcher — ``launch.train --mesh debug --microbatches 2
  --compression int8`` on a world of 4 takes the (2, 2) mesh and its rows
  agree with the plain run to 1e-12; on a world of 1 they are the plain
  run's bit for bit (a one-rank reduction is a copy, each weight is 1);
  ``--layers`` cuts the depth to whole units.
"""
import pytest

from torch_world import run_world

CASES = ["mb2-bf16-zero1", "mb2-bf16-plain", "mb2-int8-zero1",
         "mb2-int8-plain", "mb2-int8-zero1-node"]


@pytest.fixture(scope="module")
def world2():
    return run_world("torch_world_tp:accum_cases", world=2)


@pytest.fixture(scope="module")
def world4():
    return run_world("torch_world_tp:accum_cases", world=4)


def _held(world, name):
    for rank, res in enumerate(world):
        assert res.get(name) == "ok", f"rank {rank}: {res.get(name)}"


@pytest.mark.parametrize("name", CASES)
def test_microbatches_and_compression_2x1(world2, name):
    _held(world2, f"{name}-2x1")


@pytest.mark.parametrize("name", CASES)
def test_microbatches_and_compression_2x2(world4, name):
    _held(world4, f"{name}-2x2")


def test_microbatch_rows_the_data_axis_does_not_divide(world4):
    """Microbatches of 2 rows on (4, 1): each stays whole on every data
    rank (``batch_specs``), whose weight then divides by the 4 copies; the
    step equals one process's at 1e-12."""
    _held(world4, "mb2-int8-zero1-rows_whole-4x1")


def test_launcher_on_four_ranks_takes_2x2(world4):
    _held(world4, "launcher-2x2")


@pytest.mark.parametrize("compression", ["int8", "bf16"])
def test_launcher_mesh_debug_world_of_one_microbatches(compression):
    """``--mesh debug --microbatches 2 --compression ...`` alone (a world
    of 1, ZeRO-1) is the plain run with the same flags bit for bit."""
    import torch.distributed as dist

    from repro_torch.launch import train
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--steps", "3", "--global-batch", "4", "--seq-len", "16",
            "--microbatches", "2", "--compression", compression]
    plain = train.main(argv)
    meshed = train.main(argv + ["--mesh", "debug"])
    assert meshed["rows"] == plain["rows"]
    assert not dist.is_initialized()


def test_launcher_layers_cuts_the_depth():
    """``--layers`` cuts the depth to whole repeat units at full width (as
    ``launch.serve lm --layers``); a part of a unit raises."""
    from repro_torch.launch import train
    argv = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--steps", "1", "--global-batch", "2", "--seq-len", "8"]
    out = train.main(argv + ["--layers", "1"])
    assert out["arch"].n_layers == 1 and len(out["state"].params["unit"]) == 1
    assert out["arch"].d_model == train.main(argv)["arch"].d_model
    with pytest.raises(ValueError, match="multiple of the pattern"):
        train.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device",
                    "cpu", "--steps", "1", "--layers", "1"])
