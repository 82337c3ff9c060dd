"""PyTorch port: tensor-parallel training of the recurrent and enc-dec archs
(``nn.mamba`` by channel, ``nn.xlstm``'s mLSTM and sLSTM by head,
``models.encdec`` with its encoder and decoder each deciding ``seq_carry``,
``parallel.tensor``'s ``whole`` / ``summed`` regions and ``PARTIAL_IN``)
in spawned gloo worlds on the CPU (``torch_world``; what each rank runs is
in ``torch_world_tp_rec``), at smoke width, float64 with the float32 casts
lifted.

* STEP on (2, 2) — jamba-v0.1-52b with its Mamba laid out by channel and
  laid out whole (``extra_replicated=MAMBA_PARAM_NAMES``; its MoE and
  attention layers come along), xlstm-1.3b discrete and node-symplectic,
  seamless-m4t-medium with source and target lengths that "model" divides
  or not apart; with and without ZeRO-1: loss, grad_norm, params and the
  optimizer state within 1e-12 relative of the port's one-process step (a
  zero-initialised bias within 1e-12 lr max|g| / eps: its first update
  is lr g / (|g| + eps)); jamba's MoE routed as one process and alike on
  every rank of "model"; the collectives per step exactly
  ``train.data_parallel.step_collectives``.
* LAUNCHER — ``launch.train --arch ARCH --smoke --mesh debug`` of the
  three archs on (2, 2) against the plain run, rows within 1e-12.
* COUNT on (1, 2) — one float32 ZeRO-1 step per arch (jamba in both
  layouts): the collectives by kind exactly ``step_collectives``.
* JAX — one (2, 2) ZeRO-1 step of each from JAX's float64 state against
  JAX's one-device ``make_train_step`` (xlstm in node mode), both
  packages' float32 casts lifted, AdamW eps 1e-3: the loss within 1e-12;
  grad_norm, lr, the new params and AdamW's m and sqrt(v) within 1e-5
  (``torch_zoo_rec.close_leaves``: the float32 leaves, Mamba's A_log, D,
  dt_bias and the xLSTM gates, keep float32 gradients in both packages).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import torch_zoo
from test_torch_tensor_parallel import _lift_jax
from torch_zoo_rec import STEP_RTOL, close_leaves
from repro.configs.base import NodeConfig as JNodeConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.train import TrainConfig, train_state_from_jax
from torch_world import run_world
from torch_world_tp_rec import (ARCHS, COUNT_CASES, JAX_CASES, LAUNCHED,
                                STEPS, rec_batch, step_name)

STEP_CASES = [step_name(n, *s) for n, steps in STEPS.items()
              for s in steps] + [f"launcher-{a}" for a in LAUNCHED]
ARCH_IDS = {"jamba": "jamba-v0.1-52b", "xlstm": "xlstm-1.3b",
            "seamless": "seamless-m4t-medium"}
LOSS_RTOL = 1e-12


@pytest.fixture(scope="module")
def step_world():
    return run_world("torch_world_tp_rec:step_cases", world=4)


@pytest.mark.parametrize("name", STEP_CASES)
def test_rec_tensor_parallel_step(step_world, name):
    for rank, res in enumerate(step_world):
        assert res.get(name) == "ok", f"rank {rank}: {res.get(name)}"


@pytest.fixture(scope="module")
def count_world():
    return run_world("torch_world_tp_rec:count_cases", world=2)


@pytest.mark.parametrize("name", [c[0] for c in COUNT_CASES])
def test_rec_step_collectives_on_1x2(count_world, name):
    for rank, res in enumerate(count_world):
        got = res.get(f"count-{name}")
        assert got == "ok", f"rank {rank}: {got}"


def _jax_arch(name, mode):
    arch = torch_zoo.j_smoke(ARCH_IDS[name])
    if mode == "node":
        arch = arch.with_(node=JNodeConfig(mode="node", method="euler",
                                           grad_mode="symplectic"))
    return arch


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """JAX's one-device float64 step (casts lifted; AdamW eps 1e-3) per
    case, and the world's (2, 2) steps from the port's copy of the same
    states."""
    d = tmp_path_factory.mktemp("tp_rec")
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        _lift_jax(mp)
        jcfg = JTrainConfig(param_dtype="float64", adamw=dataclasses.replace(
            JTrainConfig().adamw, eps=1e-3))
        tcfg = TrainConfig(param_dtype="float64", adamw=dataclasses.replace(
            TrainConfig().adamw, eps=1e-3))
        for name, mode in JAX_CASES:
            jarch = _jax_arch(name, mode)
            tarch = ARCHS[name][0]
            tb = rec_batch(tarch, 0, 4, 16, 16)
            jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
            js = j_init_train_state(jax.random.PRNGKey(0), jarch, jcfg)
            start = train_state_from_jax(
                jax.tree_util.tree_map(np.asarray, js), tarch, device="cpu")
            js, jm = jax.jit(j_make_train_step(jarch, jcfg))(js, jb)
            want[name, mode] = (start, train_state_from_jax(
                jax.tree_util.tree_map(np.asarray, js), tarch,
                device="cpu"), {k: float(v) for k, v in jm.items()})
            torch.save({"state": start, "batch": tb, "tcfg": tcfg},
                       d / f"jax_{name}_{mode}_in.pt")
    old = os.environ.get("TORCH_TP_CASE_DIR")
    os.environ["TORCH_TP_CASE_DIR"] = str(d)
    try:
        results = run_world("torch_world_tp_rec:jax_cases", world=4)
    finally:
        if old is None:
            del os.environ["TORCH_TP_CASE_DIR"]
        else:
            os.environ["TORCH_TP_CASE_DIR"] = old
    return d, results, want, tcfg


@pytest.mark.parametrize("name, mode", JAX_CASES)
def test_rec_tensor_parallel_step_matches_jax(jax_world, name, mode):
    """The loss of the (2, 2) step against JAX's one-device step at 1e-12;
    grad_norm, lr, the new params, AdamW's m and sqrt(v) at 1e-5 (float64,
    both packages' casts lifted)."""
    d, results, want, tcfg = jax_world
    for rank, res in enumerate(results):
        got = res.get(f"jax-{name}-{mode}")
        assert got == "ok", f"rank {rank}: {got}"
    got = torch.load(d / f"jax_{name}_{mode}_out.pt", weights_only=False)
    start, wstate, wmetrics = want[name, mode]
    np.testing.assert_allclose(got["metrics"]["loss"], wmetrics["loss"],
                               rtol=LOSS_RTOL)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][key], wmetrics[key],
                                   rtol=STEP_RTOL)
    close_leaves(got["whole"]["params"], wstate.params, start.params,
                 wstate.opt["m"], tcfg.adamw, tcfg.lr)
    close_leaves(got["whole"]["opt"]["m"], wstate.opt["m"])
    root = lambda t: [torch.sqrt(x) for x in t]  # noqa: E731
    close_leaves(root(got["whole"]["opt"]["v"]),
                 root(pytree.tree_leaves(wstate.opt["v"])))
