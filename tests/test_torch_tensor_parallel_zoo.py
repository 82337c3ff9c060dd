"""PyTorch port: tensor-parallel training of the zoo's MoE, MLA and patch-
frontend archs (``parallel.tensor``, ``nn.moe.moe_ffn``'s TP-in-expert and
expert parallelism, ``nn.attention.mla_attention`` on the rank's heads,
``models.lm._embed_patches_tp``, the prefix layers) in spawned gloo worlds
on the CPU (``torch_world``; what each rank runs is in
``torch_world_tp_zoo``), at smoke width, float64 with the float32 casts
lifted.

* STEP on (2, 2) — deepseek-v2-lite-16b with TP-in-expert and with expert
  parallelism (``state_specs(..., ep=True)``), mixtral-8x7b, internvl2-1b
  at vocab 256 and 255 ("model" 2 leaves the odd vocab whole, as the full
  model's 151655): discrete and node-symplectic, with and without ZeRO-1,
  at S 16 (``seq_carry``) and 15 (four steps per arch, in which every
  pair of two of these factors' values occurs): loss, grad_norm, params
  and the optimizer state within 1e-12 relative of the port's one-process
  step; each MoE call's top-k choices equal one process's and alike on
  every rank of "model"; the collectives per step exactly
  ``train.data_parallel.step_collectives``.
* DATA ONLY — deepseek and mixtral on (4, 1): the MoE aux loss is the
  whole batch's over the data ranks (1e-12 against one process).
* LAUNCHER — ``launch.train --arch ARCH --smoke --mesh debug`` of the
  three archs on (2, 2) against the plain run, rows within 1e-12.
* JAX — one (2, 2) ZeRO-1 step of each from JAX's float64 state against
  JAX's one-device ``make_train_step`` (deepseek in node mode too), both
  packages' float32 casts lifted: 1e-12 (the MoE aux loss is the whole
  batch's on the data ranks, as JAX's program computes it).
* CHECKPOINT — deepseek's (2, 2) state after a step, laid out with
  TP-in-expert and with expert parallelism, restores bitwise on (1, 1).
* BUILD — the three archs make a train step and pass ``check_mesh`` on
  "model" 2 (``tests/test_torch_tensor_parallel.py`` holds the recurrent
  and enc-dec archs' and the refusals of a size that does not divide).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo
from test_torch_tensor_parallel import _Mesh, _lift_jax
from test_torch_train import F64, _close_leaves
from repro.configs.base import NodeConfig as JNodeConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_arch
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.float64 import lifted
from repro_torch.train import TrainConfig, train_state_from_jax
from torch_world import run_world
from torch_world_tp_zoo import ARCHS, DATA_ONLY, JAX_CASES, LAUNCHED, \
    PATCHES, STEPS, step_name

STEP_CASES = [step_name(n, *s) for n in ARCHS for s in STEPS] + \
    [f"launcher-{a}" for a in LAUNCHED] + \
    [f"{n}-discrete-4x1" for n in DATA_ONLY]
ARCH_IDS = {"deepseek": "deepseek-v2-lite-16b", "deepseek_ep":
            "deepseek-v2-lite-16b", "mixtral": "mixtral-8x7b",
            "internvl2": "internvl2-1b", "internvl2_v255": "internvl2-1b"}


@pytest.fixture(scope="module")
def step_world():
    return run_world("torch_world_tp_zoo:step_cases", world=4)


@pytest.mark.parametrize("name", STEP_CASES)
def test_zoo_tensor_parallel_step(step_world, name):
    for rank, res in enumerate(step_world):
        assert res.get(name) == "ok", f"rank {rank}: {res.get(name)}"


def _jax_arch(name, mode):
    arch = torch_zoo.j_smoke(ARCH_IDS[name])
    if name.endswith("_v255"):
        arch = dataclasses.replace(arch, vocab=255)
    if mode == "node":
        arch = dataclasses.replace(arch, node=JNodeConfig(
            mode="node", grad_mode="symplectic"))
    return arch


def _jax_batch(arch):
    """A (4, 16) global batch as numpy, with 4 patch embeddings for the
    patch frontend."""
    b = dict(synthetic_lm_batch(0, 4, 17, arch.vocab))
    if arch.frontend == "patch":
        b["patch_embeds"] = np.random.default_rng(7).normal(
            size=(4, PATCHES, arch.d_frontend))
    return b


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """JAX's one-device float64 step (casts lifted; AdamW eps 1e-3, as
    ``test_train_step_matches_jax``) per case, and the world's (2, 2)
    steps from the port's copy of the same states, and its checkpoints."""
    d = tmp_path_factory.mktemp("tp_zoo")
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        _lift_jax(mp)
        jcfg = JTrainConfig(param_dtype="float64", adamw=dataclasses.replace(
            JTrainConfig().adamw, eps=1e-3))
        tcfg = TrainConfig(param_dtype="float64", adamw=dataclasses.replace(
            TrainConfig().adamw, eps=1e-3))
        steps = {}      # one JAX step per JAX arch (deepseek_ep: deepseek's)
        for name, mode in JAX_CASES:
            jarch = _jax_arch(name, mode)
            tarch = ARCHS[name][0]
            nb = _jax_batch(jarch)
            if (jarch, mode) not in steps:
                js = j_init_train_state(jax.random.PRNGKey(0), jarch, jcfg)
                start = train_state_from_jax(
                    jax.tree_util.tree_map(np.asarray, js), tarch,
                    device="cpu")
                js, jm = jax.jit(j_make_train_step(jarch, jcfg))(
                    js, {k: jnp.asarray(v) for k, v in nb.items()})
                steps[jarch, mode] = start, (train_state_from_jax(
                    jax.tree_util.tree_map(np.asarray, js), tarch,
                    device="cpu"), {k: float(v) for k, v in jm.items()})
            start, want[name, mode] = steps[jarch, mode]
            tb = {k: torch.as_tensor(v) if k == "patch_embeds"
                  else torch.as_tensor(v, dtype=torch.long)
                  for k, v in nb.items()}
            torch.save({"state": start, "batch": tb, "tcfg": tcfg},
                       d / f"jax_{name}_{mode}_in.pt")
    old = os.environ.get("TORCH_TP_CASE_DIR")
    os.environ["TORCH_TP_CASE_DIR"] = str(d)
    try:
        results = run_world("torch_world_tp_zoo:jax_cases", world=4)
    finally:
        if old is None:
            del os.environ["TORCH_TP_CASE_DIR"]
        else:
            os.environ["TORCH_TP_CASE_DIR"] = old
    return d, results, want


@pytest.mark.parametrize("name, mode", JAX_CASES)
def test_zoo_tensor_parallel_step_matches_jax(jax_world, name, mode):
    """loss, grad_norm, lr, the new params and AdamW's m and v of the
    (2, 2) step against JAX's one-device step: 1e-12 (float64, both
    packages' casts lifted)."""
    d, results, want = jax_world
    for rank, res in enumerate(results):
        got = res.get(f"jax-{name}-{mode}")
        assert got == "ok", f"rank {rank}: {got}"
    got = torch.load(d / f"jax_{name}_{mode}_out.pt", weights_only=False)
    wstate, wmetrics = want[name, mode]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][key], wmetrics[key],
                                   rtol=F64)
    _close_leaves(got["whole"]["params"], wstate.params, F64)
    for k in ("m", "v"):
        _close_leaves(got["whole"]["opt"][k], wstate.opt[k], F64)


@pytest.mark.parametrize("ep", [False, True])
def test_zoo_checkpoint_2x2_restores_on_1x1(jax_world, ep):
    """deepseek's (2, 2) ZeRO-1 state after one tensor-parallel step, laid
    out with TP-in-expert or with expert parallelism, checkpointed: restored
    here on a (1, 1) mesh of a gloo world of 1, every leaf bitwise."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import state_specs
    from repro_torch.parallel.layout import forget_groups
    from repro_torch.runtime import (Checkpointer, OwnedShard,
                                     mesh_shardings)
    from repro_torch.train import init_train_state
    from torch_world import _free_port
    d, results, _ = jax_world
    tag = "ep" if ep else "tp"
    for rank, res in enumerate(results):
        assert res.get(f"checkpoint-{tag}") == "ok", \
            f"rank {rank}: {res.get(f'checkpoint-{tag}')}"
    want = torch.load(d / f"ckpt_{tag}_whole.pt", weights_only=False)
    with lifted():        # the world's state: float64, no master
        like = init_train_state(ARCHS["deepseek"][0], TrainConfig(
            param_dtype="float64"), seed=1, device="cpu")
    assert not dist.is_initialized()
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        restored, step = Checkpointer(d / f"ckpt_{tag}").restore(
            like, shardings=mesh_shardings(mesh, state_specs(like, mesh)))
    finally:
        dist.destroy_process_group()
        forget_groups()
    leaves = pytree.tree_leaves(restored, is_leaf=lambda x: isinstance(
        x, OwnedShard))
    assert step == 1 and len(leaves) == len(want)
    for i, (a, b) in enumerate(zip(leaves, want)):
        t = a.to_local() if isinstance(a, DTensor) else \
            a.local if isinstance(a, OwnedShard) else a
        if b is None:             # no compression: no error feedback
            assert t is None, f"leaf {i}"
            continue
        assert torch.equal(t, b), f"leaf {i}"


#: (arch, leaf path, its spec on "model" 2: TP-in-expert, expert parallel)
SPLITS = {
    "mixtral-8x7b": (("unit", 0, 0, "moe", "wg"), (None, None, "model"),
                     ("model", None, None)),
    "deepseek-v2-lite-16b": (("unit", 0, 0, "attn", "wuk"), (None, "model"),
                             (None, "model")),
    "internvl2-1b": (("frontend",), (None, "model"), (None, "model")),
}


@pytest.mark.parametrize("arch_id", list(SPLITS))
def test_zoo_archs_build_on_a_model_axis(arch_id):
    """MoE, MLA, the prefix layers and the patch frontend pass
    ``check_mesh`` on "model" 2, and the state's layout there splits the
    leaves their tensor-parallel paths compute on."""
    from repro_torch.parallel import state_specs
    from repro_torch.train import init_train_state
    from repro_torch.train.data_parallel import check_mesh
    arch = get_smoke_arch(arch_id)
    check_mesh(_Mesh(2), arch)
    state = init_train_state(arch, TrainConfig(), device="meta")
    path, tp_spec, ep_spec = SPLITS[arch_id]
    for ep, want in ((False, tp_spec), (True, ep_spec)):
        spec = state_specs(state, _Mesh(2), ep=ep).params
        for key in path:
            spec = spec[key]
        assert tuple(spec) == want, (ep, spec)
