"""PyTorch port: tensor parallelism (``parallel.tensor``, the regions of
``parallel.comm``, the vocab-parallel lookup and loss, the train step on a
("data", "model") mesh) in spawned gloo worlds on the CPU (``torch_world``;
what each rank runs is in ``torch_world_tp``), at the smoke qwen3-0.6b.

* REGIONS (4 ranks, "model" 2) — copy-to, reduce-from, gather-from- and
  scatter-to-sequence: forward and backward exactly (sums of two float64
  terms), one collective of the right kind each way, the backward's bytes
  counted.
* LOOKUP AND LOSS — the vocab-parallel embedding and chunked
  cross-entropy against the one-process functions, value and gradients
  within 1e-12 (float64, the float32 casts lifted), with and without
  seq_carry, S a multiple of the chunk or not; one all_gather per chunk.
* STEP on (2, 2) — discrete and node-symplectic, with and without ZeRO-1,
  seq_carry on (S 16) and off (S 15), and an arch whose d_ff and vocab
  "model" does not divide (those leaves whole): loss, grad_norm, params,
  optimizer state within 1e-12 relative of the port's one-process step,
  and the collectives per step exactly
  ``train.data_parallel.step_collectives``.
* JAX — one (2, 2) ZeRO-1 step from JAX's float64 state against JAX's
  one-device ``make_train_step``, at ``tests/test_torch_train.py``'s bounds
  (float32 casts in both packages: 1e-5).  Two steps of ``microbatches=2``
  with bf16 and with int8 compression (error feedback on), on (2, 2) with
  ZeRO-1 and on one process, against JAX's one-device steps with both
  packages' float32 casts lifted to float64, at 1e-12 (int8's residual at
  1e-12 of its leaf's max |g|): the labels are masked unevenly, so each
  microbatch, and each data rank's share of it, holds a different number
  of tokens and JAX's row order and n_r,i / N_i weights are what agree.
* CHECKPOINT — a (2, 2) state after two tensor-parallel steps with int8
  compression restores bitwise on (4, 1) (in the world) and on (1, 1) (a
  gloo world of 1 here).
* BUILD AND REFUSALS — Mamba, xLSTM and the enc-dec model pass
  ``check_mesh`` and build a step on "model" 2, and raise on a "model" size
  that does not divide a dim their layers split; so does a size that does
  not divide the kv heads.  (They train there:
  ``tests/test_torch_tensor_parallel_rec.py``; the MoE, MLA and patch-
  frontend archs: ``tests/test_torch_tensor_parallel_zoo.py``.)
"""
import dataclasses
import importlib
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (F64, STEP_RTOL, _batch, _close_leaves,
                              _state_pair, jqwen, tqwen)
from torch_zoo import J_CASTS
from repro.configs.base import NodeConfig as JNodeConfig
from repro.optim import CompressionConfig as JCompressionConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_arch
from repro_torch.configs.base import NodeConfig
from repro_torch.float64 import lifted
from repro_torch.optim import CompressionConfig
from repro_torch.train import IGNORE, TrainConfig, make_train_step, \
    train_state_from_jax
from torch_world import run_world

STEP_CASES = ["regions", "embed-S8", "embed-S7", "loss-S12-c4",
              "loss-S13-c4", "loss-S6-c512",
              "step-discrete-zero1-seq_carry", "step-discrete-plain-seq_carry",
              "step-node-zero1-seq_carry", "step-node-plain-seq_carry",
              "step-discrete-zero1-replicated_seq",
              "step-node-plain-replicated_seq",
              "step-discrete-zero1-whole_ffn_vocab-S16",
              "step-discrete-zero1-whole_ffn_vocab-S15"]
MODES = ["discrete", "node_symplectic"]
ACCUM = ["bf16", "int8"]
# the JAX modules of the train step whose float32 casts are lifted with the
# model's (the port's: ``repro_torch.float64.CAST_MODULES``)
J_TRAIN_CASTS = J_CASTS + tuple(importlib.import_module(m) for m in (
    "repro.train.losses", "repro.train.train_step", "repro.optim.adamw",
    "repro.optim.clip", "repro.optim.compress", "repro.optim.schedules"))
# tokens masked at the start of each of the 4 rows: microbatch 0 (rows 0,
# 1) holds 27 labelled tokens, microbatch 1 (rows 2, 3) 19, and each data
# rank's row of a microbatch a different count
MASKED = (0, 5, 2, 11)


@pytest.fixture(scope="module")
def step_world():
    return run_world("torch_world_tp:step_cases", world=4)


@pytest.mark.parametrize("name", STEP_CASES)
def test_tensor_parallel_world(step_world, name):
    for rank, res in enumerate(step_world):
        assert res.get(name) == "ok", f"rank {rank}: {res.get(name)}"


def _archs(mode):
    if mode == "discrete":
        return jqwen.SMOKE, tqwen.SMOKE
    return (jqwen.SMOKE.with_(node=JNodeConfig(mode="node",
                                                grad_mode="symplectic")),
            tqwen.SMOKE.with_(node=NodeConfig(mode="node",
                                              grad_mode="symplectic")))


def _lift_jax(mp):
    """JAX's train step with its float32 casts taken to float64."""
    for module in J_TRAIN_CASTS:
        proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                         if not k.startswith("__")})
        proxy.float32 = jnp.float64
        mp.setattr(module, "jnp", proxy)


def _masked_batches():
    """Two global batches of 4 x 16 with ``MASKED`` labels IGNORE (numpy
    for JAX, torch for the port)."""
    out = []
    for step in range(2):
        nb, _ = _batch(step, B=4)
        nb["labels"] = nb["labels"].copy()    # a view of the tokens' array
        for r, k in enumerate(MASKED):
            nb["labels"][r, :k] = IGNORE
        out.append((nb, {k: torch.as_tensor(v, dtype=torch.long)
                         for k, v in nb.items()}))
    return out


def _jax_accum(compression, batches):
    """JAX's two one-device steps of ``microbatches=2`` with
    ``compression``, float32 casts lifted (float64 moments, no master, a
    float64 int8 residual): (the port's copy of the initial state, of each
    step's state, and each step's metrics)."""
    with pytest.MonkeyPatch.context() as mp:
        _lift_jax(mp)
        jcfg = JTrainConfig(
            param_dtype="float64", microbatches=2,
            compression=JCompressionConfig(mode=compression),
            adamw=dataclasses.replace(JTrainConfig().adamw, eps=1e-3))
        js = j_init_train_state(jax.random.PRNGKey(0), jqwen.SMOKE, jcfg)
        start = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                                     tqwen.SMOKE, device="cpu")
        step = jax.jit(j_make_train_step(jqwen.SMOKE, jcfg))
        states, metrics = [], []
        for nb, _ in batches:
            js, jm = step(js, {k: jnp.asarray(v) for k, v in nb.items()})
            states.append(train_state_from_jax(
                jax.tree_util.tree_map(np.asarray, js), tqwen.SMOKE,
                device="cpu"))
            metrics.append({k: float(v) for k, v in jm.items()})
    return start, states, metrics


def _accum_tcfg(compression):
    return TrainConfig(param_dtype="float64", microbatches=2,
                       compression=CompressionConfig(mode=compression),
                       adamw=dataclasses.replace(TrainConfig().adamw,
                                                 eps=1e-3))


@pytest.fixture(scope="module")
def jax_world(tmp_path_factory):
    """JAX's one-device step per mode (float64 params, AdamW eps 1e-3 as
    ``test_train_step_matches_jax``) and its two ``microbatches=2`` steps
    per compression (casts lifted), and the world's (2, 2) steps from the
    port's copy of the same states."""
    d = tmp_path_factory.mktemp("tp")
    adamw_eps = dataclasses.replace(TrainConfig().adamw, eps=1e-3)
    want = {}
    batches = _masked_batches()
    for compression in ACCUM:
        start, states, metrics = _jax_accum(compression, batches)
        want[f"mb2-{compression}"] = (start, states, metrics, batches)
        torch.save({"state": start, "batches": [tb for _, tb in batches],
                    "tcfg": _accum_tcfg(compression)},
                   d / f"jax_mb2-{compression}_in.pt")
    for mode in MODES:
        arch_j, arch_t = _archs(mode)
        jstate, tstate = _state_pair(arch_j, arch_t)
        nb, tb = _batch(0)
        jcfg = JTrainConfig(param_dtype="float64", adamw=dataclasses.replace(
            JTrainConfig().adamw, eps=1e-3))
        js, jm = jax.jit(j_make_train_step(arch_j, jcfg))(
            jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        np_js = jax.tree_util.tree_map(np.asarray, js)
        want[mode] = (train_state_from_jax(np_js, arch_t, device="cpu"),
                      {k: float(v) for k, v in jm.items()},
                      {k: int(v) for k, v in js.solver_stats.items()})
        torch.save({"state": tstate, "batch": tb,
                    "tcfg": TrainConfig(param_dtype="float64",
                                        adamw=adamw_eps)},
                   d / f"jax_{mode}_in.pt")
    old = os.environ.get("TORCH_TP_CASE_DIR")
    os.environ["TORCH_TP_CASE_DIR"] = str(d)
    try:
        results = run_world("torch_world_tp:jax_cases", world=4)
    finally:
        if old is None:
            del os.environ["TORCH_TP_CASE_DIR"]
        else:
            os.environ["TORCH_TP_CASE_DIR"] = old
    return d, results, want


@pytest.mark.parametrize("mode", MODES)
def test_tensor_parallel_step_matches_jax(jax_world, mode):
    """loss, grad_norm, the new params and AdamW's m, v and master of the
    (2, 2) step against JAX's one-device step: 1e-5 (the float32 casts
    inside both packages' RMSNorm, RoPE and attention, as
    ``test_train_step_matches_jax``)."""
    d, results, want = jax_world
    for rank, res in enumerate(results):
        assert res.get(f"jax-{mode}") == "ok", \
            f"rank {rank}: {res.get(f'jax-{mode}')}"
    got = torch.load(d / f"jax_{mode}_out.pt", weights_only=False)
    wstate, wmetrics, wstats = want[mode]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][key], wmetrics[key],
                                   rtol=STEP_RTOL)
    _close_leaves(got["whole"]["params"], wstate.params, STEP_RTOL)
    opt = got["whole"]["opt"]
    for k in ("m", "v", "master"):
        _close_leaves(opt[k], wstate.opt[k], STEP_RTOL)
    assert int(opt["step"][0]) == int(wstate.opt["step"]) == 1
    assert got["solver_stats"] == wstats


def _close_accum(got, want, what):
    """The port's state after a ``microbatches=2`` step (whole leaves)
    against JAX's: params, m, v within 1e-12 relative of each leaf's
    largest entry; int8's residual within 1e-12 of its leaf's max |g| (it
    is at most max |g| / 254: 254e-12 of its own largest entry)."""
    _close_leaves(got["params"], want.params, F64)
    for k in ("m", "v"):
        _close_leaves(got["opt"][k], want.opt[k], F64)
    assert "master" not in want.opt and "master" not in got["opt"], what
    assert int(got["opt"]["step"]) == int(want.opt["step"])
    if want.compress_err is None:
        assert got["compress_err"] is None, what
    else:
        _close_leaves(got["compress_err"], want.compress_err, 254 * F64)


@pytest.mark.parametrize("compression", ACCUM)
def test_microbatches_and_compression_2x2_match_jax(jax_world, compression):
    """Two (2, 2) ZeRO-1 steps of ``microbatches=2`` with ``compression``
    against JAX's one-device steps (both packages' casts lifted): loss,
    grad_norm and lr of each step, the new params, AdamW's m and v and
    int8's residual within 1e-12."""
    d, results, want = jax_world
    name = f"mb2-{compression}"
    for rank, res in enumerate(results):
        assert res.get(f"jax-{name}") == "ok", \
            f"rank {rank}: {res.get(f'jax-{name}')}"
    got = torch.load(d / f"jax_{name}_out.pt", weights_only=False)
    _, states, metrics, _ = want[name]
    for i, (g, w) in enumerate(zip(got, states)):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g["metrics"][key], metrics[i][key],
                                       rtol=F64)
        _close_accum(g, w, f"step {i}")


@pytest.mark.parametrize("compression", ACCUM)
def test_microbatches_and_compression_match_jax(jax_world, compression):
    """The same two steps on one process (no mesh) against JAX's, at the
    same bounds."""
    from torch.utils import _pytree as pytree
    _, _, want = jax_world
    start, states, metrics, batches = want[f"mb2-{compression}"]
    with lifted():
        step = make_train_step(tqwen.SMOKE, _accum_tcfg(compression))
        state = start
        for i, (_, tb) in enumerate(batches):
            state, m = step(state, tb)
            for key in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(float(m[key]), metrics[i][key],
                                           rtol=F64)
            _close_accum({"params": state.params, "opt": state.opt,
                          "compress_err": state.compress_err}, states[i],
                         f"step {i}")
    assert pytree.tree_leaves(state.params)[0].dtype == torch.float64


def test_checkpoint_2x2_restores_on_4x1_and_1x1(jax_world):
    """The (2, 2) state after two tensor-parallel steps (int8 compression,
    ZeRO-1), checkpointed: restored on (4, 1) in the world, and here on a
    (1, 1) mesh of a gloo world of 1, every leaf bitwise."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import CompressionConfig
    from repro_torch.parallel import state_specs
    from repro_torch.parallel.layout import forget_groups
    from repro_torch.runtime import (Checkpointer, OwnedShard,
                                     mesh_shardings)
    from repro_torch.train import init_train_state
    from torch_world import _free_port
    d, results, _ = jax_world
    for rank, res in enumerate(results):
        assert res.get("checkpoint") == "ok", \
            f"rank {rank}: {res.get('checkpoint')}"
    want = torch.load(d / "ckpt_whole.pt", weights_only=False)
    with lifted():        # the world's state: float64 moments, no master
        like = init_train_state(tqwen.SMOKE, TrainConfig(
            param_dtype="float64",
            compression=CompressionConfig(mode="int8")), seed=1,
            device="cpu")
    assert not dist.is_initialized()
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cpu")
        restored, step = Checkpointer(d / "ckpt").restore(
            like, shardings=mesh_shardings(mesh, state_specs(like, mesh)))
    finally:
        dist.destroy_process_group()
        forget_groups()
    from torch.distributed.tensor import DTensor
    from torch.utils import _pytree as pytree
    leaves = pytree.tree_leaves(restored, is_leaf=lambda x: isinstance(
        x, OwnedShard))
    assert step == 2 and len(leaves) == len(want)
    for i, (a, b) in enumerate(zip(leaves, want)):
        t = a.to_local() if isinstance(a, DTensor) else \
            a.local if isinstance(a, OwnedShard) else a
        assert torch.equal(t, b), f"leaf {i}"


class _Mesh:
    """The spec rules' duck-typed mesh: sizes and names only."""
    def __init__(self, model):
        self.shape = {"data": 2, "model": model}
        self.axis_names = ("data", "model")


#: (arch, a change to its smoke config, a "model" size that does not
#: divide a dim the changed arch splits, what the refusal names)
UNDIVIDED = [
    ("jamba-v0.1-52b", dict(d_model=63, mamba_expand=1), 2,
     "Mamba d_inner 63"),
    ("xlstm-1.3b", {}, 8, "xLSTM heads 4"),
    ("seamless-m4t-medium", {}, 8, "4 heads"),
]


@pytest.fixture(scope="module")
def build_world():
    return run_world("torch_world_tp_rec:build_cases", world=2)


@pytest.mark.parametrize("arch_id, change, size, what", UNDIVIDED)
def test_recurrent_and_encdec_archs_build_on_a_model_axis(
        build_world, arch_id, change, size, what):
    """Mamba, xLSTM and the enc-dec model pass ``check_mesh`` on "model" 2
    and make a tensor-parallel train step there (a gloo world of 2 on
    ("data" 1, "model" 2); ``tests/test_torch_tensor_parallel_rec.py``
    trains them); a "model" size that does not divide a dim the layer
    splits still raises, naming it."""
    from repro_torch.parallel import make_sharder
    from repro_torch.train.data_parallel import check_mesh
    arch = get_smoke_arch(arch_id)
    check_mesh(_Mesh(2), arch)
    for rank, res in enumerate(build_world):
        assert res.get(arch_id) == "ok", f"rank {rank}: {res.get(arch_id)}"
    bad = arch.with_(**change)
    for fn in (lambda: check_mesh(_Mesh(size), bad),
               lambda: make_train_step(bad, TrainConfig(),
                                       shard=make_sharder(_Mesh(size)))):
        with pytest.raises(NotImplementedError, match="does not divide") \
                as err:
            fn()
        assert what in str(err.value), str(err.value)
    check_mesh(_Mesh(1), bad)        # "model" 1: data parallel only


def test_model_size_must_divide_the_kv_heads():
    from repro_torch.train.data_parallel import check_mesh
    arch = tqwen.SMOKE                # 4 heads, 2 kv heads
    check_mesh(_Mesh(2), arch)
    with pytest.raises(NotImplementedError, match="kv heads"):
        check_mesh(_Mesh(4), arch)
