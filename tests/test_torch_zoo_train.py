"""PyTorch port: one training step of each new arch of the LM zoo against
the JAX package, at smoke width on the CPU (float64 params from JAX's own
``init_train_state`` through ``train_state_from_jax``).

Tolerance 1e-5, relative and of the largest entry, for the loss (cross-
entropy plus the MoE aux loss), grad_norm, the updated params and AdamW's
state: RMSNorm, RoPE, attention and the MoE routers compute in float32
inside in both packages, and AdamW's eps is 1e-3 in both (its first step
is g / (|g| + eps): the default 1e-8 turns rounding-level gradients into
full-size updates), as in tests/test_torch_train.py.  internvl2-1b trains
with 4 patch embeddings before the tokens, whose positions carry no label.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_arch
from repro_torch.train import (TrainConfig, make_train_step,
                               train_state_from_jax)

STEP_RTOL = 1e-5
NEW_ARCHS = ("deepseek-v2-lite-16b", "mixtral-8x7b", "qwen3-1.7b",
             "minicpm-2b", "stablelm-12b", "internvl2-1b")


def _close_leaves(got, want, rtol):
    from torch.utils import _pytree as pytree
    g, w = pytree.tree_leaves(got), pytree.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.detach().to(torch.float64).numpy()
        b = b.detach().to(torch.float64).numpy()
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * float(np.abs(b).max()))


@pytest.mark.parametrize("arch_id", NEW_ARCHS)
def test_train_step_matches_jax(arch_id):
    jarch, tarch = torch_zoo.j_smoke(arch_id), get_smoke_arch(arch_id)
    jcfg = JTrainConfig(param_dtype="float64",
                        adamw=dataclasses.replace(JTrainConfig().adamw,
                                                  eps=1e-3))
    tcfg = TrainConfig(param_dtype="float64",
                       adamw=dataclasses.replace(TrainConfig().adamw,
                                                 eps=1e-3))
    jstate = j_init_train_state(jax.random.PRNGKey(0), jarch, jcfg)
    np_state = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = train_state_from_jax(np_state, tarch, device="cpu")
    b = torch_zoo.train_batch(jarch)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) if k == "patch_embeds"
          else torch.as_tensor(v, dtype=torch.long) for k, v in b.items()}
    js, jm = jax.jit(j_make_train_step(jarch, jcfg))(jstate, jb)
    ts, tm = make_train_step(tarch, tcfg)(tstate, tb)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=STEP_RTOL)
    want = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                                tarch, device="cpu")
    _close_leaves(ts.params, want.params, STEP_RTOL)
    for k in ("m", "v", "master"):
        _close_leaves(ts.opt[k], want.opt[k], STEP_RTOL)
