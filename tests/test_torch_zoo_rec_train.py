"""PyTorch port: one training step of jamba-v0.1-52b (one 8-layer unit at
smoke width: Mamba, attention, MoE), against the JAX package on the CPU
from JAX's ``init_train_state`` (``torch_zoo_rec.step_pair``); and
``params_from_jax`` for the three recurrent and enc-dec archs.

Tolerances (``torch_zoo_rec.close_leaves``): float64 params whose layers
compute in float32 inside in both packages (``test_torch_zoo_train.py``'s
setting, AdamW eps 1e-3): loss and grad_norm at 1e-5; AdamW's m and
sqrt(v) (first step: both proportional to the gradient) and each updated
leaf at 1e-5 of its largest entry; but a leaf that starts at zero (Mamba's
and the mLSTM's conv biases, the sLSTM's and the LayerNorms' biases) is
its first update alone, lr g / (|g| + eps), which takes a float32
gradient's rounding up by 1 / eps: it is held to what a gradient within
1e-5 of its largest entry can move it by (measured without that: 1.14e-5
of its largest entry for the mLSTM's conv bias).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_zoo
from repro_torch.configs import get_smoke_arch
from torch_zoo_rec import REC_ARCHS, j_smoke, step_pair

single_thread = pytest.fixture(autouse=True)(torch_zoo.one_thread)


def test_train_step_matches_jax():
    step_pair("jamba-v0.1-52b")


def test_params_from_jax_carries_the_new_leaves():
    """jamba's and xlstm's stacked (R, ...) unit leaves (R = 1 at smoke
    width, 4 at full width) and the enc-dec model's stacked layers: the
    same tree, shapes and dtypes as the port's own init."""
    from repro.models import encdec as jed
    from repro.models import lm as jlm
    from repro_torch.models import encdec as ted
    from repro_torch.models import lm as tlm
    for arch_id in REC_ARCHS:
        jarch, tarch = j_smoke(arch_id), get_smoke_arch(arch_id)
        if arch_id == "jamba-v0.1-52b":       # two units of 8 layers
            jarch, tarch = jarch.with_(n_layers=16), tarch.with_(n_layers=16)
        jm, tm_ = (jed, ted) if jarch.encdec else (jlm, tlm)
        init = jm.init_encdec if jarch.encdec else jm.init_lm
        jp = jax.tree_util.tree_map(np.asarray, jax.jit(
            init, static_argnums=(1, 2))(jax.random.PRNGKey(0), jarch,
                                         jnp.float32))
        tp = tm_.params_from_jax(jp, tarch, device="cpu")
        own = (ted.init_encdec if jarch.encdec else tlm.init_lm)(
            tarch, seed=0, device="cpu")
        sig = lambda t: (tuple(t.shape), t.dtype)  # noqa: E731
        assert jax.tree_util.tree_map(sig, tp) == \
            jax.tree_util.tree_map(sig, own)
        if arch_id == "jamba-v0.1-52b":
            np.testing.assert_array_equal(
                tp["unit"][1][3]["mamba"]["in_proj"].numpy(),
                jp["unit"][3]["mamba"]["in_proj"][1])
        elif arch_id == "seamless-m4t-medium":
            np.testing.assert_array_equal(
                tp["dec_unit"][1]["cross_attn"]["wk"].numpy(),
                jp["dec_unit"]["cross_attn"]["wk"][1])
