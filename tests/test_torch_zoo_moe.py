"""PyTorch port: the MoE archs of the LM zoo (deepseek-v2-lite-16b: MLA,
a dense prefix layer and 64-expert layers at full width, 8 at smoke
width; mixtral-8x7b: GQA with a sliding window and 8 experts, 4 at smoke
width) against the JAX package at smoke width, on the CPU.

Serving parity as in ``test_torch_zoo.py``: float64 with the float32 casts
lifted (the routers then decide in float64 alike): 1e-12 of the largest
logit; float32 with a float32 cache: 1e-5; with the serving path's
bfloat16 cache: 1e-3 (entries that round the other way, as there).  Node mode on mixtral (the JAX package's
``test_node_mode_smoke``): one symplectic-adjoint train step, finite loss
and params, and its loss equal to the discrete step's (euler with one
step per unit is the discrete stack; the aux loss is dropped in node
mode, as in the JAX package): 1e-6.
"""
import pytest
import torch

import torch_zoo
from repro_torch.configs import get_smoke_arch
from repro_torch.configs.base import NodeConfig
from repro_torch.models import lm as tlm
from repro_torch.train import TrainConfig, init_train_state, make_train_step

MOE = ("deepseek-v2-lite-16b", "mixtral-8x7b")


@pytest.mark.parametrize("arch_id", MOE)
def test_moe_serving_float64_matches_jax(arch_id, monkeypatch):
    for j, t in torch_zoo.serve_pair(arch_id, "float64", monkeypatch):
        torch_zoo.rel(t, j, 1e-12)


@pytest.mark.parametrize("cache, tol", [("float32", 1e-5),
                                        ("bfloat16", 1e-3)])
@pytest.mark.parametrize("arch_id", MOE)
def test_moe_serving_float32_matches_jax(arch_id, cache, tol,
                                         monkeypatch):
    for j, t in torch_zoo.serve_pair(arch_id, "float32", monkeypatch,
                                     cache):
        torch_zoo.rel(t, j, tol)


@pytest.mark.parametrize("arch_id", MOE)
def test_aux_loss_sums_every_moe_layer(arch_id):
    """lm_forward's aux is the sum of its MoE layers' (the dense prefix
    adds 0), and it reaches the training loss."""
    from repro_torch.models.blocks import layer_forward
    arch = get_smoke_arch(arch_id)
    params = tlm.init_lm(arch, seed=0, device="cpu")
    toks = torch.tensor(torch_zoo.inputs(arch)[0])
    out = tlm.lm_forward(params, arch, toks)
    x = params["embed"][toks]
    pos = torch.arange(x.shape[1])
    want = 0.0
    layers = [(params[f"prefix_{i}"], s) for i, s in enumerate(arch.prefix)]
    layers += [(u[0], arch.pattern[0]) for u in params["unit"]]
    for p, spec in layers:
        x, _, a = layer_forward(p, x, spec, arch, positions=pos)
        want = want + a
    assert float(out["aux"]) > 0
    torch.testing.assert_close(out["aux"], want, rtol=0, atol=0)


def test_node_mode_smoke_mixtral():
    arch = get_smoke_arch("mixtral-8x7b")
    node = arch.with_(node=NodeConfig(mode="node", method="euler",
                                      grad_mode="symplectic"))
    tcfg = TrainConfig(lr=1e-3)
    batch = {k: torch.as_tensor(v, dtype=torch.long)
             for k, v in torch_zoo.train_batch(arch).items()}
    state = init_train_state(node, tcfg, device="cpu")
    s1, m1 = make_train_step(node, tcfg)(state, batch)
    assert torch.isfinite(m1["loss"])
    assert all(bool(torch.isfinite(t).all())
               for t in torch.utils._pytree.tree_leaves(s1.params))
    # the node loss is the cross-entropy alone: the discrete stack's total
    # less its aux loss
    params = state.params
    out = tlm.lm_forward(params, node, batch["tokens"])
    disc = tlm.lm_forward(params, arch, batch["tokens"])
    assert out["aux"] == 0.0 and float(disc["aux"]) > 0
    torch.testing.assert_close(out["logits"], disc["logits"], rtol=1e-6,
                               atol=1e-6)
