"""PyTorch port: the LM zoo (deepseek-v2-lite-16b, mixtral-8x7b, qwen3-1.7b,
minicpm-2b, stablelm-12b, internvl2-1b; jamba-v0.1-52b, xlstm-1.3b,
seamless-m4t-medium) against the JAX package, at smoke width on the CPU:
each config field for field, the registry, and the dense archs' serving
(the MoE archs' is in ``test_torch_zoo_moe.py``, training in
``test_torch_zoo_train.py``, the recurrent and enc-dec archs' in
``test_torch_zoo_rec.py``).

Serving parity (``torch_zoo.serve_pair``): JAX's smoke weights carried by
``params_from_jax``; prefill, then three teacher-forced decode steps.
  * float64, both packages' float32 casts lifted, float64 cache: 1e-12 of
    the largest logit (float64 rounding).
  * float32, float32 cache: 1e-5 of the largest logit (float32 rounding).
  * float32 with the serving path's bfloat16 cache: 1e-3.  A cache entry
    rounds alike in both packages unless its two float32 values straddle a
    bfloat16 boundary; such an entry moves by 2^-8 of itself, which the
    decode logits carry (1.6e-5 to 2.4e-5 of the largest logit measured
    here; chip_smoke.py's card-vs-CPU phase holds the same 1e-3).
"""
import dataclasses

import pytest
import torch

import torch_zoo
from repro.configs import registry as jreg
from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch, get_smoke_arch, registry as treg
from repro_torch.models import lm as tlm

NEW_ARCHS = ("deepseek-v2-lite-16b", "mixtral-8x7b", "qwen3-1.7b",
             "minicpm-2b", "stablelm-12b", "internvl2-1b")
DENSE = ("qwen3-1.7b", "minicpm-2b", "stablelm-12b", "internvl2-1b")
REC_ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b", "seamless-m4t-medium")


def _fields(cfg):
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out.pop("use_pallas", None)
    out.pop("use_kernels", None)
    for k in ("pattern", "prefix"):
        out[k] = [dataclasses.asdict(s) for s in out[k]]
    out["node"] = dataclasses.asdict(out["node"])
    return out


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
@pytest.mark.parametrize("arch_id", NEW_ARCHS + REC_ARCHS)
def test_configs_equal_jax(arch_id, which):
    j = getattr(jreg._mod(arch_id), which)
    t = getattr(treg._mod(arch_id), which)
    assert t.use_kernels is None and j.use_pallas is None
    assert _fields(t) == _fields(j)
    assert dataclasses.asdict(t.attn_config()) == \
        dataclasses.asdict(j.attn_config())
    assert dataclasses.asdict(t.moe_config()) == \
        dataclasses.asdict(j.moe_config())
    assert dataclasses.asdict(t.mamba_config()) == \
        dataclasses.asdict(j.mamba_config())
    assert dataclasses.asdict(t.xlstm_config()) == \
        dataclasses.asdict(j.xlstm_config())
    assert t.mamba_config().d_inner == j.mamba_config().d_inner
    assert t.mamba_config().rank == j.mamba_config().rank
    assert t.n_repeats == j.n_repeats
    assert (get_arch if which == "FULL" else get_smoke_arch)(arch_id) is t


def test_registry_resolves_the_zoo_and_names_the_rest():
    """Every JAX arch resolves: the port's ids are JAX's (the rest, an
    unknown id, raises KeyError)."""
    assert set(treg.ARCH_IDS) == set(jreg.ARCH_IDS)
    assert set(treg.ARCH_IDS) == set(NEW_ARCHS + REC_ARCHS) | {"qwen3-0.6b"}
    for arch_id in REC_ARCHS:
        assert get_arch(arch_id).name == arch_id
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    assert treg.FULL_ATTENTION_ARCHS == jreg.FULL_ATTENTION_ARCHS
    for arch_id in jreg.ARCH_IDS:
        for shape in ("train_4k", "long_500k"):
            assert treg.cell_is_applicable(arch_id, shape) == \
                jreg.cell_is_applicable(arch_id, shape)


def test_audio_frontend_and_encdec_still_raise():
    """The decoder-only LM refuses an enc-dec config (audio frontend), and
    names the module that builds one (``models/encdec.py``)."""
    cfg = get_smoke_arch("qwen3-1.7b")
    for bad in (cfg.with_(frontend="audio"), cfg.with_(encdec=True),
                get_smoke_arch("seamless-m4t-medium")):
        with pytest.raises(ValueError, match="models.encdec"):
            tlm.init_lm(bad, device="cpu")
        with pytest.raises(ValueError, match="models.encdec"):
            tlm.lm_forward({}, bad, torch.zeros((1, 2), dtype=torch.long))


def test_params_from_jax_carries_the_new_leaves():
    """deepseek's prefix layer and stacked (R, E, d, f) experts, the
    float32 router of a float64 model, and internvl2's frontend."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.models import lm as jlm
    for arch_id in ("deepseek-v2-lite-16b", "internvl2-1b"):
        jarch, tarch = torch_zoo.j_smoke(arch_id), get_smoke_arch(arch_id)
        jp = jax.tree_util.tree_map(np.asarray, jax.jit(
            jlm.init_lm, static_argnums=(1, 2))(jax.random.PRNGKey(0),
                                                jarch, jnp.float64))
        tp = tlm.params_from_jax(jp, tarch, device="cpu")
        own = tlm.init_lm(tarch, seed=0, device="cpu", dtype=torch.float64)
        assert jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                      tp) == \
            jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype), own)
        if arch_id == "deepseek-v2-lite-16b":
            moe = tp["unit"][1][0]["moe"]
            assert moe["router"].dtype == torch.float32
            assert moe["wg"].dtype == torch.float64
            np.testing.assert_array_equal(moe["wg"].numpy(),
                                          jp["unit"][0]["moe"]["wg"][1])
            assert "mlp" in tp["prefix_0"] and "moe" not in tp["prefix_0"]
        else:
            np.testing.assert_array_equal(tp["frontend"].numpy(),
                                          jp["frontend"])


@pytest.mark.parametrize("arch_id", DENSE)
def test_dense_serving_float64_matches_jax(arch_id, monkeypatch):
    for j, t in torch_zoo.serve_pair(arch_id, "float64", monkeypatch):
        torch_zoo.rel(t, j, 1e-12)


@pytest.mark.parametrize("cache, tol", [("float32", 1e-5),
                                        ("bfloat16", 1e-3)])
@pytest.mark.parametrize("arch_id", DENSE)
def test_dense_serving_float32_matches_jax(arch_id, cache, tol,
                                         monkeypatch):
    for j, t in torch_zoo.serve_pair(arch_id, "float32", monkeypatch,
                                     cache):
        torch_zoo.rel(t, j, tol)


def test_serve_cli_runs_every_new_arch_on_cpu():
    from repro_torch.launch import serve
    for arch_id in NEW_ARCHS:
        out = serve.main(["lm", "--arch", arch_id, "--smoke", "--device",
                          "cpu", "--batch", "2", "--prompt-len", "6",
                          "--gen-len", "3"])
        assert tuple(out["tokens"].shape) == (2, 3) and out["logits_finite"]


def test_flash_head_dim_160_limits():
    """The flash forward and backward take D 160 (stablelm-12b) in float32
    and bfloat16 (the forward in float16 too); float64 at D 160 raises in
    both, and a head dim the backward does not take raises before any
    launch (card runs of D 160: tests/test_torch_cuda.py)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    assert 160 in fa.HEAD_DIMS and 160 in fa.BWD_HEAD_DIMS
    q = torch.zeros((1, 2, 4, 160), dtype=torch.float64)
    with pytest.raises(ValueError, match="not float64"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="not float64"):
        fa.flash_attention_bwd(q, q, q, q, q[..., 0].float(), q)
    # D 160 passes the backward's gate; a CPU tensor then fails only the
    # kernel's device check
    qg = torch.zeros((1, 2, 4, 160), requires_grad=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.attention(qg, qg, qg, use_kernels=True)
    with pytest.raises(NotImplementedError, match="head dim 96"):
        fa.check_bwd_head_dim(96)
    with pytest.raises(ValueError, match="head dim 96"):
        fa.flash_attention(*(torch.zeros((1, 2, 4, 96)),) * 3)
