"""PyTorch port: the LM serving slice (qwen3-0.6b) against the JAX package.

The JAX package's ``init_lm`` weights for the qwen3-0.6b SMOKE config
(float64, x64 on) go through ``params_from_jax`` into the port; both
packages then prefill the same numpy tokens into a bfloat16 KV cache,
decode four steps fed the same tokens, and run the training-mode forward,
on the CPU.

Tolerance: RMSNorm, RoPE and attention compute in float32 inside in both
packages, so logits agree to float32 rounding carried through two layers,
not to float64: |port - JAX| <= 1e-5 * max|JAX logits| + 1e-5 * |JAX|.
Cache entries are float32 values rounded to bfloat16; where the two
packages' float32 values straddle a rounding boundary they differ by one
bfloat16 ulp.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from repro.configs import qwen3_0_6b as jqwen
from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.models import lm as jlm
from repro.train import serve_step as jserve
from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch, get_smoke_arch
from repro_torch.configs import qwen3_0_6b as tqwen
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.train import make_decode_step, make_prefill_step

RTOL = 1e-5
BF16_EPS = float(torch.finfo(torch.bfloat16).eps)
B, PROMPT, GEN = 2, 8, 4


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["FULL", "SMOKE"])
def test_qwen3_configs_equal_jax(name):
    j, t = getattr(jqwen, name), getattr(tqwen, name)
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    assert jf.pop("use_pallas") is None and tf.pop("use_kernels") is None
    jf["pattern"] = [dataclasses.asdict(s) for s in jf["pattern"]]
    tf["pattern"] = [dataclasses.asdict(s) for s in tf["pattern"]]
    jf["node"], tf["node"] = (dataclasses.asdict(jf["node"]),
                              dataclasses.asdict(tf["node"]))
    assert jf == tf
    assert dataclasses.asdict(j.attn_config()) == \
        dataclasses.asdict(t.attn_config())
    assert t.n_repeats == j.n_repeats


def test_registry_resolves_ported_and_names_the_rest():
    assert get_arch("qwen3-0.6b") is tqwen.FULL
    assert get_smoke_arch("qwen3-0.6b") is tqwen.SMOKE
    # every JAX arch resolves, the recurrent archs and the enc-dec model
    # included
    for arch_id in JAX_ARCH_IDS:
        assert get_arch(arch_id).name == arch_id
        assert get_smoke_arch(arch_id).name == f"{arch_id}-smoke"
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_unported_layers_and_modes_raise(tmp_path):
    cfg = tqwen.SMOKE
    g = torch.Generator().manual_seed(0)
    from repro_torch.models import blocks
    # MLA and MoE layers build (tests/test_torch_zoo*.py), and the
    # recurrent mixers (tests/test_torch_{mamba,xlstm,zoo_rec}.py); an
    # unknown spec raises
    zoo = get_smoke_arch("deepseek-v2-lite-16b")
    assert set(blocks.init_layer(g, tbase.LayerSpec("mla", "dense"), zoo,
                                 device="cpu")) == {
        "mixer_norm", "attn", "ffn_norm", "mlp"}
    assert "moe" in blocks.init_layer(g, tbase.LayerSpec("attn", "moe"), zoo,
                                      device="cpu")
    x = torch.zeros((1, 3, cfg.d_model))
    for spec in (tbase.LayerSpec("mamba", "none"),
                 tbase.LayerSpec("mlstm", "none"),
                 tbase.LayerSpec("slstm", "dense")):
        p = blocks.init_layer(g, spec, cfg, device="cpu")
        assert spec.mixer in p and ("mlp" in p) == (spec.ffn == "dense")
        y, new, _ = blocks.layer_forward(p, x, spec, cfg)
        assert y.shape == x.shape and new is None
        cache = blocks.init_layer_cache(spec, cfg, 1, 3, device="cpu")
        assert all(t.dtype == torch.float32
                   for t in cache.values())        # state, not bf16
        y, new, _ = blocks.layer_forward(p, x, spec, cfg, cache=cache)
        assert set(new) == set(cache)
    with pytest.raises(ValueError, match="unknown layer spec"):
        blocks.init_layer(g, tbase.LayerSpec("rnn", "none"), cfg,
                          device="cpu")
    params = tlm.init_lm(cfg, seed=0, device="cpu")
    tokens = torch.zeros((1, 3), dtype=torch.long)
    # node mode is ported: it trains through the depth solve (euler, one
    # step per unit: the discrete stack up to the rounding of x + h R (y -
    # x), float32 here) and serves with the discrete stack
    node = cfg.with_(node=tbase.NodeConfig(mode="node"))
    torch.testing.assert_close(tlm.lm_forward(params, node, tokens)["logits"],
                               tlm.lm_forward(params, cfg, tokens)["logits"],
                               rtol=1e-5, atol=1e-5)
    # an enc-dec prefill runs (tests/test_torch_encdec.py)
    from repro_torch.models.encdec import init_encdec
    ed = get_smoke_arch("seamless-m4t-medium")
    logits, caches = make_prefill_step(ed, 1, 4)(
        init_encdec(ed, device="cpu"),
        {"tokens": tokens, "frames": torch.zeros((1, 5, ed.d_frontend))})
    assert logits.shape == (1, 1, ed.vocab)
    assert caches["cross"]["k"].shape == (ed.n_layers, 1, 5, ed.n_heads,
                                          ed.head_dim)
    with pytest.raises(ValueError, match="mode"):
        tlm.lm_forward(params, cfg, tokens, mode="prefill")
    # serve ode runs (tests/test_torch_serve.py) and boots from a training
    # checkpoint (tests/test_torch_runtime.py); an empty directory holds
    # none
    from repro_torch.serve import SolveEngine
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        SolveEngine.from_checkpoint(None, None, None, str(tmp_path), None,
                                    None)


@functools.lru_cache(maxsize=None)
def _jax_run():
    """JAX: float64 SMOKE weights, prefill logits + caches, 4 teacher-forced
    decode steps, and the training-mode logits, all as numpy."""
    cfg = jqwen.SMOKE
    params = jax.jit(jlm.init_lm, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), cfg, jnp.float64)
    toks = synthetic_lm_batch(0, B, PROMPT + 1, cfg.vocab)["tokens"]
    feed = np.random.default_rng(1).integers(0, cfg.vocab, size=(GEN, B, 1))
    prefill = jax.jit(jserve.make_prefill_step(cfg, B, PROMPT + GEN))
    decode = jax.jit(jserve.make_decode_step(cfg))
    logits, caches = prefill(params, {"tokens": jnp.asarray(toks)})
    out = {"prefill": np.asarray(logits),
           "caches": jax.tree_util.tree_map(
               lambda a: np.asarray(a.astype(jnp.float32)), caches),
           "decode": []}
    for i in range(GEN):
        logits, caches = decode(params, caches, jnp.asarray(feed[i]),
                                jnp.int32(PROMPT + i))
        out["decode"].append(np.asarray(logits))
    out["caches_after"] = jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), caches)
    out["train"] = np.asarray(jax.jit(
        lambda p, t: jlm.lm_forward(p, cfg, t)["logits"])(
            params, jnp.asarray(toks)))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return np_params, toks, feed, out


def _port_params():
    np_params, _, _, _ = _jax_run()
    return tlm.params_from_jax(np_params, tqwen.SMOKE, device="cpu")


def test_params_from_jax_layout():
    np_params, _, _, _ = _jax_run()
    params = _port_params()
    R = tqwen.SMOKE.n_repeats
    assert isinstance(params["unit"], list) and len(params["unit"]) == R
    for r in range(R):
        layer = params["unit"][r][0]
        np.testing.assert_array_equal(
            layer["attn"]["wq"].numpy(),
            np_params["unit"][0]["attn"]["wq"][r])
    # the port's own init has the same structure and shapes
    own = tlm.init_lm(tqwen.SMOKE, seed=0, device="cpu", dtype=torch.float64)
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), own)
    want = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert shapes == want


def test_prefill_logits_and_caches_match_jax():
    _, toks, _, want = _jax_run()
    params = _port_params()
    prefill = make_prefill_step(tqwen.SMOKE, B, PROMPT + GEN)
    logits, caches = prefill(params, {"tokens": torch.tensor(toks)})
    assert logits.shape == (B, 1, tqwen.SMOKE.vocab)
    assert logits.dtype == torch.float32
    _close(logits.numpy(), want["prefill"])
    for r, unit in enumerate(caches["unit"]):
        for key in ("k", "v"):
            got = unit[0][key]
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(
                got.float().numpy(), want["caches"]["unit"][0][key][r],
                rtol=BF16_EPS, atol=1e-6)


def test_decode_steps_match_jax():
    _, toks, feed, want = _jax_run()
    params = _port_params()
    prefill = make_prefill_step(tqwen.SMOKE, B, PROMPT + GEN)
    decode = make_decode_step(tqwen.SMOKE)
    _, caches = prefill(params, {"tokens": torch.tensor(toks)})
    for i in range(GEN):
        logits, caches = decode(params, caches, torch.tensor(feed[i]),
                                PROMPT + i)
        _close(logits.numpy(), want["decode"][i])
    for r, unit in enumerate(caches["unit"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                unit[0][key].float().numpy(),
                want["caches_after"]["unit"][0][key][r], rtol=BF16_EPS,
                atol=1e-6)


def test_train_mode_logits_match_jax():
    _, toks, _, want = _jax_run()
    out = tlm.lm_forward(_port_params(), tqwen.SMOKE, torch.tensor(toks))
    assert out["caches"] is None and out["aux"] == 0.0
    _close(out["logits"].numpy(), want["train"])


def test_greedy_tokens_match_jax_where_the_margin_is_clear():
    """Greedy decoding, teacher-forced with JAX's own greedy tokens: the
    port's argmax equals JAX's at every step whose top-2 logit margin
    exceeds the logit tolerance (a smaller margin may flip on rounding;
    such steps are counted, not hidden)."""
    np_params, toks, _, _ = _jax_run()
    cfg = jqwen.SMOKE
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    prefill_j = jax.jit(jserve.make_prefill_step(cfg, B, PROMPT + GEN))
    decode_j = jax.jit(jserve.make_decode_step(cfg))
    params = _port_params()
    prefill_t = make_prefill_step(tqwen.SMOKE, B, PROMPT + GEN)
    decode_t = make_decode_step(tqwen.SMOKE)
    lj, cj = prefill_j(jparams, {"tokens": jnp.asarray(toks)})
    lt, ct = prefill_t(params, {"tokens": torch.tensor(toks)})
    clear = 0
    for i in range(GEN):
        lj_np = np.asarray(lj[:, -1], np.float64)
        top2 = np.sort(lj_np, axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        tol = 2 * RTOL * (np.abs(lj_np).max() + np.abs(lj_np).max(-1))
        tok_j = lj_np.argmax(-1)
        tok_t = lt[:, -1].numpy().argmax(-1)
        ok = margin > tol
        np.testing.assert_array_equal(tok_t[ok], tok_j[ok])
        clear += int(ok.sum())
        feed = tok_j[:, None].astype(np.int32)
        lj, cj = decode_j(jparams, cj, jnp.asarray(feed),
                          jnp.int32(PROMPT + i))
        lt, ct = decode_t(params, ct, torch.tensor(feed), PROMPT + i)
    assert clear >= B * GEN // 2


def test_serve_cli_on_cpu():
    argv = ["lm", "--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen-len", "4"]
    out = serve.main(argv)
    toks = out["tokens"]
    assert toks.shape == (2, 4) and toks.dtype == torch.long
    assert int(toks.min()) >= 0 and int(toks.max()) < tqwen.SMOKE.vocab
    assert out["logits_finite"]
    assert out["prefill_ms"] > 0 and out["decode_ms_per_token"] > 0
    assert torch.equal(serve.main(argv)["tokens"], toks)   # seeded
    sampled = serve.main(argv + ["--temperature", "1.0", "--seed", "3"])
    assert sampled["tokens"].shape == (2, 4)
