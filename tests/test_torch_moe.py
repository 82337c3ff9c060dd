"""PyTorch port: the mixture-of-experts layer (``repro_torch.nn.moe``)
against the JAX package's ``repro.nn.moe``, on the CPU.

Tolerances, with their reasons:
  * the dispatch: exact.  Given the same gates, both packages must place
    every (token, slot) assignment in the same capacity slot, with the same
    combine weight (integers and float32 copies equal).
  * ``moe_ffn`` in float64: 1e-12 of the largest entry.  The JAX package
    computes the router in float32; both sides run with that cast lifted
    to float64 (``_lift``), so routing decisions are a float64 function of
    the same inputs and the outputs differ by float64 rounding only.
  * ``moe_ffn`` in float32 on dyadic inputs (x and the router small
    integers times powers of two): the router product is then exact in both
    libraries, so the routing is the same, and the outputs agree to float32
    rounding: 1e-6 of the largest entry.
  * the dense-loop reference (every expert on every token, capacity
    unbounded), in float64: 1e-12.
  * a repeat of ``moe_ffn`` on the same inputs: bitwise.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import repro.nn.moe as jmoe
import repro_torch.nn.moe as tmoe

F64 = 1e-12
F32_DYADIC = 1e-6


def _lift(module, monkeypatch):
    """Run ``module``'s jnp code with its float32 casts taken to float64."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.float32 = jnp.float64
    monkeypatch.setattr(module, "jnp", proxy)


class _TorchLift:
    """``torch`` with ``float32`` taken to ``float64``."""

    def __getattr__(self, name):
        return torch.float64 if name == "float32" else getattr(torch, name)


def _rel(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-300)
    assert err <= tol, f"max |diff| / max |want| = {err:.3e} > {tol}"


def _params(cfg, dtype, seed=0, router_scale=None):
    """Seeded numpy params in the JAX package's layout."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.normal(size=(d, E)) * d ** -0.5,
         "wg": rng.normal(size=(E, d, f)) * d ** -0.5,
         "wu": rng.normal(size=(E, d, f)) * d ** -0.5,
         "wd": rng.normal(size=(E, f, d)) * f ** -0.5}
    if cfg.n_shared:
        sf = cfg.shared_d_ff or cfg.d_ff * cfg.n_shared
        p["shared"] = {"wg": rng.normal(size=(d, sf)) * d ** -0.5,
                       "wu": rng.normal(size=(d, sf)) * d ** -0.5,
                       "wd": rng.normal(size=(sf, d)) * sf ** -0.5}
    if router_scale is not None:
        p["router"] = np.round(rng.uniform(-127, 127, size=(d, E))) \
            * router_scale
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), p)


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                  tree)


CFGS = {
    # the smoke widths of deepseek (2 shared experts) and mixtral
    "deepseek": jmoe.MoEConfig(d_model=64, d_ff=32, n_experts=8, top_k=2,
                               n_shared=2, shared_d_ff=64),
    "mixtral": jmoe.MoEConfig(d_model=64, d_ff=128, n_experts=4, top_k=2),
    # deepseek-v2-lite's routing at a narrow width: 64 experts, top-6
    "many_experts": jmoe.MoEConfig(d_model=32, d_ff=16, n_experts=64,
                                   top_k=6, n_shared=2, shared_d_ff=32),
}


def _tcfg(cfg):
    return tmoe.MoEConfig(**{f: getattr(cfg, f)
                             for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("S, k, E, C", [(16, 2, 4, 10), (16, 2, 4, 3),
                                        (33, 6, 64, 1), (64, 2, 8, 20),
                                        (5, 1, 3, 1)])
def test_dispatch_matches_jax_exactly(S, k, E, C):
    """Identical gates in, identical slots out (drops included): a
    stable sort by expert, rank in (token, slot) order, overflow to the
    sentinel."""
    rng = np.random.default_rng(S * 100 + E)
    B = 3
    gate_idx = np.stack([np.stack([rng.choice(E, size=k, replace=False)
                                   for _ in range(S)]) for _ in range(B)])
    gate_w = rng.uniform(0.1, 1.0, size=(B, S, k)).astype(np.float32)
    x = np.zeros((B, S, 2), np.float32)
    jt, jg = jax.vmap(lambda xr, gi, gw: jmoe._dispatch_row(
        xr, gi, gw, E, C))(jnp.asarray(x), jnp.asarray(gate_idx),
                           jnp.asarray(gate_w))
    slot, tt, tg = tmoe.dispatch(torch.tensor(gate_idx),
                                 torch.tensor(gate_w), E, C)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tg.dtype == torch.float32
    # every kept assignment's slot holds its token and gate
    flat_t = np.repeat(np.arange(S), k)
    for b in range(B):
        s = slot[b].numpy()
        kept = s < E * C
        np.testing.assert_array_equal(tt[b].reshape(-1).numpy()[s[kept]],
                                      flat_t[kept])
        np.testing.assert_array_equal(tg[b].reshape(-1).numpy()[s[kept]],
                                      gate_w[b].reshape(-1)[kept])


@pytest.mark.parametrize("name", sorted(CFGS))
def test_moe_ffn_float64_matches_jax(name, monkeypatch):
    cfg = CFGS[name]
    p = _params(cfg, np.float64)
    x = np.random.default_rng(1).normal(size=(2, 24, cfg.d_model))
    _lift(jmoe, monkeypatch)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, cfg))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    monkeypatch.setattr(tmoe, "torch", _TorchLift())
    ty, taux = tmoe.moe_ffn(_torch(p), torch.tensor(x), _tcfg(cfg))
    assert ty.dtype == torch.float64 and taux.dtype == torch.float64
    _rel(ty.numpy(), jy, F64)
    _rel(taux.numpy(), jaux, F64)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_moe_ffn_float32_dyadic_matches_jax(name):
    """x = integers * 2^-8 and router = integers * 2^-10 (|integers| <=
    127): every router logit is a sum of products exact in float32, so
    both libraries route alike; the experts' float32 GEMMs then differ by
    rounding only."""
    cfg = CFGS[name]
    p = _params(cfg, np.float32, router_scale=2.0 ** -10)
    rng = np.random.default_rng(2)
    x = (np.round(rng.uniform(-127, 127, size=(2, 24, cfg.d_model)))
         * 2.0 ** -8).astype(np.float32)
    logits = x.astype(np.float64) @ p["router"].astype(np.float64)
    top = np.sort(logits, axis=-1)[..., ::-1]
    # the k-th and (k+1)-th logits of a token are apart: a tie would leave
    # the order to each library's top-k
    assert np.all(top[..., cfg.top_k - 1] > top[..., cfg.top_k])
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_ffn(p, x, cfg))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    ty, taux = tmoe.moe_ffn(_torch(p), torch.tensor(x), _tcfg(cfg))
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    _rel(ty.numpy(), jy, F32_DYADIC)
    _rel(taux.numpy(), jaux, F32_DYADIC)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_moe_ffn_repeats_bitwise(name):
    cfg = _tcfg(CFGS[name])
    p = _torch(_params(CFGS[name], np.float32))
    x = torch.tensor(np.random.default_rng(3).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32))
    y1, a1 = tmoe.moe_ffn(p, x, cfg)
    y2, a2 = tmoe.moe_ffn(p, x, cfg)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


def _moe_setup(S=32, d=16, E=4, k=2, cf=4.0):
    cfg = tmoe.MoEConfig(d_model=d, d_ff=32, n_experts=E, top_k=k,
                         capacity_factor=cf)
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(g, cfg, torch.float64, device="cpu")
    x = torch.randn((2, S, d), generator=g, dtype=torch.float64)
    return cfg, p, x


def test_moe_matches_dense_loop_reference():
    """Sort-based dispatch == every expert evaluated densely per token,
    when the capacity drops nothing (float64: 1e-12)."""
    cfg, p, x = _moe_setup(cf=10.0)
    y, aux = tmoe.moe_ffn(p, x, cfg)
    _, gw, gi = tmoe.route(p, x, cfg)
    ref = torch.zeros_like(x)
    for e in range(cfg.n_experts):
        h = torch.nn.functional.silu(x @ p["wg"][e]) * (x @ p["wu"][e])
        w = torch.where(gi == e, gw, torch.zeros_like(gw)).sum(-1)
        ref = ref + (h @ p["wd"][e]) * w[..., None].to(x.dtype)
    _rel(y.numpy(), ref.numpy(), F64)


def test_moe_capacity_drops_are_bounded():
    """With capacity factor 1.0 some assignments drop, every expert fills
    at most C slots, the output stays finite and the aux loss positive."""
    cfg, p, x = _moe_setup(cf=1.0)
    y, aux = tmoe.moe_ffn(p, x, cfg)
    assert bool(torch.isfinite(y).all()) and float(aux) > 0
    C = tmoe.capacity(cfg, x.shape[1])
    _, gw, gi = tmoe.route(p, x, cfg)
    slot, tok, _ = tmoe.dispatch(gi, gw, cfg.n_experts, C)
    assert int((slot == cfg.n_experts * C).sum()) > 0          # drops
    assert bool(((tok < x.shape[1]).sum(-1) <= C).all())


@pytest.mark.parametrize("S", [8, 16, 64])
@pytest.mark.parametrize("E", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_dispatch_property(S, E, k):
    """Each expert takes at most C tokens, no slot twice; the kept gates of
    a token sum to <= 1; within an expert the slots follow (token, slot)
    order; the output has x's shape and is finite."""
    cfg = tmoe.MoEConfig(d_model=8, d_ff=16, n_experts=E, top_k=k)
    g = torch.Generator().manual_seed(E * 10 + k)
    p = tmoe.init_moe(g, cfg, device="cpu")
    x = torch.randn((1, S, 8), generator=g)
    y, aux = tmoe.moe_ffn(p, x, cfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    C = tmoe.capacity(cfg, S)
    _, gw, gi = tmoe.route(p, x, cfg)
    slot, tok, gate = tmoe.dispatch(gi, gw, E, C)
    kept = slot[0][slot[0] < E * C]
    assert len(set(kept.tolist())) == len(kept)
    per_token = torch.zeros(S, dtype=torch.float64)
    flat_t = torch.arange(S).repeat_interleave(k)
    sel = slot[0] < E * C
    per_token.index_add_(0, flat_t[sel], gw.reshape(-1)[sel].double())
    assert bool((per_token <= 1 + 1e-6).all())
    for e in range(E):
        filled = tok[0, e][tok[0, e] < S]
        assert bool((filled[1:] >= filled[:-1]).all())
