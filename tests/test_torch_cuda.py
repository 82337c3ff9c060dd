"""PyTorch port: the kernels (rms_norm, flash attention, butcher_combine)
against their plain PyTorch versions on the card.

``cuda`` marker: skipped with a reason where there is no CUDA device.  This
file imports no JAX, so it runs on a machine that has only PyTorch (the
suite's conftest imports JAX, hence ``--noconftest``):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

It also holds the cases and tolerances that ``test_torch_lm_kernels.py``
uses against the JAX package on the CPU.
"""
import os

import numpy as np
import pytest
import torch

# cuBLAS takes deterministic reductions only with a fixed workspace, set
# before CUDA starts (the training launcher does the same)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from repro_torch.kernels import butcher_combine as combine_kern
from repro_torch.kernels import flash_attention as flash_kern
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as rms_kern

# (B, H, Hkv, Sq, Sk, D, causal, window, q_offset): tests/test_kernels.py's
ATTN_CASES = [
    (1, 4, 4, 128, 128, 64, True, None, 0),     # MHA causal
    (2, 8, 2, 256, 256, 64, True, None, 0),     # GQA causal
    (1, 4, 1, 128, 128, 128, True, 64, 0),      # MQA + sliding window
    (1, 4, 2, 100, 100, 64, True, None, 0),     # ragged (padding path)
    (2, 8, 4, 1, 512, 64, True, None, 511),     # decode: 1 query vs cache
    (1, 4, 4, 64, 256, 64, True, None, 192),    # chunked prefill offset
    (1, 4, 4, 128, 128, 64, False, None, 0),    # non-causal (encoder)
    (1, 16, 8, 1, 300, 64, True, 128, 299),     # decode + SWA, ragged cache
]
# the card checks the kernel further: every head dim's operand layout (D 16
# and 32 use TMA's 64- and 32-byte swizzles for 16-bit rows), query tiles
# cut by Sq against long and very long key ranges, a GQA group of 4 with a
# window, and the LM's prefill shape
CARD_ATTN_CASES = ATTN_CASES + [
    (1, 4, 2, 200, 200, 16, True, None, 0),     # D 16
    (1, 4, 2, 200, 200, 32, False, None, 0),    # D 32, non-causal
    (1, 8, 2, 65, 4096, 128, True, None, 4031),  # Sq 65, long Sk, offset
    (1, 4, 2, 65, 8192, 64, False, None, 0),    # Sq 65, Sk 8192
    (1, 16, 4, 300, 300, 128, True, 100, 0),    # GQA group 4 + window
    (8, 16, 8, 1024, 1024, 128, True, None, 0),  # qwen3-0.6b prefill
]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# Both sides compute in float32 and differ only in the order of the float32
# sums (dot products, softmax and mean-of-squares reductions): ~1e-6
# relative.  bfloat16 outputs are that float32 result rounded once, so a
# rounding flip costs one bfloat16 ulp; these are tests/test_kernels.py's
# Pallas-vs-oracle tolerances.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
RMS_TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
           "bfloat16": dict(rtol=float(torch.finfo(torch.bfloat16).eps),
                            atol=1e-6)}
# rms_norm computes in float32 for every dtype, on both sides: a float64
# output is that float32 result widened (float32's bound), a float16 output
# that result rounded once (one float16 ulp)
ALL_DTYPES = {"float32": torch.float32, "float64": torch.float64,
              "float16": torch.float16, "bfloat16": torch.bfloat16}
RMS_TOL.update(float64=RMS_TOL["float32"],
               float16=dict(rtol=float(torch.finfo(torch.float16).eps),
                            atol=1e-6))
# flash attention computes in float32 for every dtype as well: float64 at
# float32's bound, float16 at the bfloat16 rule's
TOL.update(float64=TOL["float32"], float16=TOL["bfloat16"])


def combine_close(got, want, mag, dtype):
    """|got - want| <= rtol * (summed term magnitudes) [+ one output ulp in
    bfloat16 and float16]: the kernel contracts a*b+c into one rounding,
    the plain version two."""
    acc = torch.promote_types(dtype, torch.float32)
    tol = (1e-13 if dtype == torch.float64 else 1e-6) * mag
    if dtype in (torch.bfloat16, torch.float16):
        tol = tol + want.to(acc).abs() * torch.finfo(dtype).eps
    return bool(torch.all((got.to(acc) - want.to(acc)).abs() <= tol))


def attn_inputs(case, seed=42):
    """float32 numpy (q, k, v) for an ``ATTN_CASES`` entry."""
    B, H, Hkv, Sq, Sk, D = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_kernel_matches_plain_on_card(dtype):
    dev = _on_card()
    tdt = DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(0)
    for rows, d in ((8192, 1024), (4099, 128), (7, 16), (33, 1000)):
        x = torch.randn(rows, d, generator=g, device=dev).to(tdt)
        r = torch.randn(rows, d, generator=g, device=dev).to(tdt)
        w = torch.randn(d, generator=g, device=dev)
        for res in (None, r):
            got = rms_kern.rms_norm(x, w, res)
            want = tref.rms_norm_ref(x, w, res)
            torch.testing.assert_close(got.float(), want.float(),
                                       **RMS_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(ALL_DTYPES))
@pytest.mark.parametrize("case", CARD_ATTN_CASES)
def test_flash_attention_kernel_matches_plain_on_card(case, dtype):
    dev = _on_card()
    _, _, _, _, _, _, causal, window, q_offset = case
    tdt = ALL_DTYPES[dtype]
    q, k, v = (torch.tensor(a, device=dev).to(tdt)
               for a in attn_inputs(case))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_kern.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(),
                               tref.attention_ref(q, k, v, **kw).float(),
                               **TOL[dtype])


# the LM zoo's shapes: head dim 160 (stablelm-12b, float32 tiles of 16 keys,
# 16-bit rows in TMA's 64-byte swizzle): its prefill shape, long keys with an
# offset, a window, ragged Sq; and internvl2-1b's GQA group of 7
ZOO_ATTN_CASES = [
    (8, 32, 8, 1024, 1024, 160, True, None, 0),  # stablelm-12b prefill
    (1, 8, 2, 65, 4096, 160, True, None, 4031),  # Sq 65, long Sk, offset
    (1, 8, 2, 300, 300, 160, True, 100, 0),      # GQA 4 + window
    (1, 4, 4, 77, 77, 160, False, None, 0),      # ragged, non-causal
    (2, 14, 2, 200, 200, 64, True, None, 0),     # internvl2-1b: group 7
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", ZOO_ATTN_CASES)
def test_flash_attention_zoo_shapes_match_plain_on_card(case, dtype):
    dev = _on_card()
    _, _, _, _, _, _, causal, window, q_offset = case
    tdt = getattr(torch, dtype)
    q, k, v = (torch.tensor(a, device=dev).to(tdt)
               for a in attn_inputs(case))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = flash_kern.flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(),
                               tref.attention_ref(q, k, v, **kw).float(),
                               **TOL["float32" if dtype == "float32"
                                     else "bfloat16"])


@pytest.mark.cuda
def test_flash_attention_refuses_unaligned_inputs_on_card():
    """TMA needs 16-byte aligned bases: a q at storage offset 1 raises
    before any launch, and nothing is computed another way."""
    dev = _on_card()
    g = torch.Generator(device=dev).manual_seed(0)
    kv = torch.randn(1, 2, 64, 64, generator=g, device=dev)
    q = _misaligned((1, 4, 64, 64), 1, torch.float32, g, dev)
    launches = flash_kern.flash_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_kern.flash_attention(q, kv, kv)
    assert flash_kern.flash_attention.launches == launches


def _misaligned(shape, offset, dtype, g, dev):
    """A contiguous (shape) tensor at storage offset ``offset`` elements
    (1 breaks 16-byte alignment: rms_norm and the combines then take their
    scalar path, flash attention refuses it)."""
    n = 1
    for size in shape:
        n *= size
    flat = torch.randn(n + offset, generator=g, device=dev).to(dtype)
    return flat[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d", [16, 128, 384, 512, 1000, 1024, 4096, 8192,
                               12288])
@pytest.mark.parametrize("dtype", sorted(ALL_DTYPES))
def test_rms_norm_kernel_paths_match_plain_on_card(dtype, d, offset):
    """Every launch path: 16-byte or scalar accesses (offset 1), a warp,
    a few warps or a block per row (8192 rows against 1 and 8), groups of
    warps that are not a power of two, several to a block (d 384 in
    float32: 96 threads a row, two rows in a 192-thread block), the row
    in registers or walked twice (d 12288 in float64, d >= 8192 on the
    scalar path), with and without the residual."""
    dev = _on_card()
    tdt = ALL_DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(d + offset)
    w = torch.randn(d, generator=g, device=dev)
    for rows in (1, 8, 8192):
        x = _misaligned((rows, d), offset, tdt, g, dev)
        r = _misaligned((rows, d), offset, tdt, g, dev)
        for res in (None, r):
            got = rms_kern.rms_norm(x, w, res)
            want = tref.rms_norm_ref(x, w, res)
            torch.testing.assert_close(got.float(), want.float(),
                                       **RMS_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 11008, 1000003, 4000000])
@pytest.mark.parametrize("dtype", sorted(ALL_DTYPES))
def test_butcher_combine_kernel_paths_match_plain_on_card(dtype, n, offset):
    """s = 1..13 stages on the 16-byte path (n = 11008 and 4e6, the
    latter at full blocks) and the scalar one (an odd n, or offset 1)."""
    dev = _on_card()
    tdt = ALL_DTYPES[dtype]
    acc = torch.promote_types(tdt, torch.float32)
    g = torch.Generator(device=dev).manual_seed(n + offset)
    for s in range(1, combine_kern.MAX_STAGES + 1):
        x = _misaligned((n,), offset, tdt, g, dev)
        ks = _misaligned((s, n), offset, tdt, g, dev)
        hc = torch.randn(s, generator=g, device=dev,
                         dtype=torch.float64).to(acc)
        got = combine_kern.butcher_combine(x, ks, hc)
        want = tref.butcher_combine_ref(x, ks, hc, 1.0)
        mag = x.to(acc).abs() + hc.abs() @ ks.to(acc).abs()
        assert combine_close(got, want, mag, tdt), f"s={s}"


def rows_close(got, want, mag, dtype):
    """``combine_close`` where the output ulp is the true one: below the
    smallest normal number of a 16-bit type the spacing is fixed (2^-24 in
    float16), not eps * |want|.  A random base scale sc lets a row cancel
    into that range while its term magnitudes stay small."""
    if dtype not in (torch.bfloat16, torch.float16):
        return combine_close(got, want, mag, dtype)
    fi = torch.finfo(dtype)
    return combine_close(got, want, mag, dtype) or bool(torch.all(
        (got.float() - want.float()).abs()
        <= 1e-6 * mag + torch.clamp_min(want.float().abs(),
                                        fi.smallest_normal) * fi.eps))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 11008, 1000003, 4000000])
@pytest.mark.parametrize("dtype", sorted(ALL_DTYPES))
def test_butcher_combine_rows_kernel_paths_match_plain_on_card(dtype, n,
                                                               offset):
    """The rows kernel with one (m, s) block of rows: s = 1..13 and m = 1,
    2 (the solver's, all coefficients loaded up front) and 13, on the
    16-byte path and the scalar one."""
    dev = _on_card()
    tdt = ALL_DTYPES[dtype]
    acc = torch.promote_types(tdt, torch.float32)
    g = torch.Generator(device=dev).manual_seed(n + offset + 7)
    for s in range(1, combine_kern.MAX_STAGES + 1):
        x = _misaligned((n,), offset, tdt, g, dev)
        ks = _misaligned((s, n), offset, tdt, g, dev)
        for m in (1, 2, combine_kern.MAX_ROWS):
            hc = torch.randn((m, s), generator=g, device=dev,
                             dtype=torch.float64).to(acc)
            sc = torch.randn(m, generator=g, device=dev,
                             dtype=torch.float64).to(acc)
            got = combine_kern.butcher_combine_rows(x, ks, hc, sc)
            want = tref.butcher_combine_rows_ref(x, ks, hc, sc, 1.0)
            mag = sc.abs()[:, None] * x.to(acc).abs() + \
                hc.abs() @ ks.to(acc).abs()
            assert rows_close(got, want, mag, tdt), f"s={s} m={m}"


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n_lane", [1, 3, 43, 44, 4096])
@pytest.mark.parametrize("lanes", [1, 3, 256])
@pytest.mark.parametrize("dtype", sorted(ALL_DTYPES))
def test_butcher_combine_lane_forms_match_plain_on_card(dtype, lanes, n_lane,
                                                        offset):
    """Both kernels with one coefficient row per lane (x (B, n_lane), ks
    (s, B, n_lane)): lanes shorter than a vector (the scalar path), lanes
    whose boundaries fall inside a 16-byte vector (n_lane 43 in float32:
    the per-sample CNF's), s = 1..13, and m = 1, 2, 13 rows."""
    dev = _on_card()
    tdt = ALL_DTYPES[dtype]
    acc = torch.promote_types(tdt, torch.float32)
    g = torch.Generator(device=dev).manual_seed(lanes * n_lane + offset)
    for s in range(1, combine_kern.MAX_STAGES + 1):
        x = _misaligned((lanes, n_lane), offset, tdt, g, dev)
        ks = _misaligned((s, lanes, n_lane), offset, tdt, g, dev)
        ka = ks.to(acc).abs()
        hc = torch.randn((lanes, s), generator=g, device=dev,
                         dtype=torch.float64).to(acc)
        got = combine_kern.butcher_combine(x, ks, hc)
        mag = x.to(acc).abs() + torch.einsum("bi,ibn->bn", hc.abs(), ka)
        assert combine_close(got, tref.butcher_combine_ref(x, ks, hc, 1.0),
                             mag, tdt), f"s={s}"
        for m in (1, 2, combine_kern.MAX_ROWS):
            hm = torch.randn((lanes, m, s), generator=g, device=dev,
                             dtype=torch.float64).to(acc)
            sc = torch.randn(m, generator=g, device=dev,
                             dtype=torch.float64).to(acc)
            got = combine_kern.butcher_combine_rows(x, ks, hm, sc)
            want = tref.butcher_combine_rows_ref(x, ks, hm, sc, 1.0)
            mag = sc.abs()[:, None, None] * x.to(acc).abs() + \
                torch.einsum("bri,ibn->rbn", hm.abs(), ka)
            assert rows_close(got, want, mag, tdt), f"s={s} m={m}"


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [8, 16])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_butcher_combine_lane_forms_at_serve_shape_on_card(dtype, lanes):
    """The ODE server's call shapes (n_lane 1024): dopri5's stage rows
    (s 1..6) and its solution + error rows (s 7, m 2, sc (1, 0)), h_b per
    lane, every third lane free (h 0: all-zero rows), which must give x
    (one-row) and x, 0 (rows) exactly."""
    from repro_torch.core import get_tableau
    dev = _on_card()
    tdt = ALL_DTYPES[dtype]
    tab = get_tableau("dopri5")
    g = torch.Generator(device=dev).manual_seed(lanes)
    h = torch.empty(lanes, device=dev, dtype=torch.float64).uniform_(
        0.005, 0.2, generator=g)
    free = torch.arange(lanes, device=dev) % 3 == 1
    h[free] = 0.0
    x = torch.randn((lanes, 1024), generator=g, device=dev).to(tdt)
    ks = torch.randn((tab.s, lanes, 1024), generator=g, device=dev).to(tdt)
    a = torch.tensor(tab.a, dtype=torch.float64, device=dev)
    for s in range(1, tab.s):
        hc = (h[:, None] * a[s, :s]).to(tdt)
        got = combine_kern.butcher_combine(x, ks[:s], hc)
        mag = x.abs() + torch.einsum("bi,ibn->bn", hc.abs(), ks[:s].abs())
        assert combine_close(got, tref.butcher_combine_ref(x, ks[:s], hc,
                                                           1.0), mag, tdt), s
        assert torch.equal(got[free], x[free]), s
    be = torch.tensor((tab.b, tab.b_err), dtype=torch.float64, device=dev)
    hm = (h[:, None, None] * be).to(tdt)
    sc = torch.tensor([1.0, 0.0], dtype=tdt, device=dev)
    got = combine_kern.butcher_combine_rows(x, ks, hm, sc)
    mag = sc.abs()[:, None, None] * x.abs() + \
        torch.einsum("bri,ibn->rbn", hm.abs(), ks.abs())
    assert rows_close(got, tref.butcher_combine_rows_ref(x, ks, hm, sc, 1.0),
                      mag, tdt)
    assert torch.equal(got[0][free], x[free])
    assert not bool(got[1][free].any())


# ---------------------------------------------------------------------------
# The gradient strategies on the kernel path (backend "cuda") against the
# plain path (backend "torch"), both on the card, float64.  The kernels fuse
# a*b+c into one rounding, so the two differ at float64 rounding carried
# through the solves: chip_smoke's phase-4 rule, rtol 1e-9 of the largest
# entry per leaf.

def _strategy_field(state, t, p):
    x, v = state
    h = torch.tanh(x @ p["w1"] + p["b1"] + t)
    return (h @ p["w2"] + p["b2"], -v * p["c"] + torch.sin(t) * x[..., :3])


def _strategy_case(lanes, dev):
    rng = np.random.default_rng(21)
    lead = (3,) if lanes else ()
    x0 = (rng.normal(size=lead + (4,)), rng.normal(size=lead + (3,)))
    params = {"w1": rng.normal(size=(4, 6)) * 0.6, "b1": rng.normal(size=6),
              "w2": rng.normal(size=(6, 4)) * 0.6, "b2": rng.normal(size=4),
              "c": rng.normal(size=3) * 0.5}
    return ([torch.tensor(l, device=dev, requires_grad=True) for l in x0],
            {k: torch.tensor(v, device=dev, requires_grad=True)
             for k, v in params.items()})


STRATEGY_CASES = ["remat_step", "remat_solve", "adjoint_fixed",
                  "adjoint_adaptive", "adjoint_lanes"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STRATEGY_CASES)
def test_strategies_kernel_path_matches_plain_on_card(case):
    from repro_torch.core import AdaptiveConfig, solve
    dev = _on_card()
    lanes = case == "adjoint_lanes"
    gradient = "adjoint" if case.startswith("adjoint") else case
    stepping = 6 if case in ("remat_step", "remat_solve", "adjoint_fixed") \
        else AdaptiveConfig(rtol=1e-7, atol=1e-9, initial_step=0.1)
    grads = []
    for backend in ("cuda", "torch"):
        x0, params = _strategy_case(lanes, dev)
        sol = solve(_strategy_field, tuple(x0), params, gradient=gradient,
                    stepping=stepping, backend=backend,
                    batch_axis=0 if lanes else None)
        loss = torch.sum(torch.tanh(sol.ys[0]) ** 2) + torch.sum(
            sol.ys[1] ** 3)
        grads.append(torch.autograd.grad(loss, x0 + list(params.values())))
        if not isinstance(stepping, int):
            grads[-1] += tuple(v.to(dev).double()
                               for v in sol.stats.values())
    for a, b in zip(*grads):
        assert a.device.type == "cuda"
        err = float((a - b).abs().max())
        assert err <= 1e-9 * max(float(b.abs().max()), 1e-3), err


# ---------------------------------------------------------------------------
# SaveAt on the kernel path against the plain path, both on the card,
# float64, the same rule: Hermite dense output (the one-row kernel's lane
# form, s 3, one lane per observation), dopri8 (s 12) fixed and adaptive
# SaveAt solves with the symplectic gradient, the per-sample SaveAt cell,
# and one physics rollout_loss gradient.

SAVEAT_CASES = ["dense", "dopri8_fixed", "dopri8_adaptive", "lanes",
                "rollout_loss"]


def _saveat_grads(case, backend, dev):
    from repro_torch.core import AdaptiveConfig, SaveAt, solve
    if case == "rollout_loss":
        from repro_torch.models import physics
        cfg = physics.PhysicsConfig(grid=16, channels=4, hidden=8,
                                    combine_backend=backend, n_steps=2)
        params = physics.init_energy_net(cfg, seed=0, device=dev,
                                         dtype=torch.float64)
        leaves = list(params.values())
        for p in leaves:
            p.requires_grad_(True)
        rng = np.random.default_rng(23)
        u = torch.tensor(0.3 * rng.normal(size=(3, 2, 16)), device=dev)
        loss = physics.rollout_loss(params, u, cfg)
        return torch.autograd.grad(loss, leaves)
    lanes = case == "lanes"
    x0, params = _strategy_case(lanes, dev)
    cfg = AdaptiveConfig(rtol=1e-7, atol=1e-9, initial_step=0.1)
    kw = {"dense": dict(saveat=SaveAt(ts=[0.3, 0.55, 1.0], dense=True),
                        gradient="backprop", stepping=cfg),
          "dopri8_fixed": dict(method="dopri8", stepping=3),
          "dopri8_adaptive": dict(method="dopri8", stepping=cfg),
          "lanes": dict(stepping=cfg, batch_axis=0)}[case]
    kw.setdefault("saveat", SaveAt(ts=[0.3, 0.55, 1.0]))
    sol = solve(_strategy_field, tuple(x0), params, backend=backend, **kw)
    loss = torch.sum(torch.tanh(sol.ys[0]) ** 2) + torch.sum(sol.ys[1] ** 3)
    grads = torch.autograd.grad(loss, x0 + list(params.values()))
    return grads + tuple(v.to(dev).double() for v in sol.stats.values())


@pytest.mark.cuda
@pytest.mark.parametrize("case", SAVEAT_CASES)
def test_saveat_kernel_path_matches_plain_on_card(case):
    dev = _on_card()
    combine_kern.butcher_combine.launches = 0
    got = _saveat_grads(case, "cuda", dev)
    assert combine_kern.butcher_combine.launches > 0
    want = _saveat_grads(case, "torch", dev)
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        err = float((a - b).abs().max())
        assert err <= 1e-9 * max(float(b.abs().max()), 1e-3), err


# ---------------------------------------------------------------------------
# The ODE solve server on the kernel path (backend "cuda") against the plain
# path (backend "torch"), both on the card, float64: the same request
# stream through the continuous-batching engine (both combines' lane forms,
# a coefficient row per lane, the free lanes' rows all zero); integer stats
# equal, x_final by the same rule.

@pytest.mark.cuda
@pytest.mark.parametrize("buckets", [(2, 4, 8), (16,)])
def test_serve_engine_kernel_path_matches_plain_on_card(buckets):
    from repro_torch.core import get_tableau
    from repro_torch.launch.serve import ode_config, ode_field, ode_params
    from repro_torch.serve import EngineConfig, SolveEngine, synthetic_stream
    dev = _on_card()
    params = ode_params(8, 16, 0, torch.float64, dev)
    reqs = synthetic_stream(10, 8, seed=5, dtype=torch.float64, device=dev)
    runs = []
    for backend in ("cuda", "torch"):
        on = backend == "cuda"
        combine_kern.butcher_combine.launches = 0
        combine_kern.butcher_combine_rows.launches = 0
        engine = SolveEngine(ode_field, get_tableau("dopri5"),
                             ode_config(128), params,
                             torch.zeros(8, dtype=torch.float64, device=dev),
                             EngineConfig(buckets=buckets),
                             combine_backend=backend)
        warm = (combine_kern.butcher_combine.launches,
                combine_kern.butcher_combine_rows.launches)
        # one warm-up attempt per bucket at construction
        assert warm == ((6 * len(buckets), len(buckets)) if on
                        else (0, 0)), warm
        combine_kern.butcher_combine.launches = 0
        combine_kern.butcher_combine_rows.launches = 0
        runs.append(engine.run(reqs))
        steps = engine.stats["steps_total"]
        kernel = (combine_kern.butcher_combine.launches,
                  combine_kern.butcher_combine_rows.launches)
        assert kernel == ((6 * steps, steps) if on else (0, 0)), kernel
    got, want = runs
    for rid, w in want.items():
        g = got[rid]
        assert g.succeeded and (g.n_accepted, g.n_fevals, g.n_attempts) == \
            (w.n_accepted, w.n_fevals, w.n_attempts), rid
        assert g.x_final.device.type == "cuda"
        err = float((g.x_final - w.x_final).abs().max())
        assert err <= 1e-9 * float(w.x_final.abs().max()), err


# ---------------------------------------------------------------------------
# the backward kernels (rms_norm_bwd, flash_attention_bwd) and the
# differentiable kernel path
# ---------------------------------------------------------------------------

# the backward kernels compute in the input's dtype (float32 or float64),
# as their plain versions do; they differ in the order of the sums:
# |kernel - plain| <= tol * max|plain| per output
BWD_DTYPES = {"float32": torch.float32, "float64": torch.float64}
BWD_TOL = {"float32": 1e-4, "float64": 1e-12}
RMS_BWD_TOL = {"float32": 1e-5, "float64": 1e-12}


def _rel_err(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-300))


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("rows,d", [
    (8192, 1024), (131072, 128), (1, 16), (7, 1000), (33, 4096), (4099, 128),
    # the training shapes' k_norm; a partial last chunk (49 rows a chunk,
    # 46 in the last); fewer rows than one chunk (32 rows at least)
    (65536, 128), (12345, 1024), (20, 128)])
@pytest.mark.parametrize("dtype", sorted(BWD_DTYPES))
def test_rms_norm_bwd_kernel_matches_plain_on_card(dtype, rows, d, residual):
    dev = _on_card()
    tdt = BWD_DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(rows + d)
    x, r, dy = (torch.randn(rows, d, generator=g, device=dev, dtype=tdt)
                for _ in range(3))
    w = torch.randn(d, generator=g, device=dev, dtype=tdt)
    res = r if residual else None
    dx, dw = rms_kern.rms_norm_bwd(x, w, res, dy)
    wdx, wdw, wdres = tref.rms_norm_bwd_ref(x, w, res, dy)
    assert _rel_err(dx, wdx) <= RMS_BWD_TOL[dtype]
    assert _rel_err(dw, wdw) <= RMS_BWD_TOL[dtype]
    # deterministic: the same bits on a second call (no atomics)
    dx2, dw2 = rms_kern.rms_norm_bwd(x, w, res, dy)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("rows,d,offset", [
    (33, 999, 0),      # odd d: one element at a time
    (64, 1024, 1),     # a view at storage offset 1: one element at a time
    (9, 20000, 0),     # float32 past 16384 (float64 past 8192): two walks
    (5, 4099, 0),      # odd and past 4096: two walks, one element at a time
])
@pytest.mark.parametrize("dtype", sorted(BWD_DTYPES))
def test_rms_norm_bwd_kernel_paths_on_card(dtype, rows, d, offset, residual):
    """The one-pass kernel's other paths: the scalar accesses and the rows
    too long for registers, against the plain version and bitwise against
    a second call."""
    dev = _on_card()
    tdt = BWD_DTYPES[dtype]
    g = torch.Generator(device=dev).manual_seed(rows * d + offset)

    def view():
        buf = torch.randn(rows * d + offset, generator=g, device=dev,
                          dtype=tdt)
        return buf[offset:].view(rows, d)

    x, r, dy = view(), view(), view()
    w = torch.randn(d, generator=g, device=dev, dtype=tdt)
    res = r if residual else None
    dx, dw = rms_kern.rms_norm_bwd(x, w, res, dy)
    wdx, wdw, _ = tref.rms_norm_bwd_ref(x, w, res, dy)
    assert _rel_err(dx, wdx) <= RMS_BWD_TOL[dtype]
    assert _rel_err(dw, wdw) <= RMS_BWD_TOL[dtype]
    dx2, dw2 = rms_kern.rms_norm_bwd(x, w, res, dy)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.cuda
def test_rms_norm_bwd_refuses_other_dtypes_on_card():
    dev = _on_card()
    x = torch.ones(4, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="not supported"):
        rms_kern.rms_norm_bwd(x, torch.ones(16, device=dev), None, x)


# the float32 kernels' tiles cut off-edge: 64 keys x 16 queries (dK/dV, and
# the dS blocks), 128 queries x 32 keys (dQ); GQA groups 1, 2 and 4 and every
# head dim among them
BWD_EDGE_CASES = [
    (1, 4, 4, 77, 77, 16, True, None, 0),       # group 1, D 16, ragged
    (1, 4, 2, 130, 200, 32, False, None, 0),    # group 2, D 32, off the tiles
    (1, 8, 2, 100, 333, 64, True, None, 233),   # group 4, q_offset, Sq < Sk
    (1, 4, 4, 256, 256, 128, True, 8, 0),       # window 8, under one tile
    (2, 8, 4, 48, 300, 128, True, 20, 252),     # window + offset, Sq < Sk
    (1, 8, 2, 129, 129, 32, True, 5, 0),        # window 5, one past 128
]
BWD_ATTN_CASES = CARD_ATTN_CASES + [
    (2, 8, 2, 65, 300, 64, True, 40, 235),      # window + offset, GQA 4
    (1, 4, 2, 200, 150, 32, False, None, 0),    # Sq > Sk
    (1, 6, 3, 37, 37, 16, True, 7, 0),          # odd sizes, D 16
] + BWD_EDGE_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(BWD_DTYPES))
@pytest.mark.parametrize("case", BWD_ATTN_CASES)
def test_flash_attention_bwd_kernel_matches_plain_on_card(case, dtype):
    dev = _on_card()
    B, H, Hkv, Sq, Sk, D, causal, window, q_offset = case
    tdt = BWD_DTYPES[dtype]
    q, k, v = (torch.tensor(a, device=dev).to(tdt)
               for a in attn_inputs(case))
    do = torch.tensor(np.random.default_rng(5).normal(size=(B, H, Sq, D)),
                      device=dev).to(tdt)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_kern.flash_attention(q, k, v, return_lse=True, **kw)
    # the forward's log-sum-exp is float32 (the forward computes in float)
    torch.testing.assert_close(lse, tref.attention_lse_ref(q, k, **kw)
                               .float(), rtol=1e-5, atol=1e-5)
    got = flash_kern.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = tref.attention_bwd_ref(q, k, v, o, lse, do, **kw)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel_err(a, b) <= BWD_TOL[dtype]
    again = flash_kern.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_flash_attention_lse_costs_the_serve_path_nothing_on_card():
    """Without ``return_lse`` the forward writes no log-sum-exp and gives
    the same output bits as with it."""
    dev = _on_card()
    case = (2, 8, 4, 256, 256, 128, True, None, 0)
    q, k, v = (torch.tensor(a, device=dev) for a in attn_inputs(case))
    o1 = flash_kern.flash_attention(q, k, v)
    o2, lse = flash_kern.flash_attention(q, k, v, return_lse=True)
    assert torch.equal(o1, o2) and lse.shape == (2, 8, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(BWD_DTYPES))
def test_kernel_path_autograd_matches_plain_on_card(dtype):
    """ops.rms_norm / ops.attention with tensors that require grad: the
    backward kernels run (their counters move), and the gradients equal
    the plain versions' autograd (float32: the forward computes in float
    on both paths, 1e-4; float64: the kernels' float64 backward against
    autograd of the float32-inside plain version, float32's bound)."""
    from repro_torch.kernels import ops
    dev = _on_card()
    tdt = BWD_DTYPES[dtype]
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(64, 128, generator=gen, device=dev, dtype=tdt)
    r = torch.randn(64, 128, generator=gen, device=dev, dtype=tdt)
    w = torch.randn(128, generator=gen, device=dev, dtype=tdt)
    case = (2, 4, 2, 96, 96, 64, True, None, 0)
    q, k, v = (torch.tensor(a, device=dev).to(tdt)
               for a in attn_inputs(case))
    grads = []
    for use in (None, False):
        leaves = [t.clone().requires_grad_() for t in (x, r, w, q, k, v)]
        xx, rr, ww, qq, kk, vv = leaves
        y = ops.rms_norm(xx, ww, rr, use_kernels=use)
        o = ops.attention(qq, kk, vv, use_kernels=use)
        (y.square().sum() + o.square().sum()).backward()
        grads.append([t.grad for t in leaves])
    before = (rms_kern.rms_norm_bwd.launches,
              flash_kern.flash_attention_bwd.launches)
    xx = x.clone().requires_grad_()
    ops.rms_norm(xx, w).sum().backward()
    qq = q.clone().requires_grad_()
    ops.attention(qq, k, v).sum().backward()
    assert (rms_kern.rms_norm_bwd.launches,
            flash_kern.flash_attention_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    for a, b in zip(*grads):
        assert _rel_err(a, b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["discrete", "node_symplectic"])
def test_lm_train_step_kernel_path_matches_plain_on_card(mode):
    """One smoke-width train step on the card through the kernels against
    the same step with the plain versions (use_kernels=False): loss and
    grad_norm within float32's bound, and a second run of the kernel step
    bitwise equal (deterministic algorithms on)."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import NodeConfig
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.train import TrainConfig, init_train_state, \
        make_train_step
    dev = _on_card()
    arch = get_smoke_arch("qwen3-0.6b")
    if mode == "node_symplectic":
        arch = arch.with_(node=NodeConfig(mode="node",
                                          grad_mode="symplectic"))
    b = synthetic_lm_batch(0, 4, 17, arch.vocab)
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in b.items()}
    from torch.utils import _pytree as pytree
    state = init_train_state(arch, TrainConfig(), device=dev)
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for use in (None, False, None):
            step = make_train_step(arch.with_(use_kernels=use),
                                   TrainConfig())
            out.setdefault(use, []).append(step(state, batch))
    finally:
        torch.use_deterministic_algorithms(False)
    (s1, m1), (s2, m2) = out[None]
    _, mp = out[False][0]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m1[key]), float(mp[key]),
                                   rtol=1e-4)
        assert float(m1[key]) == float(m2[key])
    assert all(torch.equal(a, b_) for a, b_ in zip(
        pytree.tree_leaves(s1.params), pytree.tree_leaves(s2.params)))
