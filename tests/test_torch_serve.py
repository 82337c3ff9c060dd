"""PyTorch port: the continuous-batching solve engine against the JAX package.

Float64 on the CPU, ``tests/test_serve.py``'s problem (dopri5, a 3-dim tanh
field with a time term, rtol 1e-6 / atol 1e-8 for free lanes), its streams
(``synthetic_stream`` seeds 7, 11, 3, 9) and its params as numpy arrays:

* PARITY — every request served by the port's engine has JAX's engine's
  ``n_accepted``, ``n_fevals``, ``n_attempts`` and ``succeeded`` exactly,
  and its x_final within rtol 1e-10 / atol 1e-12 (cross-library step sizes
  agree to ~1e-11, ROADMAP queue 3).  Once with DIM == B, where a per-lane
  tolerance broadcast over the state's last axis would go unnoticed by
  shape.  JAX's engine runs once per stream.
* EQUIVALENCE — a request served out of the shared slot state equals the
  same request served alone at the same bucket bit for bit; across
  buckets, integer stats exact and x_final within rtol 1e-12; the naive
  sequential baseline: stats exact, x_final within rtol 1e-9.
* CONTINUOUS BATCHING — requests join a RUNNING batch, the state grows
  through its buckets, and the slot tensors keep their storage across
  ``step`` (the counterpart of JAX's donated slot state).
* PAUSE/RESUME — the slot state sent through host numpy mid-run finishes
  bit for bit as the uninterrupted run.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

jax.config.update("jax_enable_x64", True)

from repro.core import AdaptiveConfig as JConfig
from repro.core.tableau import get_tableau as jget
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import SolveEngine as JSolveEngine
from repro.serve import poisson_arrivals as j_arrivals
from repro.serve import synthetic_stream as j_stream
from repro_torch.core import AdaptiveConfig, get_tableau
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import (EngineConfig, Request, SolveEngine,
                               latency_summary, naive_sequential_solve,
                               params_from_checkpoint, params_from_jax,
                               poisson_arrivals, serve_timed,
                               synthetic_stream)

TAB, JTAB = get_tableau("dopri5"), jget("dopri5")
CFG = AdaptiveConfig(rtol=1e-6, atol=1e-8, max_steps=128, initial_step=0.05)
JCFG = JConfig(rtol=1e-6, atol=1e-8, max_steps=128, initial_step=0.05)
DIM = 3
RTOL, ATOL = 1e-10, 1e-12           # against JAX, float64
ACROSS = 1e-12                      # across buckets (a GEMM of other rows)
NAIVE = 1e-9                        # single-trajectory path (JAX's bound)
STATS = ("n_accepted", "n_fevals", "n_attempts", "succeeded")


def jfield(x, t, p):
    return jnp.tanh(x @ p["w"] + p["b"]) - 0.3 * x * jnp.sin(t)


def field(x, t, p):
    return torch.tanh(x @ p["w"] + p["b"]) - 0.3 * x * torch.sin(t)


@functools.lru_cache(maxsize=None)
def jparams(dim):
    return {"w": jax.random.normal(jax.random.PRNGKey(0), (dim, dim)) * 0.5,
            "b": jax.random.normal(jax.random.PRNGKey(1), (dim,)) * 0.1}


def params(dim=DIM):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams(dim)),
                           device="cpu")


def stream(n, seed, dim=DIM):
    return synthetic_stream(n, dim, seed=seed, dtype=torch.float64,
                            device="cpu")


def make_engine(buckets=(2, 4), dim=DIM, check_every=1):
    return SolveEngine(field, TAB, CFG, params(dim),
                       x0_template=torch.zeros(dim, dtype=torch.float64),
                       engine_cfg=EngineConfig(buckets=buckets,
                                               check_every=check_every))


@functools.lru_cache(maxsize=None)
def jax_results(n, seed, buckets, dim=DIM):
    """JAX's engine over the same stream, once per (stream, buckets)."""
    engine = JSolveEngine(jfield, JTAB, JCFG, jparams(dim),
                          x0_template=jnp.zeros((dim,)),
                          engine_cfg=JEngineConfig(buckets=buckets))
    return engine.run(j_stream(n, dim, seed=seed)), engine.stats


def solo(req, buckets):
    return make_engine(buckets=buckets, dim=req.x0.shape[0]).run([req])[0]


def assert_same_stats(got, want, rid):
    assert tuple(getattr(got, k) for k in STATS) == \
        tuple(getattr(want, k) for k in STATS), rid


def assert_bitwise(got, want, rid):
    assert_same_stats(got, want, rid)
    assert torch.equal(got.x_final, want.x_final), rid


def assert_close(got, want, rid, rtol, atol=0.0):
    assert_same_stats(got, want, rid)
    np.testing.assert_allclose(got.x_final.numpy(), want.x_final.numpy(),
                               rtol=rtol, atol=atol, err_msg=str(rid))


# (requests, stream seed, buckets): tests/test_serve.py's four streams, and
# DIM == B = 4 on one fixed bucket
CASES = [(6, 7, (2, 4), DIM), (5, 11, (2,), DIM), (6, 3, (2, 4, 8), DIM),
         (4, 9, (2, 4), DIM), (6, 7, (4,), 4)]


@pytest.mark.parametrize("n,seed,buckets,dim", CASES)
def test_engine_matches_jax_engine(n, seed, buckets, dim):
    want, want_stats = jax_results(n, seed, buckets, dim)
    engine = make_engine(buckets=buckets, dim=dim)
    got = engine.run(stream(n, seed, dim))
    assert sorted(got) == sorted(want) == list(range(n))
    assert engine.stats == want_stats
    for rid in range(n):
        w = want[rid]
        assert (got[rid].n_accepted, got[rid].n_fevals,
                got[rid].n_attempts, got[rid].succeeded) == \
            (w.n_accepted, w.n_fevals, w.n_attempts, w.succeeded), rid
        np.testing.assert_allclose(got[rid].x_final.numpy(),
                                   np.asarray(w.x_final), rtol=RTOL,
                                   atol=ATOL, err_msg=str(rid))


def test_engine_matches_single_solves():
    """Demand 6 grows (2, 4) to 4 lanes at the first boundary, so every
    request runs at B 4: bitwise against serving it alone at B 4, stats
    exact and 1e-12 against B 2."""
    reqs = stream(6, 7)
    engine = make_engine()
    results = engine.run(reqs)
    assert engine.stats["inserted_while_running"] > 0
    for rid, req in enumerate(reqs):
        assert results[rid].succeeded
        assert_bitwise(results[rid], solo(req, (4,)), rid)
        assert_close(results[rid], solo(req, (2,)), rid, ACROSS)


def test_insertion_into_running_batch_single_bucket():
    """A fixed 2-lane state serving 5 requests forces evict-then-insert
    against live lanes; late arrivals join mid-flight neighbours."""
    reqs = stream(5, 11)
    engine = make_engine(buckets=(2,))
    results = engine.run(reqs)
    assert len(results) == 5
    assert engine.stats["lanes"] == 2
    assert engine.stats["inserted_while_running"] >= 3
    for rid, req in enumerate(reqs):
        assert_bitwise(results[rid], solo(req, (2,)), rid)


def test_bucket_growth_under_demand():
    reqs = stream(6, 3)
    engine = make_engine(buckets=(2, 4, 8))
    assert engine.stats["lanes"] == 2
    results = engine.run(reqs)
    assert engine.stats["lanes"] == 8      # demand 6 -> next bucket up
    assert len(results) == 6
    for rid, req in enumerate(reqs):
        assert_bitwise(results[rid], solo(req, (8,)), rid)
        assert_close(results[rid], solo(req, (2,)), rid, ACROSS)


def test_slot_tensors_keep_storage():
    """The in-place attempt: every slot tensor keeps its storage across
    ``step`` (growth reallocates; a fixed bucket never does)."""
    engine = make_engine(buckets=(2,))
    for req in stream(3, 5):
        engine.submit(req)
    tensors = lambda: [l for l in pytree.tree_leaves(engine._state)
                       if isinstance(l, torch.Tensor)]
    ptrs = [l.data_ptr() for l in tensors()]
    results = {}
    for _ in range(6):
        engine.step(results)
    assert engine.stats["steps_total"] == 6 and engine.occupancy > 0
    assert [l.data_ptr() for l in tensors()] == ptrs


def test_pause_resume_bit_exact():
    """The slot state through host numpy mid-run (and the engine going on
    from the restored tensors) finishes bit for bit as the uninterrupted
    run."""
    reqs = stream(5, 11)
    full = make_engine(buckets=(2,)).run(reqs)
    engine = make_engine(buckets=(2,))
    for req in reqs:
        engine.submit(req)
    results = {}
    for _ in range(4):
        engine.step(results)
    assert engine.occupancy > 0 and engine.pending > 0
    engine._state = pytree.tree_map(
        lambda l: torch.from_numpy(l.numpy().copy())
        if isinstance(l, torch.Tensor) else l, engine._state)
    while engine.pending or engine.occupancy:
        engine.step(results)
    assert sorted(results) == sorted(full)
    for rid in full:
        assert_bitwise(results[rid], full[rid], rid)


def test_naive_baseline_agrees_with_engine():
    reqs = stream(4, 9)
    results = make_engine().run(reqs)
    naive, lat = naive_sequential_solve(field, TAB, CFG, params(), reqs)
    assert len(lat) == 4
    for rid, sol in enumerate(naive):
        assert_close(results[rid], sol, rid, NAIVE, NAIVE)


def test_serve_timed_paces_arrivals():
    reqs = stream(4, 9)
    engine = make_engine()
    arrivals = poisson_arrivals(4, 400.0, seed=9)
    results = serve_timed(engine, reqs, arrivals)
    drained = make_engine().run(reqs)
    for rid in drained:
        assert_same_stats(results[rid], drained[rid], rid)
    lat = latency_summary(results)
    assert 0 < lat["p50_ms"] <= lat["p99_ms"]
    with pytest.raises(ValueError, match="one arrival time per request"):
        serve_timed(make_engine(), reqs, arrivals[:2])


def test_stream_matches_jax():
    """One seed, the same requests and arrivals in both packages."""
    for seed in (7, 11, 3, 9):
        got, want = stream(6, seed), j_stream(6, DIM, seed=seed)
        for g, w in zip(got, want):
            assert np.array_equal(g.x0.numpy(), np.asarray(w.x0))
            assert (g.t0, g.t1, g.rtol, g.atol) == \
                (w.t0, w.t1, w.rtol, w.atol)
    f32 = synthetic_stream(3, DIM, seed=7, device="cpu")
    assert f32[0].x0.dtype == torch.float32
    assert np.array_equal(poisson_arrivals(8, 12.5, seed=3),
                          j_arrivals(8, 12.5, seed=3))


def test_submit_rejects_mismatched_pytree():
    engine = make_engine()
    bad = Request(x0={"x": torch.zeros(DIM, dtype=torch.float64)}, t0=0.0,
                  t1=1.0, rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="pytree structure"):
        engine.submit(bad)


def test_engine_config_validation(tmp_path):
    with pytest.raises(ValueError, match="strictly increasing"):
        EngineConfig(buckets=(4, 4, 8))
    with pytest.raises(ValueError, match="check_every"):
        EngineConfig(check_every=0)
    # lane sharding is ported (tests/test_torch_parallel.py): a bucket that
    # does not fill whole lane shards is refused
    mesh = type("Mesh", (), {"shape": {"data": 4}, "axis_names": ("data",)})
    with pytest.raises(ValueError, match="divisible by 4"):
        EngineConfig(buckets=(4, 6), mesh=mesh)
    # the checkpoint handoff is ported (tests/test_torch_runtime.py): a
    # directory with no checkpoint is refused
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        params_from_checkpoint(str(tmp_path), like=None)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        SolveEngine.from_checkpoint(field, TAB, CFG, str(tmp_path), None,
                                    torch.zeros(DIM))


def test_check_every_sweeps_less_often():
    reqs = stream(5, 11)
    engine = make_engine(buckets=(2,), check_every=3)
    results = engine.run(reqs)
    assert engine.stats["steps_total"] % 3 == 0
    for rid, want in make_engine(buckets=(2,)).run(reqs).items():
        assert_same_stats(results[rid], want, rid)


def test_params_from_jax_takes_the_launcher_dict():
    k = jax.random.split(jax.random.PRNGKey(17), 4)
    jp = {"w1": jax.random.normal(k[0], (4, 8)) * 0.4,
          "b1": jax.random.normal(k[1], (8,)) * 0.1,
          "w2": jax.random.normal(k[2], (8, 4)) * 0.4,
          "b2": jax.random.normal(k[3], (4,)) * 0.1}
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    x = np.linspace(-1.0, 1.0, 4)
    want = jnp.tanh(x @ jp["w1"] + jp["b1"]) @ jp["w2"] + jp["b2"]
    got = serve_cli.ode_field(torch.tensor(x), 0.0, tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)


def test_serve_ode_cli_smoke():
    out = serve_cli.main(["ode", "--smoke", "--device", "cpu", "--naive"])
    assert out["requests"] == out["ok"] == 8
    assert out["naive"]["ok"] == 8
    assert out["stats"]["lanes"] == 4
    assert out["stats"]["inserted_while_running"] > 0
    paced = serve_cli.main(["ode", "--smoke", "--device", "cpu",
                            "--rate", "2000"])
    assert paced["requests"] == paced["ok"] == 8


def test_serve_ode_cli_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["ode", "--smoke"])
