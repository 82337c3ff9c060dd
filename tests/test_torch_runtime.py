"""PyTorch port: the training runtime (``repro_torch.runtime``: the
checkpoint contract and bounded retries), the fault-injection harness of
the training CLI, and the train -> serve handoff, on the CPU.

The checkpoint and retry cases are those of tests/test_runtime.py and
tests/test_failures.py, on torch trees.  The kill/resume cases run
``python -m repro_torch.launch.train --device cpu`` in subprocesses
(qwen3-0.6b SMOKE, 8 steps of batch 2 x 16 tokens) and SIGKILL it mid
epoch, and mid async save; the resumed metrics must equal the
uninterrupted run's bit for bit (json round-trips Python floats
exactly): there is no tolerance to tune.  The JAX package's training state
is checked for the same on-disk layout (``step_<N>/host_0.npz`` +
``MANIFEST.json``).
"""
import json
import os
import pathlib
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                       # minimal containers
    from hypothesis_compat import given, settings, st

from torch.utils import _pytree as pytree

from repro_torch.core import AdaptiveConfig, get_tableau
from repro_torch.runtime import Checkpointer, RetryConfig, run_with_retries
from repro_torch.serve import (EngineConfig, Request, SolveEngine,
                               params_from_checkpoint)
from repro_torch.train.state import TrainState, init_solver_stats

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 8, generator=g),
                       "b": torch.zeros(8)},
            "opt": {"m": {"w": torch.ones(8, 8), "b": torch.ones(8)},
                    "step": torch.tensor(7, dtype=torch.int32)},
            "err": None}


def _equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x is None:
            assert y is None
            continue
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# Checkpointer (tests/test_runtime.py's cases)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    s = _state()
    ck.save(3, s)
    like = pytree.tree_map(lambda l: None if l is None else
                           torch.zeros_like(l), s)
    restored, step = ck.restore(like)
    assert step == 3
    _equal(restored, s)
    # the JAX package's layout: arrays, then the manifest
    files = sorted(os.listdir(tmp_path / "step_3"))
    assert files == ["MANIFEST.json", "host_0.npz"]
    manifest = json.loads((tmp_path / "step_3" / "MANIFEST.json").read_text())
    assert manifest["n_leaves"] == 5 and manifest["step"] == 3


def test_checkpoint_keep_k_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    s = _state()
    for step in (1, 2, 3, 4):
        ck.save(step, s)
    assert ck.list_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_async(tmp_path):
    """An async save pulls to the host at once: overwriting the tensors
    after ``save`` returns does not change what is written."""
    ck = Checkpointer(str(tmp_path), keep=3, async_save=True,
                      write_delay_s=0.2)
    s = _state()
    want = pytree.tree_map(lambda l: None if l is None else l.clone(), s)
    ck.save(1, s, block=False)
    s["params"]["w"].fill_(123.0)
    ck.wait()
    assert ck.latest_step() == 1
    _equal(ck.restore(want)[0], want)


def test_checkpoint_ignores_partial(tmp_path):
    """A directory without MANIFEST (a crash mid-write) is not a valid
    checkpoint."""
    ck = Checkpointer(str(tmp_path))
    s = _state()
    ck.save(1, s)
    os.makedirs(tmp_path / "step_2")
    (tmp_path / "step_2" / "host_0.npz").write_bytes(b"garbage")
    assert ck.latest_step() == 1
    _, step = ck.restore(s)
    assert step == 1


def test_checkpoint_sweeps_stale_tmp_dirs(tmp_path):
    ck = Checkpointer(str(tmp_path))
    s = _state()
    ck.save(1, s)
    stale = tmp_path / ".tmp_step_9_0"
    stale.mkdir()
    (stale / "host_0.npz").write_bytes(b"half-written")
    assert ck.list_steps() == [1]
    ck2 = Checkpointer(str(tmp_path))          # a process restart sweeps it
    assert not stale.exists()
    stale.mkdir()
    ck2.save(2, s)                             # and so does the next save
    assert not stale.exists()
    assert ck2.list_steps() == [1, 2]


def test_checkpoint_restore_rejects_wrong_leaf_count(tmp_path):
    ck = Checkpointer(str(tmp_path))
    s = _state()
    ck.save(1, s)
    wrong = dict(s)
    wrong["params"] = dict(s["params"], extra=torch.zeros(3))
    with pytest.raises(ValueError, match="shape-contract mismatch"):
        ck.restore(wrong)
    reshaped = dict(s)
    reshaped["params"] = dict(s["params"], b=torch.zeros(9))
    with pytest.raises(ValueError, match="shape-contract mismatch"):
        ck.restore(reshaped)


def test_train_state_round_trips(tmp_path):
    """The full contract: a TrainState (uint8 generator state, int32
    counters, a None compression residual) restores field for field."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.train import TrainConfig, init_train_state
    arch = get_smoke_arch("qwen3-0.6b")
    state = init_train_state(arch, TrainConfig(), seed=4, device="cpu")
    ck = Checkpointer(str(tmp_path))
    ck.save(0, state)
    like = init_train_state(arch, TrainConfig(), seed=9, device="cpu")
    restored, step = ck.restore(like)
    assert isinstance(restored, TrainState) and step == 0
    _equal(restored, state)
    assert restored.compress_err is None


# ---------------------------------------------------------------------------
# run_with_retries (tests/test_failures.py's contract)
# ---------------------------------------------------------------------------

def _failing_fn(n_failures, exc=RuntimeError, value="ok"):
    calls = []

    def fn():
        calls.append(None)
        if len(calls) <= n_failures:
            raise exc(f"injected failure {len(calls)}")
        return value

    return fn, calls


@settings(max_examples=30, deadline=None)
@given(n_failures=st.integers(min_value=0, max_value=4),
       max_retries=st.integers(min_value=0, max_value=4))
def test_retry_contract(n_failures, max_retries):
    cfg = RetryConfig(max_retries=max_retries, backoff_s=0.5)
    fn, calls = _failing_fn(n_failures)
    failures, sleeps = [], []
    on_failure = lambda: failures.append(1)  # noqa: E731
    if n_failures <= max_retries:
        assert run_with_retries(fn, cfg, on_failure, sleeps.append) == "ok"
        assert len(calls) == n_failures + 1
        assert len(failures) == n_failures
        assert sleeps == [0.5 * k for k in range(1, n_failures + 1)]
    else:
        with pytest.raises(RuntimeError, match="injected failure"):
            run_with_retries(fn, cfg, on_failure, sleeps.append)
        assert len(calls) == max_retries + 1
        assert len(failures) == max_retries + 1
        assert sleeps == [0.5 * k for k in range(1, max_retries + 1)]


@settings(max_examples=10, deadline=None)
@given(exc=st.sampled_from([ValueError, KeyError, ArithmeticError]))
def test_retry_non_retryable_propagates_unwrapped(exc):
    cfg = RetryConfig(max_retries=3, retryable=(RuntimeError,))
    fn, calls = _failing_fn(5, exc=exc)
    failures, sleeps = [], []
    with pytest.raises(exc):
        run_with_retries(fn, cfg, lambda: failures.append(1), sleeps.append)
    assert len(calls) == 1 and failures == [] and sleeps == []


def test_retry_on_failure_can_mutate_state():
    state = {"good": False}
    cfg = RetryConfig(max_retries=2, backoff_s=0.0)

    def fn():
        if not state["good"]:
            raise RuntimeError("bad state")
        return 42

    def on_failure():
        state["good"] = True

    assert run_with_retries(fn, cfg, on_failure, lambda s: None) == 42


# ---------------------------------------------------------------------------
# the training CLI under SIGKILL (tests/test_failures.py's harness)
# ---------------------------------------------------------------------------

TOTAL_STEPS = 8     # 2 epochs x 4 steps; every run uses the same total
TRAIN_ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--epochs", "2",
              "--steps-per-epoch", "4", "--global-batch", "2",
              "--seq-len", "16", "--ckpt-every", "2", "--device", "cpu"]


def _train_cmd(grad_mode, ckpt_dir, metrics, extra=()):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGS,
           "--metrics-out", str(metrics)]
    if grad_mode:
        cmd += ["--grad-mode", grad_mode]
    if ckpt_dir is not None:
        cmd += ["--ckpt-dir", str(ckpt_dir)]
    return cmd + list(extra)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("OMP_NUM_THREADS", "2")
    env.update(extra)
    return env


def _run(cmd, env, timeout=300):
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, (
        f"training run failed (rc={proc.returncode}):\n--- stdout ---\n"
        f"{proc.stdout}\n--- stderr ---\n{proc.stderr}")
    return proc


def _load_metrics(path) -> dict:
    rows = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                rec = json.loads(line)
                rows[int(rec["step"])] = rec
    return rows


def _assert_bit_identical(golden, other, min_overlap=2):
    common = sorted(set(golden) & set(other))
    assert len(common) >= min_overlap, (
        f"only {len(common)} overlapping steps (need >= {min_overlap})")
    for step in common:
        for key in ("loss", "grad_norm", "lr"):
            assert golden[step][key] == other[step][key], (
                f"step {step} {key}: golden={golden[step][key]!r} "
                f"other={other[step][key]!r}")


def _kill_when(proc, predicate, timeout=180):
    t0 = time.time()
    try:
        while time.time() - t0 < timeout:
            if predicate():
                proc.kill()
                proc.wait()
                return True
            if proc.poll() is not None:
                return False
            time.sleep(0.02)
        raise AssertionError("kill condition never became true")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def golden_metrics(tmp_path_factory):
    cache = {}

    def get(grad_mode):
        if grad_mode not in cache:
            d = tmp_path_factory.mktemp(f"golden_{grad_mode}")
            path = d / "golden.jsonl"
            _run(_train_cmd(grad_mode, None, path), _env())
            rows = _load_metrics(path)
            assert sorted(rows) == list(range(TOTAL_STEPS))
            cache[grad_mode] = rows
        return cache[grad_mode]

    return get


def test_sigkill_mid_epoch_resume_bit_identical(tmp_path, golden_metrics):
    """Node mode with the symplectic adjoint: killed after a
    (seeded-)random step past the first checkpoint, resumed with
    ``--resume``: every step of the victim and of the resumed run equals
    the uninterrupted run."""
    golden = golden_metrics("symplectic")
    kill_after = random.Random("kill-symplectic").randint(3, 6)
    ckpt = tmp_path / "ckpt"
    victim = tmp_path / "victim.jsonl"
    victim.touch()
    proc = subprocess.Popen(
        _train_cmd("symplectic", ckpt, victim, ["--step-delay-s", "0.25"]),
        env=_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    killed = _kill_when(
        proc, lambda: len(victim.read_text().splitlines()) >= kill_after)
    assert killed, "the run finished before the fault landed (pacing broken)"
    done = _load_metrics(victim)
    assert len(done) < TOTAL_STEPS, "kill landed after the last step"
    resumed = tmp_path / "resumed.jsonl"
    out = _run(_train_cmd("symplectic", ckpt, resumed, ["--resume"]),
               _env())
    assert "resumed from step" in out.stdout
    rows = _load_metrics(resumed)
    assert max(rows) == TOTAL_STEPS - 1
    _assert_bit_identical(golden, rows, min_overlap=2)
    _assert_bit_identical(golden, done, min_overlap=1)
    assert set(done) | set(rows) == set(range(TOTAL_STEPS))


def test_sigkill_mid_async_save_resume(tmp_path, golden_metrics):
    """Killed between the array write and the manifest publish of an async
    save (REPRO_CKPT_WRITE_DELAY_S holds that window open): the half
    written ``.tmp_step_*`` is invisible, swept on the next boot, and the
    resumed trajectory is bit-identical (the discrete stack here)."""
    golden = golden_metrics(None)
    ckpt = tmp_path / "ckpt"
    victim = tmp_path / "victim.jsonl"
    victim.touch()
    proc = subprocess.Popen(
        _train_cmd(None, ckpt, victim, ["--step-delay-s", "0.1"]),
        env=_env(REPRO_CKPT_WRITE_DELAY_S="1.5"),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)

    def mid_save():
        if not ckpt.exists():
            return False
        names = os.listdir(ckpt)
        published = any(n.startswith("step_") and
                         (ckpt / n / "MANIFEST.json").exists()
                         for n in names)
        return published and any(n.startswith(".tmp_step_") for n in names)

    assert _kill_when(proc, mid_save), \
        "the run finished before a mid-save kill window opened"
    assert [n for n in os.listdir(ckpt) if n.startswith(".tmp_step_")]
    resumed = tmp_path / "resumed.jsonl"
    out = _run(_train_cmd(None, ckpt, resumed, ["--resume"]), _env())
    assert "resumed from step" in out.stdout
    assert not any(n.startswith(".tmp_step_") for n in os.listdir(ckpt))
    _assert_bit_identical(golden, _load_metrics(resumed), min_overlap=2)


def test_resume_requires_a_checkpoint(tmp_path):
    proc = subprocess.run(
        _train_cmd(None, tmp_path / "empty", tmp_path / "m.jsonl",
                   ["--resume"]),
        env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 3
    assert "no valid checkpoint" in proc.stderr


# ---------------------------------------------------------------------------
# train -> serve handoff
# ---------------------------------------------------------------------------

def _field(x, t, p):
    return torch.tanh(x @ p["w"] + p["b"])


def test_solve_engine_from_training_checkpoint(tmp_path):
    """The ODE serve engine boots from the params leaf of a training
    checkpoint and gives the same results as one built from the live
    params."""
    g = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(4, 4, generator=g, dtype=torch.float64) * 0.3,
              "b": torch.randn(4, generator=g, dtype=torch.float64) * 0.1}
    trained = TrainState(params=params,
                         opt={"step": torch.tensor(11, dtype=torch.int32)},
                         rng=torch.Generator().manual_seed(9).get_state(),
                         data_step=torch.tensor(11, dtype=torch.int32),
                         solver_stats=init_solver_stats())
    Checkpointer(str(tmp_path)).save(11, trained)
    like = pytree.tree_map(lambda l: None if l is None else
                           torch.zeros_like(l), trained)
    cfg = AdaptiveConfig(rtol=1e-4, atol=1e-6, max_steps=64,
                         initial_step=0.05)
    eng = SolveEngine.from_checkpoint(
        _field, get_tableau("bosh3"), cfg, str(tmp_path), like,
        x0_template=torch.zeros(4, dtype=torch.float64),
        engine_cfg=EngineConfig(buckets=(2,)))
    assert eng.restored_step == 11
    ref = SolveEngine(_field, get_tableau("bosh3"), cfg, params,
                      torch.zeros(4, dtype=torch.float64),
                      EngineConfig(buckets=(2,)))
    x0 = torch.randn(4, generator=g, dtype=torch.float64)
    req = Request(x0=x0, t0=0.0, t1=0.5, rtol=1e-4, atol=1e-6)
    (r_ck,) = eng.run([req]).values()
    (r_ref,) = ref.run([req]).values()
    assert r_ck.succeeded and r_ref.succeeded
    assert torch.equal(r_ck.x_final, r_ref.x_final)
    assert r_ck.n_fevals == r_ref.n_fevals


def test_params_from_checkpoint_rejects_wrong_contract(tmp_path):
    state = TrainState(params={"w": torch.ones(2, 2)}, opt={},
                       rng=torch.Generator().get_state(),
                       data_step=torch.tensor(0, dtype=torch.int32),
                       solver_stats=init_solver_stats())
    Checkpointer(str(tmp_path)).save(1, state)
    got, step = params_from_checkpoint(str(tmp_path), state)
    assert step == 1 and torch.equal(got["w"], state.params["w"])
    wrong = state.replace(params={"w": torch.ones(2, 2),
                                  "extra": torch.ones(3)})
    with pytest.raises(ValueError, match="shape-contract mismatch"):
        params_from_checkpoint(str(tmp_path), wrong)


def test_lm_serve_boots_from_training_checkpoint(tmp_path):
    """End to end: ``launch.train --grad-mode symplectic`` checkpoints,
    ``launch.serve lm --ckpt-dir`` restores it, and its prefill logits
    equal those of the trained params."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.configs.base import NodeConfig
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.launch import serve, train
    from repro_torch.models.lm import lm_forward
    ckpt = tmp_path / "ckpt"
    out = train.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "2",
                      "--global-batch", "2", "--seq-len", "16",
                      "--grad-mode", "symplectic", "--ckpt-dir", str(ckpt),
                      "--ckpt-every", "2", "--device", "cpu"])
    got = serve.main(["lm", "--arch", "qwen3-0.6b", "--smoke",
                      "--grad-mode", "symplectic", "--ckpt-dir", str(ckpt),
                      "--batch", "2", "--prompt-len", "8", "--gen-len", "4",
                      "--device", "cpu"])
    arch = get_smoke_arch("qwen3-0.6b").with_(node=NodeConfig(
        mode="node", grad_mode="symplectic"))
    toks = torch.as_tensor(synthetic_lm_batch(0, 2, 9, arch.vocab)["tokens"],
                           dtype=torch.long)
    with torch.no_grad():
        want = lm_forward(out["state"].params, arch.with_(
            node=NodeConfig()), toks)["logits"][:, -1:]
    torch.testing.assert_close(got["prefill_logits"], want, rtol=1e-5,
                               atol=1e-5)
    assert got["tokens"].shape == (2, 4)
