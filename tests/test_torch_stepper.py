"""PyTorch port: the explicit solver state machine against the JAX package.

The port's counterparts of ``tests/test_stepper.py``, float64 on the CPU,
on its problem (dopri5, a 3-dim tanh field with a time term, B = 4 lanes
of heterogeneous horizons):

* PAUSE/RESUME — a solve driven one ``advance`` at a time, with every
  state tensor sent through host numpy and back mid-solve, reproduces the
  uninterrupted solve bit for bit (single adaptive, lane-batched, its
  in-place form, fixed), and so do the symplectic gradients replayed from
  the resumed checkpoints (``_algorithm2``, ``_masked_lanes_alg2_scan``).
  Torch eager runs the same kernels on both sides, so the port is held
  bitwise against itself; the three JAX pause/resume tests that compare
  two XLA executables bitwise are no parity target.
* TOLERANCES AS DATA — rtol/atol in the state (0-dim, or one per lane)
  take the same steps, bit for bit, as the config's Python floats.
* ``advance`` past done is the identity.
* Against JAX's stepper: integer stats exact, floats within 1e-10
  (cross-library step sizes agree to ~1e-11, ROADMAP queue 3).  The grids
  are compared from initial_step 0.3: from 0.05 the first step's error
  estimate (~4e-12) sits at the rounding level of its 0.05-sized terms, so
  the libraries' roundings move the next step size by ~2e-9 relative (the
  final states still agree to 3e-16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

jax.config.update("jax_enable_x64", True)

from repro.core import AdaptiveConfig as JConfig
from repro.core.rk import rk_solve_adaptive as j_solve_adaptive
from repro.core.rk import rk_solve_adaptive_batched as j_solve_batched
from repro.core.stepper import AdaptiveStepper as JStepper
from repro.core.symplectic import (odeint_symplectic,
                                   odeint_symplectic_adaptive,
                                   odeint_symplectic_adaptive_batched)
from repro.core.tableau import get_tableau as jget
from repro_torch.core import (AdaptiveConfig, AdaptiveStepper, FixedStepper,
                              get_combiner, get_tableau,
                              rk_solve_adaptive_batched)
from repro_torch.core.symplectic import _algorithm2, _masked_lanes_alg2_scan

TAB, JTAB = get_tableau("dopri5"), jget("dopri5")
CFG = AdaptiveConfig(rtol=1e-6, atol=1e-8, max_steps=64, initial_step=0.05)
JCFG = JConfig(rtol=1e-6, atol=1e-8, max_steps=64, initial_step=0.05)
T0, T1 = 0.0, 1.0
DIM, B, N_STEPS = 3, 4, 8
PAUSE = 2
RTOL, ATOL = 1e-10, 1e-12           # against JAX, float64
PARITY = dict(initial_step=0.3)     # the grids' comparison with JAX

JPARAMS = {"w": jax.random.normal(jax.random.PRNGKey(0), (DIM, DIM)) * 0.5,
           "b": jax.random.normal(jax.random.PRNGKey(1), (DIM,)) * 0.1}
X0_NP = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (DIM,)))
X0_LANES_NP = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (B, DIM)))
T1_LANES_NP = np.linspace(0.6, 1.4, B)
PARAMS = {k: torch.tensor(np.asarray(v)) for k, v in JPARAMS.items()}
# one (rtol, atol) pair per lane, for tolerances as data
LANE_TOLS = ((1e-6, 1e-8), (1e-4, 1e-6), (1e-6, 1e-8), (1e-5, 1e-7))


def jfield(x, t, p):
    return jnp.tanh(x @ p["w"] + p["b"]) - 0.3 * x * jnp.sin(t)


def field(x, t, p):
    return torch.tanh(x @ p["w"] + p["b"]) - 0.3 * x * torch.sin(t)


def loss_grad(x):
    """d/dx sum(sin(x)^2)."""
    return 2.0 * torch.sin(x) * torch.cos(x)


def jloss(x):
    return jnp.sum(jnp.sin(x) ** 2)


def x0():
    return torch.tensor(X0_NP)


def x0_lanes():
    return torch.tensor(X0_LANES_NP)


def t1_lanes():
    return torch.tensor(T1_LANES_NP)


def leaves(state):
    return pytree.tree_leaves(state)


def assert_bits_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), (x, y)
        else:
            assert x == y


def assert_close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=name)


def save_restore(state):
    """A simulated checkpoint: every tensor of the state to host numpy (as a
    serializer would write it) and back into a fresh tensor."""
    return pytree.tree_map(
        lambda l: torch.from_numpy(l.numpy().copy())
        if isinstance(l, torch.Tensor) else l, state)


def drive(stepper, state, pause_after=None):
    """``advance`` one attempt at a time, with a save/restore after
    ``pause_after`` attempts.  Returns (final state, attempts)."""
    n = 0
    while not stepper.is_done(state):
        state = stepper.advance(state, PARAMS)
        n += 1
        if n == pause_after:
            state = save_restore(state)
        assert n < 10_000
    return state, n


def drive_in_place(stepper, state, pause_after=None):
    """The serve engine's attempt (no host read inside) until no lane is
    live, with a save/restore after ``pause_after`` attempts."""
    n = 0
    while bool(state.live.any()):
        stepper.advance_in_place(state, PARAMS)
        n += 1
        if n == pause_after:
            state = save_restore(state)
        assert n < 10_000
    return state, n


# ---------------------------------------------------------------------------
# adaptive, single trajectory
# ---------------------------------------------------------------------------

def test_adaptive_pause_resume_bit_exact():
    stepper = AdaptiveStepper(field, TAB, CFG)
    full, n = drive(stepper, stepper.init_state(x0(), T0, T1))
    assert n > PAUSE + 1             # the pause lands mid-flight
    paused, _ = drive(stepper, stepper.init_state(x0(), T0, T1),
                      pause_after=PAUSE)
    assert_bits_equal(full, paused)
    sol = stepper.finalize(paused)
    assert sol.succeeded and sol.n_accepted > PAUSE


def test_adaptive_stepper_matches_jax():
    stepper = AdaptiveStepper(field, TAB, dataclasses.replace(CFG, **PARITY))
    state, _ = drive(stepper, stepper.init_state(x0(), T0, T1))
    sol = stepper.finalize(state)
    want = j_solve_adaptive(jfield, JTAB, jnp.asarray(X0_NP), T0, T1,
                            JPARAMS, dataclasses.replace(JCFG, **PARITY))
    n = int(want.n_accepted)
    assert (sol.n_accepted, sol.n_fevals, sol.n_attempts, sol.succeeded) \
        == (n, int(want.n_fevals), int(want.n_attempts),
            bool(want.succeeded))
    assert_close(sol.x_final, want.x_final, "x_final")
    assert_close(torch.stack(sol.xs), np.asarray(want.xs)[:n], "xs")
    assert_close(torch.stack(sol.ts), np.asarray(want.ts)[:n], "ts")
    assert_close(torch.stack(sol.hs), np.asarray(want.hs)[:n], "hs")
    assert_close(sol.h_final, want.h_final, "h_final")


def test_adaptive_pause_resume_gradients_bit_exact():
    stepper = AdaptiveStepper(field, TAB, CFG)
    combiner = get_combiner(TAB)

    def replay(state):
        sol = stepper.finalize(state)
        return _algorithm2(field, TAB, combiner, sol.xs, sol.ts, sol.hs,
                           PARAMS, loss_grad(sol.x_final))

    full, _ = drive(stepper, stepper.init_state(x0(), T0, T1))
    paused, _ = drive(stepper, stepper.init_state(x0(), T0, T1),
                      pause_after=PAUSE)
    g_paused = replay(paused)
    assert_bits_equal(replay(full), g_paused)
    want = jax.grad(lambda x, p: jloss(odeint_symplectic_adaptive(
        jfield, JTAB, JCFG, "auto", x, T0, T1, p)), argnums=(0, 1))(
            jnp.asarray(X0_NP), JPARAMS)
    assert_close(g_paused[0], want[0], "lambda_0")
    for k in PARAMS:
        assert_close(g_paused[1][k], want[1][k], k)


def test_tolerances_as_data_bit_match_closed_floats():
    stepper = AdaptiveStepper(field, TAB, CFG)
    closed, _ = drive(stepper, stepper.init_state(x0(), T0, T1))
    as_data, _ = drive(stepper, stepper.init_state(
        x0(), T0, T1, rtol=CFG.rtol, atol=CFG.atol))
    assert as_data.rtol.dim() == 0 and as_data.rtol.dtype == torch.float64
    assert_bits_equal(closed, as_data._replace(rtol=None, atol=None))


def test_advance_past_done_is_identity():
    stepper = AdaptiveStepper(field, TAB, CFG)
    state, _ = drive(stepper, stepper.init_state(x0(), T0, T1))
    assert stepper.is_done(state)
    assert_bits_equal(state, stepper.advance(state, PARAMS))
    lanes = stepper.run(stepper.init_state(x0_lanes(), T0, t1_lanes(),
                                           lanes=B), PARAMS)
    assert stepper.is_done(lanes)
    assert_bits_equal(lanes, stepper.advance(lanes, PARAMS))
    # the engine's attempt runs whatever the host flag says: on a finished
    # state it moves nothing but the scratch checkpoint row
    before = save_restore(lanes)
    stepper.advance_in_place(lanes, PARAMS)
    scratch = CFG.max_steps
    for name in ("xs", "ts", "hs"):
        assert torch.equal(getattr(lanes, name)[:scratch],
                           getattr(before, name)[:scratch])
    drop = dict(xs=None, ts=None, hs=None)
    assert_bits_equal(before._replace(**drop), lanes._replace(**drop))


# ---------------------------------------------------------------------------
# adaptive, lane-batched (the serve engine's path)
# ---------------------------------------------------------------------------

def test_batched_pause_resume_bit_exact():
    one_shot = rk_solve_adaptive_batched(field, TAB, x0_lanes(), T0,
                                         t1_lanes(), PARAMS, CFG)
    stepper = AdaptiveStepper(field, TAB, CFG)
    state, _ = drive(stepper, stepper.init_state(x0_lanes(), T0, t1_lanes(),
                                                 lanes=B), pause_after=PAUSE)
    resumed = stepper.finalize(state)
    assert_bits_equal(one_shot, resumed)
    assert bool(resumed.succeeded.all())
    # heterogeneous horizons: the pause caught lanes at different counts
    assert len(set(resumed.n_accepted.tolist())) > 1


def test_in_place_attempt_pause_resume_bit_exact():
    """The engine's in-place attempt takes the offline driver's steps bit
    for bit, through a save/restore, and keeps its tensors' storage."""
    one_shot = rk_solve_adaptive_batched(field, TAB, x0_lanes(), T0,
                                         t1_lanes(), PARAMS, CFG)
    stepper = AdaptiveStepper(field, TAB, CFG)
    state = stepper.init_state(x0_lanes(), T0, t1_lanes(), lanes=B)
    ptrs = [l.data_ptr() for l in leaves(state)
            if isinstance(l, torch.Tensor)]
    for _ in range(PAUSE):
        stepper.advance_in_place(state, PARAMS)
    assert ptrs == [l.data_ptr() for l in leaves(state)
                    if isinstance(l, torch.Tensor)]
    state, _ = drive_in_place(stepper, save_restore(state))
    assert_bits_equal(one_shot, stepper.finalize(state))


def test_batched_stepper_matches_jax():
    stepper = AdaptiveStepper(field, TAB, dataclasses.replace(CFG, **PARITY))
    sol = stepper.finalize(drive(stepper, stepper.init_state(
        x0_lanes(), T0, t1_lanes(), lanes=B))[0])
    want = j_solve_batched(jfield, JTAB, jnp.asarray(X0_LANES_NP), T0,
                           jnp.asarray(T1_LANES_NP), JPARAMS,
                           dataclasses.replace(JCFG, **PARITY))
    for name in ("n_accepted", "n_fevals", "n_attempts", "succeeded"):
        assert np.array_equal(getattr(sol, name).numpy(),
                              np.asarray(getattr(want, name))), name
    assert_close(sol.x_final, want.x_final, "x_final")
    assert_close(sol.h_final, want.h_final, "h_final")
    # the accepted grids, on the time axis: a landing step t1 - t is a
    # difference of O(1) times, so it agrees to 1e-10 absolute
    rows = np.arange(CFG.max_steps)[:, None] < np.asarray(want.n_accepted)
    for name in ("ts", "hs"):
        got = getattr(sol, name)[:CFG.max_steps].numpy()
        np.testing.assert_allclose(
            np.where(rows, got, 0.0),
            np.where(rows, np.asarray(getattr(want, name)), 0.0),
            rtol=0, atol=RTOL, err_msg=name)


def test_per_lane_tolerances_as_data():
    """One (rtol, atol) per lane: lane b takes, bit for bit, the steps of
    lane b of a lane-batched solve at lane b's tolerances as closed floats,
    and the stats of JAX's stepper with the same per-lane arrays."""
    rtol = torch.tensor([r for r, _ in LANE_TOLS], dtype=torch.float64)
    atol = torch.tensor([a for _, a in LANE_TOLS], dtype=torch.float64)
    stepper = AdaptiveStepper(field, TAB, CFG)
    state = stepper.init_state(x0_lanes(), T0, t1_lanes(), lanes=B,
                               rtol=rtol, atol=atol)
    assert state.rtol.shape == (B,)
    got = stepper.finalize(stepper.run(state, PARAMS))
    assert len(set(got.n_accepted.tolist())) > 1
    for tol in set(LANE_TOLS):
        closed = rk_solve_adaptive_batched(
            field, TAB, x0_lanes(), T0, t1_lanes(), PARAMS,
            dataclasses.replace(CFG, rtol=tol[0], atol=tol[1]))
        for b in (b for b, t in enumerate(LANE_TOLS) if t == tol):
            for name in ("x_final", "xs", "ts", "hs", "n_accepted",
                         "n_fevals", "n_attempts", "h_final"):
                g, w = getattr(got, name), getattr(closed, name)
                # the checkpoint rows, without the scratch row
                lane = (lambda v: v[:CFG.max_steps, b]) \
                    if name in ("xs", "ts", "hs") else (lambda v: v[b])
                assert torch.equal(lane(g), lane(w)), (name, b)
    jstep = JStepper(jfield, JTAB, JCFG)
    want = jstep.run(jstep.init_state(
        jnp.asarray(X0_LANES_NP), T0, jnp.asarray(T1_LANES_NP), lanes=B,
        rtol=jnp.asarray(rtol.numpy()), atol=jnp.asarray(atol.numpy())),
        JPARAMS)
    for name in ("n_accepted", "n_fevals", "n_attempts"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name
    assert_close(got.x_final, want.x, "x_final")


def test_batched_pause_resume_gradients_bit_exact():
    stepper = AdaptiveStepper(field, TAB, CFG)
    combiner = get_combiner(TAB)

    def replay(state):
        sol = stepper.finalize(state)
        return _masked_lanes_alg2_scan(
            field, TAB, combiner, PARAMS, sol.xs, sol.ts, sol.hs,
            sol.n_accepted, loss_grad(sol.x_final), None)

    init = lambda: stepper.init_state(x0_lanes(), T0, t1_lanes(), lanes=B)
    full, _ = drive(stepper, init())
    paused, _ = drive(stepper, init(), pause_after=PAUSE)
    g_paused = replay(paused)
    assert_bits_equal(replay(full), g_paused)
    want = jax.grad(lambda x, p: jloss(odeint_symplectic_adaptive_batched(
        jfield, JTAB, JCFG, "auto", x, T0, jnp.asarray(T1_LANES_NP), p)),
        argnums=(0, 1))(jnp.asarray(X0_LANES_NP), JPARAMS)
    assert_close(g_paused[0], want[0], "lambda_0")
    for k in PARAMS:
        assert_close(g_paused[1][k], want[1][k], k)


# ---------------------------------------------------------------------------
# fixed grid
# ---------------------------------------------------------------------------

def _fixed(pause_at=None):
    stepper = FixedStepper(field, TAB, N_STEPS)
    state = stepper.init_state(x0(), T0, T1)
    for n in range(N_STEPS):
        assert not stepper.is_done(state)
        state = stepper.advance(state, PARAMS)
        if n == pause_at:
            state = save_restore(state)
    assert stepper.is_done(state)
    return stepper.finalize(state)


def test_fixed_pause_resume_bit_exact():
    assert_bits_equal(_fixed(), _fixed(pause_at=N_STEPS // 2))


def test_fixed_pause_resume_gradients_bit_exact():
    combiner = get_combiner(TAB)

    def replay(sol):
        return _algorithm2(field, TAB, combiner, sol.xs, sol.ts,
                           [sol.h] * len(sol.xs), PARAMS,
                           loss_grad(sol.x_final))

    g_paused = replay(_fixed(pause_at=2))
    assert_bits_equal(replay(_fixed()), g_paused)
    want = jax.grad(lambda x, p: jloss(odeint_symplectic(
        jfield, JTAB, N_STEPS, "auto", x, T0, T1, p)), argnums=(0, 1))(
            jnp.asarray(X0_NP), JPARAMS)
    assert_close(g_paused[0], want[0], "lambda_0")
    for k in PARAMS:
        assert_close(g_paused[1][k], want[1][k], k)


@pytest.mark.parametrize("lanes", [None, B])
def test_tolerance_tensor_broadcasts_over_lane_axis(lanes):
    """A tolerance tensor scales each lane's error by that lane's value —
    also where the state's width equals the lane count, where broadcasting
    over the last axis would silently mix lanes and widths."""
    from repro_torch.core.stepper import _error_norm, _error_norm_lanes
    g = torch.Generator().manual_seed(0)
    n = lanes or 5
    err, x, xn = (torch.randn((n, n), generator=g, dtype=torch.float64)
                  for _ in range(3))
    if lanes is None:
        got = _error_norm(err, x, xn,
                          torch.tensor(1e-3, dtype=torch.float64),
                          torch.tensor(1e-5, dtype=torch.float64))
        assert torch.equal(got, _error_norm(err, x, xn, 1e-3, 1e-5))
        return
    rtol = torch.tensor([1e-3, 1e-4, 1e-5, 1e-6], dtype=torch.float64)
    atol = rtol * 1e-2
    got = _error_norm_lanes(err, x, xn, rtol, atol)
    for b in range(lanes):
        want = _error_norm_lanes(err, x, xn, float(rtol[b]), float(atol[b]))
        assert torch.equal(got[b], want[b]), b
