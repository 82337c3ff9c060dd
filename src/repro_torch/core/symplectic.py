"""The symplectic adjoint method (the paper's contribution).

Forward (Algorithm 1): integrate with any explicit Runge-Kutta tableau
under ``no_grad``, retaining ONLY the step checkpoints {x_n, t_n, h_n} — no
stage computation graph survives the forward pass.

Backward (Algorithm 2 + Eq. (7)/(8)): for each step n = N-1..0,
  1. recompute the stage states X_{n,i} from the checkpoint x_n without a
     graph (lines 3-7),
  2. run the symplectic-partner stage recursion i = s..1 (lines 8-13):

        Lambda_{n,i} = lambda_{n+1} - h * sum_{j>i} btilde_j (a_{j,i}/b_i) l_j   (i not in I0)
        Lambda_{n,i} = - sum_{j>i} btilde_j a_{j,i} l_j                          (i in I0)
        l_{n,i}      = -(df/dx(X_{n,i}))^T Lambda_{n,i}
        btilde_i     = b_i  (i not in I0),   h_n  (i in I0 = {i: b_i = 0})

     each l_{n,i} is ONE ``torch.autograd.grad`` through ONE network
     evaluation on detached copies of (X_{n,i}, params), and
  3. lambda_n = lambda_{n+1} - h * sum_i btilde_i l_{n,i};
     grad_theta += h * sum_i btilde_i (df/dtheta(X_{n,i}))^T Lambda_{n,i}.

Because the partitioned pair (forward RK, Eq. (7)) is symplectic, the bilinear
invariant lambda^T delta is conserved exactly in discrete time (Theorem 2), so
lambda_0 equals the EXACT gradient of the discrete forward map — verified
against autograd through the solver to rounding error in the tests.

Memory: each stage's graph is built inside its own ``autograd.grad`` call
and freed when the call returns, so one stage graph is live at a time and
live memory is O(N + s + L), not O(N * s * L).

The adjoint slopes l_{n,i} live in a stacked buffer, and both the Lambda
recursion and the lambda_n update are row combines through the
StageCombiner (core/combine.py) — the same fused primitive the forward
solve uses, with the h-dependent Eq. (7)/(8) rows computed on the device.

The drivers are ``torch.autograd.Function``s whose inputs are the
flattened leaves of (x0, params); times are not differentiated.

Lane-batched solves (``odeint_symplectic_adaptive_batched``): every lane
realizes its own accepted grid, so the backward walks the shared
(max_steps + 1, B) checkpoint rows once, runs one lane-batched Algorithm 2
step per row (stages recomputed for all lanes at once, one VJP over all
lanes per stage through ``torch.func``) and masks each lane by its own
n_accepted: a lane carries its lambda unchanged through the rows past its
count and adds nothing to the parameter gradient there.  Theorem 2 then
holds per lane, so the batched gradient equals the sum of the single-lane
gradients to rounding.

SaveAt (``odeint_symplectic_saveat*``): the solve is split into segments
at the observation times, so every observation is a segment endpoint and
no interpolation enters the differentiated map.  The backward walks the
segments in reverse: at each boundary the cotangent of that observation is
added to lambda, then Algorithm 2 runs over the segment's checkpoints, and
the parameter gradient accumulates in one buffer across all segments.
Theorem 2 holds per segment, so the gradient of any loss over the
observations is exact to rounding.  The residuals are the per-segment
checkpoints and the params.  A t1 solve runs the same drivers over the one
segment [t0, t1].
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from .combine import StageCombiner, alloc_stages, get_combiner, set_stage
from .rk import (AdaptiveConfig, VectorField, counters, lane_bcast,
                 rk_solve_adaptive_batched_saveat_stacked,
                 rk_solve_adaptive_saveat_stacked, rk_solve_fixed, rk_stages,
                 segment_starts, segment_stats, tree_stack)
from .stepper import as_time, lane_field, time_dtype
from .tableau import ButcherTableau

Pytree = Any


def _add(a, b):
    """a + b, where None stands for an exact zero (a parameter leaf that no
    stage used): None + g is g itself, no copy."""
    if a is None:
        return b
    return a if b is None else a + b


def _tree_add(a, b):
    return pytree.tree_map(_add, a, b)


def _scaled(w, tree, in_place: bool = False):
    """w * each tensor leaf of ``tree`` (a tensor w cast to the leaf's
    dtype); None leaves stay None.  ``in_place`` writes the products into
    the leaves (only for tensors this module made)."""
    def leaf(g):
        if g is None:
            return None
        wg = w.to(g.dtype) if isinstance(w, torch.Tensor) else w
        return g.mul_(wg) if in_place else wg * g
    return pytree.tree_map(leaf, tree)


def _accumulate(acc, tree):
    """acc + tree, written into ``acc``'s leaves: ``acc`` holds only
    tensors this module made (never a caller's or autograd's), None for an
    exact zero.  The sums round as ``_tree_add``'s."""
    def leaf(a, g):
        if a is None:
            return g
        return a if g is None else a.add_(g)
    return pytree.tree_map(leaf, acc, tree)


def _dense(gtheta: Pytree, params: Pytree) -> Pytree:
    """``gtheta`` with each None leaf (and a None tree) made a zero tensor
    like its parameter: the zeros that no stage needed, made once."""
    if gtheta is None:
        return pytree.tree_map(torch.zeros_like, params)
    return pytree.tree_map(
        lambda p, g: torch.zeros_like(p) if g is None else g, params, gtheta)


def _stage_vjp(f: VectorField, X: Pytree, t, params: Pytree,
               cot: Pytree):
    """(d f(X, t, params) / d(X, params))^T cot, from one graph that is
    built and freed inside this call.  Returns (xbar, thbar) pytrees;
    thbar holds None for each parameter leaf the evaluation did not use."""
    return _value_and_vjp(f, X, t, params, cot, dense=False)[1:]


def _value_and_vjp(f: VectorField, X: Pytree, t, params: Pytree,
                   cot: Pytree, dense: bool = True):
    """``_stage_vjp`` that also returns f(X, t, params), as evaluated on
    the detached copies (it holds their graph): (f, xbar, thbar).  xbar is
    dense; so is thbar unless ``dense`` is False (then an unused parameter
    leaf's entry is None, and no zero tensor is made for it)."""
    x_leaves, x_spec = pytree.tree_flatten(X)
    p_leaves, p_spec = pytree.tree_flatten(params)
    with torch.enable_grad():
        xd = [l.detach().requires_grad_() for l in x_leaves]
        pd = [l.detach().requires_grad_() for l in p_leaves]
        out = f(pytree.tree_unflatten(xd, x_spec), t,
                pytree.tree_unflatten(pd, p_spec))
        pairs = [(o, c) for o, c in zip(pytree.tree_leaves(out),
                                        pytree.tree_leaves(cot))
                 if o.requires_grad]
        inputs = xd + pd
        grads = torch.autograd.grad(
            [o for o, _ in pairs], inputs, [c for _, c in pairs],
            allow_unused=True) if pairs else [None] * len(inputs)
    fill = len(inputs) if dense else len(xd)    # xbar is always dense
    grads = [torch.zeros_like(i) if g is None and k < fill else g
             for k, (g, i) in enumerate(zip(grads, inputs))]
    return (out, pytree.tree_unflatten(grads[:len(xd)], x_spec),
            pytree.tree_unflatten(grads[len(xd):], p_spec))


def _step_adjoint(f: VectorField, tab: ButcherTableau, x_n, t_n, h, params,
                  lam_next, combiner: StageCombiner):
    """One backward step of Algorithm 2: (lambda_n, grad_theta_step), the
    latter None for each parameter leaf that no stage of the step used (a
    field that runs one of many units per evaluation touches only that
    unit's leaves)."""
    s = tab.s
    b, c = tab.b, tab.c
    # --- Alg.2 lines 3-7: recompute stages from the checkpoint ----------
    Xs, _K = rk_stages(f, tab, x_n, t_n, h, params, combiner,
                       last_slope=False)
    del _K
    L = alloc_stages(s, lam_next)   # stacked adjoint slopes l_{n,i}
    gtheta = None
    for i in reversed(range(s)):
        # --- Eq. (7): Lambda_{n,i} from the slope-buffer suffix L[i+1:] --
        Lam_i = combiner.lambda_stage(lam_next, L, h, i)
        # --- Alg.2 lines 10-12: one VJP of one network evaluation -------
        xbar, thbar = _stage_vjp(f, Xs[i], t_n + c[i] * h, params, Lam_i)
        set_stage(L, i, pytree.tree_map(torch.neg, xbar))
        # Eq. (8): h_n replaces vanishing weights.
        contrib = _scaled(h if b[i] == 0.0 else b[i], thbar)
        del xbar, thbar
        # one parameter-sized sum per step, written in place (the memory
        # audit's Table-1 margin holds with one-stage methods too)
        gtheta = contrib if gtheta is None else _accumulate(gtheta, contrib)
        del contrib
    # --- lambda_n = lambda_{n+1} - h sum_i btilde_i l_{n,i} --------------
    lam_n = combiner.lambda_update(lam_next, L, h)
    # grad_theta step contribution: + h sum_i btilde_i (df/dtheta)^T Lambda_i
    return lam_n, _scaled(h, gtheta, in_place=True)


@torch.no_grad()
def symplectic_step_adjoint(f: VectorField, tab: ButcherTableau,
                            x_n, t_n, h, params, lam_next,
                            combiner: Optional[StageCombiner] = None):
    """One backward step of Algorithm 2. Returns (lambda_n, grad_theta_step),
    the latter a dense tree like ``params``."""
    lam_n, gtheta = _step_adjoint(f, tab, x_n, t_n, h, params, lam_next,
                                  combiner or get_combiner(tab))
    return lam_n, _dense(gtheta, params)


def _stage_vjp_lanes(lane_f: VectorField, X: Pytree, t: torch.Tensor,
                     params: Pytree, cot: Pytree, cot_theta: Pytree):
    """One stage's VJP over all lanes, from one graph built and freed inside
    this call: f is evaluated once over the lanes (``lane_f``), and its
    backward runs twice — with ``cot`` for the per-lane state part xbar,
    and with ``cot_theta`` for the parameter part, which comes out summed
    over the lanes (never B copies of the parameters).  Returns (xbar,
    thbar)."""
    _, vjp_fn = torch.func.vjp(lambda X_, th: lane_f(X_, t, th), X, params)
    xbar, _ = vjp_fn(cot)
    _, thbar = vjp_fn(cot_theta)
    return xbar, thbar


@torch.no_grad()
def symplectic_step_adjoint_lanes(f: VectorField, tab: ButcherTableau,
                                  x_n, t_n, h_n, params, lam_next, valid,
                                  combiner: Optional[StageCombiner] = None):
    """One backward step of Algorithm 2 for all lanes at once.

    ``x_n``/``lam_next`` are lane-batched (lane axis 0), ``t_n``/``h_n``/
    ``valid`` are (B,); ``valid[b]`` says whether this row is one of lane
    b's accepted steps, and at least one lane must be valid.  The stages
    are recomputed with f once per stage over all lanes, the Eq. (7)/(8)
    rows are per lane, and one stage's VJP graph is live at a time.

    Returns (lambda_n, grad_theta_step): lambda_n for every lane (only the
    valid lanes' are meaningful) and grad_theta_step summed over the valid
    lanes.  The JAX package returns the per-lane parameter gradients,
    (B,) + param shape, and masks them with a ``where`` before the sum;
    here the mask goes in before the VJP, which keeps B copies of the
    parameters out of memory: an invalid lane's checkpoint, time and step
    are replaced by those of a valid lane (finite by construction: the
    forward accepted that step) and its parameter cotangent by an exact
    zero, so a poisoned lane contributes 0, never 0 * NaN."""
    combiner = combiner or get_combiner(tab)
    s = tab.s
    b, c = tab.b, tab.c
    lane_f = lane_field(f)
    ref = torch.argmax(valid.to(torch.int32)).reshape(1)   # a valid lane

    def safe(l):            # a gather on the device: no host read
        return torch.where(lane_bcast(valid, l), l, l.index_select(0, ref))

    x_n = pytree.tree_map(safe, x_n)
    t_n, h_n = safe(t_n), safe(h_n)
    Xs, _K = rk_stages(lane_f, tab, x_n, t_n, h_n, params, combiner,
                       last_slope=False)
    del _K
    L = alloc_stages(s, lam_next)
    gtheta = None
    for i in reversed(range(s)):
        Lam_i = combiner.lambda_stage(lam_next, L, h_n, i)
        # the parameter weight of stage i, per lane: h_n btilde_i, with
        # btilde_i = b_i, or h_n where b_i = 0 (Eq. 8)
        w = h_n * (h_n if b[i] == 0.0 else b[i])
        cot_theta = pytree.tree_map(
            lambda l: torch.where(lane_bcast(valid, l),
                                  lane_bcast(w, l).to(l.dtype) * l,
                                  torch.zeros((), dtype=l.dtype,
                                              device=l.device)), Lam_i)
        xbar, thbar = _stage_vjp_lanes(lane_f, Xs[i], t_n + c[i] * h_n,
                                       params, Lam_i, cot_theta)
        Xs[i] = None                  # the stage state is not needed again
        set_stage(L, i, pytree.tree_map(torch.neg, xbar))
        gtheta = thbar if gtheta is None else _tree_add(gtheta, thbar)
    lam_n = combiner.lambda_update(lam_next, L, h_n)
    return lam_n, gtheta


@torch.no_grad()
def _masked_lanes_alg2_scan(f, tab, combiner, params, xs, ts, hs, n_acc,
                            lam, gtheta):
    """Reverse Algorithm 2 sweep over (max_steps + 1, B) checkpoint rows.

    ``n_acc`` is (B,); row n is valid for the lanes with n < n_acc[b].
    Rows at or past a lane's count leave that lane's lambda unchanged (a
    ``where``) and add nothing to the parameter gradient.  The sweep starts
    at max(n_acc) - 1 (one host read): every row it visits is valid for at
    least one lane.  ``gtheta`` is None while no step has contributed."""
    for n in reversed(range(int(n_acc.max()))):
        valid = n < n_acc
        x_n = pytree.tree_map(lambda buf: buf[n], xs)
        lam2, gstep = symplectic_step_adjoint_lanes(
            f, tab, x_n, ts[n], hs[n], params, lam, valid, combiner)
        lam = pytree.tree_map(
            lambda a, b: torch.where(lane_bcast(valid, a), b, a), lam, lam2)
        gtheta = gstep if gtheta is None else _tree_add(gtheta, gstep)
    return lam, gtheta


@torch.no_grad()
def _algorithm2(f, tab, combiner, xs, ts, hs, params, lam, gtheta=None):
    """Reverse sweep over the checkpoints; returns (lambda_0, grad_theta),
    grad_theta added to ``gtheta`` when given (None while no step has
    contributed; a None leaf while no step has used that leaf)."""
    for n in reversed(range(len(xs))):
        lam, gstep = _step_adjoint(f, tab, xs[n], ts[n], hs[n], params, lam,
                                   combiner)
        gtheta = gstep if gtheta is None else _accumulate(gtheta, gstep)
        del gstep
    return lam, gtheta


class _Problem:
    """The static half of one symplectic solve: the field, tableau,
    stepping and backend, the times, and the pytree structure of (x0,
    params).  After the forward it also carries the controller's counters
    (``stats``, ``succeeded``), so value and stats come from one run."""

    def __init__(self, f, tab, stepping, backend, t0, t1, x_spec, n_x,
                 p_spec, at_t1=False):
        self.f, self.tab, self.stepping = f, tab, stepping
        self.backend, self.t0, self.t1 = backend, t0, t1
        self.x_spec, self.n_x, self.p_spec = x_spec, n_x, p_spec
        # a SaveAt Function over ts = [t1]: its one observation unstacked
        self.at_t1 = at_t1
        self.stats = None
        self.succeeded = True

    def split(self, leaves):
        x0 = pytree.tree_unflatten(list(leaves[:self.n_x]), self.x_spec)
        params = pytree.tree_unflatten(list(leaves[self.n_x:]), self.p_spec)
        return x0, params


def _cotangents(grads, meta, spec):
    """The output cotangents as a pytree: a zero tensor where autograd
    passed None (an output the loss does not use)."""
    return pytree.tree_unflatten(
        [torch.zeros(s, dtype=d, device=v) if g is None else g
         for g, (s, d, v) in zip(grads, meta)], spec)


def _saveat_outputs(ctx, prob, obs, last, leaves):
    """The forward's tail: save the params and return the output leaves —
    the stacked observations, or a t1 solve's one observation ``last`` as
    the solver returned it (so no select node, and no copy of its
    cotangent, follows the Function)."""
    ctx.prob = prob
    ctx.save_for_backward(*leaves[prob.n_x:])
    out = pytree.tree_leaves(last if prob.at_t1 else obs)
    ctx.out_meta = [(o.shape, o.dtype, o.device) for o in out]
    return tuple(out)


def _saveat_backward(ctx, grads, sweep):
    """The segmented Algorithm 2: walk the segments in reverse, add the
    cotangent of the observation at each segment's end to lambda, then run
    ``sweep`` (one segment's reverse sweep) over its checkpoints; theta's
    gradient accumulates in one buffer across the segments."""
    prob = ctx.prob
    params = pytree.tree_unflatten(list(ctx.saved_tensors), prob.p_spec)
    obs_bar = _cotangents(grads, ctx.out_meta, prob.x_spec)
    if prob.at_t1:
        obs_bar = pytree.tree_map(lambda g: g[None], obs_bar)
    combiner = get_combiner(prob.tab, prob.backend)
    # no zero buffers: lambda starts as the last cotangent and theta's
    # gradient as the first step's contribution
    lam, gtheta = None, None
    for i in reversed(range(len(ctx.segs))):
        ob = pytree.tree_map(lambda g: g[i], obs_bar)
        lam = ob if lam is None else _tree_add(lam, ob)
        lam, gtheta = sweep(prob, combiner, params, ctx.segs[i], lam, gtheta)
    # zeros, once, for the leaves no step used (all, if every segment had
    # zero length)
    gtheta = _dense(gtheta, params)
    return (None, *pytree.tree_leaves(lam), *pytree.tree_leaves(gtheta))


class _SymplecticSaveAt(torch.autograd.Function):
    """The observations at ``prob.t1`` = ts (stacked, leading axis len(ts))
    of a fixed (n_steps per segment) or adaptive (the controller threaded
    across the segments) solve, with the segmented Algorithm 2 backward.
    The residuals are each segment's checkpoints and the params.  A t1
    solve is the one segment ts = [t1]."""

    @staticmethod
    def forward(ctx, prob: _Problem, *leaves):
        x0, params = prob.split(leaves)
        ts = prob.t1
        if isinstance(prob.stepping, AdaptiveConfig):
            obs, sols = rk_solve_adaptive_saveat_stacked(
                prob.f, prob.tab, x0, prob.t0, ts, params, prob.stepping,
                prob.backend)
            ctx.segs = [(s.xs, s.ts, s.hs) for s in sols]
            prob.stats, prob.succeeded = segment_stats(map(counters, sols))
            x = sols[-1].x_final
        else:
            x, ctx.segs, out = x0, [], []
            for a, b in zip(segment_starts(prob.t0, ts), ts):
                sol = rk_solve_fixed(prob.f, prob.tab, x, a, b,
                                     prob.stepping, params, prob.backend)
                ctx.segs.append((sol.xs, sol.ts, [sol.h] * len(sol.xs)))
                x = sol.x_final
                out.append(x)
            obs = tree_stack(out)
        return _saveat_outputs(ctx, prob, obs, x, leaves)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return _saveat_backward(
            ctx, grads, lambda prob, combiner, params, seg, lam, g:
            _algorithm2(prob.f, prob.tab, combiner, *seg, params, lam, g))


class _SymplecticSaveAtLanes(torch.autograd.Function):
    """The observations at the shared times ``prob.t1`` = ts (leading axis
    len(ts), then the lanes) of a lane-batched adaptive solve, each lane's
    controller threaded across the segments, with the segmented masked
    per-lane Algorithm 2 backward.  The residuals are each segment's
    checkpoint rows (only those its lanes accepted), ts, hs and
    n_accepted, and the params.  A t1 solve is the one segment ts = [t1]."""

    @staticmethod
    def forward(ctx, prob: _Problem, *leaves):
        x0, params = prob.split(leaves)
        obs, sols = rk_solve_adaptive_batched_saveat_stacked(
            prob.f, prob.tab, x0, prob.t0, prob.t1, params, prob.stepping,
            prob.backend)
        prob.stats, prob.succeeded = segment_stats(map(counters, sols))
        ctx.segs = [(s.xs, s.ts, s.hs, s.n_accepted) for s in sols]
        return _saveat_outputs(ctx, prob, obs, sols[-1].x_final, leaves)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return _saveat_backward(
            ctx, grads, lambda prob, combiner, params, seg, lam, g:
            _masked_lanes_alg2_scan(prob.f, prob.tab, combiner, params,
                                    *seg, lam, g))


def _solve(f, tab, stepping, backend, x0, t0, ts, params, fn):
    """Observations at ``ts`` (1-D, or a scalar t1: the one observation is
    then returned unstacked) and the problem, which carries the stats."""
    x_leaves, x_spec = pytree.tree_flatten(x0)
    p_leaves, p_spec = pytree.tree_flatten(params)
    at_t1 = not (isinstance(ts, torch.Tensor) and ts.dim() == 1)
    if at_t1:
        ts = as_time(ts, time_dtype(x0), x_leaves[0].device).reshape(1)
    prob = _Problem(f, tab, stepping, backend, t0, ts, x_spec,
                    len(x_leaves), p_spec, at_t1)
    out = fn.apply(prob, *x_leaves, *p_leaves)
    return pytree.tree_unflatten(list(out), x_spec), prob


def odeint_symplectic(f: VectorField, tab: ButcherTableau, n_steps: int,
                      combine_backend: str, x0, t0, t1, params):
    """x(t1) on N equal steps; gradient by Algorithm 2."""
    return _solve(f, tab, n_steps, combine_backend, x0, t0, t1, params,
                  _SymplecticSaveAt)[0]


def odeint_symplectic_adaptive(f: VectorField, tab: ButcherTableau,
                               cfg: AdaptiveConfig, combine_backend: str,
                               x0, t0, t1, params):
    """x(t1) of an adaptive solve; gradient by Algorithm 2 replaying the
    accepted grid.  Returns (x_final, stats, succeeded): the controller's
    counters of the same run."""
    x, prob = _solve(f, tab, cfg, combine_backend, x0, t0, t1, params,
                     _SymplecticSaveAt)
    return x, prob.stats, prob.succeeded


def odeint_symplectic_adaptive_batched(f: VectorField, tab: ButcherTableau,
                                       cfg: AdaptiveConfig,
                                       combine_backend: str, x0, t0, t1,
                                       params):
    """x(t1) of a lane-batched adaptive solve (lane axis 0); gradient by
    Algorithm 2 replaying each lane's own accepted grid.  Returns (x_final,
    stats, succeeded) with per-lane (B,) stats and success on the device."""
    x, prob = _solve(f, tab, cfg, combine_backend, x0, t0, t1, params,
                     _SymplecticSaveAtLanes)
    return x, prob.stats, prob.succeeded


def odeint_symplectic_saveat(f: VectorField, tab: ButcherTableau,
                             n_steps: int, combine_backend: str, x0, t0, ts,
                             params):
    """The solution at the times ``ts`` (stacked, leading axis len(ts)) on
    a fixed grid of ``n_steps`` per segment; gradient by the segmented
    Algorithm 2."""
    return _solve(f, tab, n_steps, combine_backend, x0, t0, ts, params,
                  _SymplecticSaveAt)[0]


def odeint_symplectic_saveat_adaptive(f: VectorField, tab: ButcherTableau,
                                      cfg: AdaptiveConfig,
                                      combine_backend: str, x0, t0, ts,
                                      params):
    """The solution at ``ts`` of an adaptive solve, one segment per
    interval with the controller's unclamped step threaded across the
    boundaries; gradient by the segmented Algorithm 2 replaying each
    segment's accepted grid.  Returns (obs, stats, succeeded): the
    counters summed over the segments of the same run, and whether every
    segment succeeded."""
    obs, prob = _solve(f, tab, cfg, combine_backend, x0, t0, ts, params,
                       _SymplecticSaveAt)
    return obs, prob.stats, prob.succeeded


def odeint_symplectic_saveat_adaptive_batched(f: VectorField,
                                              tab: ButcherTableau,
                                              cfg: AdaptiveConfig,
                                              combine_backend: str, x0, t0,
                                              ts, params):
    """The lane-batched ``odeint_symplectic_saveat_adaptive`` (lane axis
    0): each lane threads its own controller across the shared observation
    times, and the backward replays each lane's own grid per segment.
    Returns (obs, stats, succeeded) with per-lane (B,) stats and success
    on the device."""
    obs, prob = _solve(f, tab, cfg, combine_backend, x0, t0, ts, params,
                       _SymplecticSaveAtLanes)
    return obs, prob.stats, prob.succeeded
