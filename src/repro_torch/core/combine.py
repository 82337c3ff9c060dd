"""Stacked stage buffers + the StageCombiner: ALL RK stage linear algebra.

The stage representation across the solver stack is a *stacked slope buffer*:
for a state pytree ``x`` the slopes k_1..k_s live as one buffer per leaf with
a leading stage dimension — leaf shape ``(s,) + x_leaf.shape``.  Every linear
combination the solvers need is a *row combine* against that buffer,

    out = base + h * sum_i coefs[i] * K[i],

which is memory-bound, so the question is how many passes over device
memory it costs: one read of (base, K) and one write of out when fused.

The StageCombiner routes five solver operations through that primitive:

  * forward stage states   X_i = x + h * sum_{j<i} a_ij k_j          (Eq. 5)
  * the step update        x_{n+1} = x + h * sum_i b_i k_i           (Eq. 5)
  * the embedded error     err = h * sum_i b_err_i k_i   (+ FSAL slope)
  * the backward recursion Lambda_i / lambda_n of Algorithm 2        (Eq. 7/8)
  * Hermite dense output   x(t_n + theta h) over [f_n, f_{n+1}, x_{n+1} - x_n]

and dispatches each leaf either to plain PyTorch ops (a stage-order
accumulation that skips statically-zero coefficients) or to the kernel path
(``kernels/ops.py``: the hand-written CUDA kernel for a CUDA tensor, its
plain version for a CPU tensor), selected by the ``backend`` knob:

  auto   — the kernel path for CUDA tensors, plain ops otherwise  [default]
  torch  — always plain PyTorch ops
  cuda   — always the kernel path (on a CPU tensor that path runs the
           kernel's plain version, so its structure is testable off-card)

Both accumulate in ``promote(state_dtype, float32)``: float32 for
low-precision states, float64 for float64 states — so float64
exact-gradient tests hold on either backend.

Coefficient rows are data on the device: a tableau row is moved to the
device once per (dtype, device) and cached; rows that depend on h (the
backward recursion's) are computed there from the device scalar h.  No
combine reads a value back to the host.

Lane form: with a step ``h`` of shape (B,) — one step size per lane of a
lane-batched state, whose leaves carry the lane axis first (stage buffers:
(s, B, ...)) — every row becomes one row per lane, (B, s) or (B, m, s),
built on the device in one op per call, and both kernels take them in one
launch for all lanes.  This is what the JAX package gets by ``vmap``-ing
its combines over a per-lane h; here the combines are called on the
lane-batched leaves directly (an ``autograd.Function`` has no vmap rule).

For the backward recursion the h-dependence of the paper's Eq. (7)/(8)
coefficients (btilde_j = b_j, or h_n for the I0 = {i : b_i = 0} stages) is
factored into three h-independent numpy matrices R/P/Q precomputed per
tableau, so the per-stage coefficient row is just R[i] + h P[i] + h^2 Q[i].
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import ops
from repro_torch.kernels.ref import acc_dtype, lane_bcast
from .tableau import HERMITE_DENSE_W, ButcherTableau

Pytree = Any

COMBINE_BACKENDS = ("auto", "torch", "cuda")

__all__ = ["COMBINE_BACKENDS", "StageCombiner", "get_combiner",
           "alloc_stages", "set_stage", "stage_prefix", "stage_suffix",
           "append_stage", "resolve_backend"]


def resolve_backend(backend: str, device: torch.device = None) -> str:
    """Validate ``backend``; resolve ``auto`` by the tensors' device."""
    if backend not in COMBINE_BACKENDS:
        raise ValueError(
            f"combine_backend {backend!r} not in {COMBINE_BACKENDS}")
    if backend == "auto":
        return "cuda" if device is not None and device.type == "cuda" \
            else "torch"
    return backend


# ---------------------------------------------------------------------------
# Stacked slope buffers
# ---------------------------------------------------------------------------

def alloc_stages(s: int, x: Pytree) -> Pytree:
    """Slope buffer: each leaf gets shape (s,) + leaf.shape.  Left
    uninitialized: every solver reads only rows it has already written."""
    return pytree.tree_map(
        lambda l: torch.empty((s,) + tuple(l.shape), dtype=l.dtype,
                              device=l.device), x)


def set_stage(K: Pytree, i: int, k: Pytree) -> Pytree:
    """Write slope k into row i of the stacked buffer, in place.

    Each row is written once per buffer, so autograd (DirectBackprop)
    records one copy per row, and no combine saves the buffer for its
    backward unless its coefficients need a gradient.  Returns K."""
    for buf, l in zip(pytree.tree_leaves(K), pytree.tree_leaves(k)):
        buf[i].copy_(l)
    return K


def stage_prefix(K: Pytree, i: int) -> Pytree:
    """Rows [0, i) of the stacked buffer (a contiguous view)."""
    return pytree.tree_map(lambda buf: buf[:i], K)


def stage_suffix(K: Pytree, i: int) -> Pytree:
    """Rows [i, s) of the stacked buffer (a contiguous view)."""
    return pytree.tree_map(lambda buf: buf[i:], K)


def append_stage(K: Pytree, k: Pytree) -> Pytree:
    """Concatenate one extra slope row (the FSAL error stage)."""
    return pytree.tree_map(
        lambda buf, l: torch.cat([buf, l.to(buf.dtype)[None]], dim=0), K, k)


# ---------------------------------------------------------------------------
# Kernel-path leaf combines, made differentiable so DirectBackprop can
# differentiate THROUGH the kernel calls.  The backward is plain ops:
# dbase = dout, dK[i] = hc[i] dout.  The dhc term — the only one that needs
# the stage buffer K — is computed (and K saved) only when the coefficients
# require a gradient, which no solver use does: K never outlives the call.
# With one row per lane (hc (B, s) / (B, m, s)) each lane's slice of dout
# takes its own row.
# ---------------------------------------------------------------------------

def _lane_view(t: torch.Tensor, lead: int, lanes: int) -> torch.Tensor:
    """``t`` of shape (lead..., B, ...) viewed as (lead..., B, n_lane)."""
    return t.reshape(t.shape[:lead] + (lanes, -1))


class _FusedAxpy(torch.autograd.Function):
    """base + sum_i hc[i] * K[i] in one pass (kernels/ops.py); with hc
    (B, s), base[b] + sum_i hc[b, i] * K[i, b]."""

    @staticmethod
    def forward(ctx, base, K, hc):
        ctx.save_for_backward(hc, K if ctx.needs_input_grad[2] else None)
        return ops.butcher_combine(base.contiguous(), K.contiguous(),
                                   hc.contiguous())

    @staticmethod
    def backward(ctx, dout):
        hc, K = ctx.saved_tensors
        acc_dt = acc_dtype(dout.dtype)
        d = dout.to(acc_dt)
        dbase = dK = dhc = None
        if ctx.needs_input_grad[0]:
            dbase = dout
        if hc.dim() == 2:                                    # (B, s) lanes
            B, s = hc.shape
            dl = _lane_view(d, 0, B)                         # (B, n_lane)
            if ctx.needs_input_grad[1]:
                dK = (hc.t()[:, :, None] * dl).reshape(
                    (s,) + dout.shape).to(dout.dtype)
            if ctx.needs_input_grad[2]:
                dhc = (_lane_view(K.to(acc_dt), 1, B) * dl).sum(-1).t()
            return dbase, dK, dhc
        if ctx.needs_input_grad[1]:
            dK = (hc.reshape((-1,) + (1,) * dout.ndim) * d).to(dout.dtype)
        if ctx.needs_input_grad[2]:
            dhc = (K.to(acc_dt) * d).reshape(K.shape[0], -1).sum(1)
        return dbase, dK, dhc


class _FusedAxpyRows(torch.autograd.Function):
    """out[r] = sc[r] * x + sum_i hc[r, i] * K[i], all rows in one pass;
    with hc (B, m, s), out[r, b] = sc[r] * x[b] + sum_i hc[b, r, i] *
    K[i, b]."""

    @staticmethod
    def forward(ctx, x, K, hc, sc):
        ctx.save_for_backward(
            hc, sc, K if ctx.needs_input_grad[2] else None,
            x if ctx.needs_input_grad[3] else None)
        return ops.butcher_combine_rows(x.contiguous(), K.contiguous(),
                                        hc.contiguous(), sc.contiguous())

    @staticmethod
    def backward(ctx, dout):
        hc, sc, K, x = ctx.saved_tensors
        acc_dt = acc_dtype(dout.dtype)
        d = dout.to(acc_dt).reshape(dout.shape[0], -1)       # (m, n)
        shape = dout.shape[1:]
        dx = dK = dhc = dsc = None
        if ctx.needs_input_grad[0]:
            dx = (sc @ d).reshape(shape).to(dout.dtype)
        if ctx.needs_input_grad[3]:
            dsc = d @ x.to(acc_dt).reshape(-1)
        if hc.dim() == 3:                                    # (B, m, s) lanes
            B, s = hc.shape[0], hc.shape[2]
            dl = _lane_view(d, 1, B)                         # (m, B, n_lane)
            if ctx.needs_input_grad[1]:
                dK = torch.einsum("bri,rbn->ibn", hc, dl).reshape(
                    (s,) + tuple(shape)).to(dout.dtype)
            if ctx.needs_input_grad[2]:
                dhc = torch.einsum("rbn,ibn->bri", dl,
                                   _lane_view(K.to(acc_dt), 1, B))
            return dx, dK, dhc, dsc
        if ctx.needs_input_grad[1]:
            dK = (hc.t() @ d).reshape((hc.shape[1],) + tuple(shape)) \
                .to(dout.dtype)
        if ctx.needs_input_grad[2]:
            dhc = d @ K.to(acc_dt).reshape(K.shape[0], -1).t()
        return dx, dK, dhc, dsc


# ---------------------------------------------------------------------------
# StageCombiner
# ---------------------------------------------------------------------------

def _first_leaf(tree: Pytree) -> torch.Tensor:
    return pytree.tree_leaves(tree)[0]


class StageCombiner:
    """All stage linear algebra for one tableau, backend-dispatched.

    Instances are cached (``get_combiner``).  Their only state is a cache
    of tableau rows already moved to a device; every method is otherwise a
    pure function of its tensor arguments, and h may be a device scalar.
    """

    def __init__(self, tab: ButcherTableau, backend: str = "auto"):
        resolve_backend(backend)
        self.tab = tab
        self.backend = backend
        s = tab.s
        self.a_np = tab.a_dense
        self.b_np = tab.b_dense
        self.b_err_np = tab.b_err_dense
        # I0 = {i : b_i = 0}: stages whose btilde is h_n (paper Eq. 8).
        self.i0_np = (self.b_np == 0.0).astype(np.float64)
        # Backward Lambda-recursion coefficient rows, Eq. (7)/(8) with the
        # h-dependence factored out:  coef_i(h) = R[i] + h P[i] + h^2 Q[i],
        # nonzero only for j > i.  Derivation: btilde_j = b_j + h [b_j = 0].
        R = np.zeros((s, s))
        P = np.zeros((s, s))
        Q = np.zeros((s, s))
        for i in range(s):
            for j in range(i + 1, s):
                aji = self.a_np[j, i]
                if aji == 0.0:
                    continue
                if self.b_np[i] != 0.0:
                    # -(h btilde_j) a_ji / b_i
                    P[i, j] += -aji * self.b_np[j] / self.b_np[i]
                    Q[i, j] += -aji * self.i0_np[j] / self.b_np[i]
                else:
                    # -btilde_j a_ji
                    R[i, j] += -aji * self.b_np[j]
                    P[i, j] += -aji * self.i0_np[j]
        self._lam_R, self._lam_P, self._lam_Q = R, P, Q
        self._rows: Dict[Tuple, torch.Tensor] = {}

    # -- device-resident coefficient rows ----------------------------------

    def _device_row(self, arr: np.ndarray, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
        """``arr`` as a ``dtype`` tensor on ``device``, moved there once."""
        key = (arr.tobytes(), arr.shape, dtype, device)
        row = self._rows.get(key)
        if row is None:
            row = torch.as_tensor(arr, dtype=dtype).to(device)
            self._rows[key] = row
        return row

    def _hc(self, coefs, h, acc_dt, device) -> torch.Tensor:
        """h * coefs in the accumulation dtype, on the device.  A (B,) step
        gives one row per lane, (B,) + coefs.shape; a tensor ``coefs``
        with a (B,) step is one row per lane already."""
        if isinstance(coefs, np.ndarray):
            row = self._device_row(coefs, acc_dt, device)
            per_lane = False
        else:
            row = coefs.to(acc_dt)
            per_lane = True
        if isinstance(h, torch.Tensor):
            h = h.to(acc_dt)
            if h.dim():
                h = h.reshape(h.shape + (1,) * (row.dim() - per_lane))
            return h * row
        return row if h == 1.0 else row * h

    def uses_kernel(self, tree: Pytree) -> bool:
        """True when this combiner takes the kernel path for ``tree``."""
        return resolve_backend(self.backend,
                               _first_leaf(tree).device) == "cuda"

    # -- the one primitive everything routes through ----------------------

    def combine(self, base: Pytree, K: Pytree, coefs, h=1.0,
                idx=None) -> Pytree:
        """base + h * sum_p coefs[p] * K[idx[p]], per leaf, one fused pass.

        ``K`` is a stacked slope buffer pytree; ``coefs`` is a static numpy
        row or a device tensor row (the backward recursion's h-dependent
        rows).  ``idx`` (plain path only) maps coefficient positions to
        buffer rows, so callers with an h-dependent but statically sparse
        row skip the dead slope rows; when omitted, coefs aligns with K's
        leading dim.  With a (B,) ``h`` (or a per-lane (B, s) tensor row)
        each lane b of the leaves combines with its own row.
        """
        if int(coefs.shape[0]) == 0:
            return base
        leaves_b, spec = pytree.tree_flatten(base)
        leaves_K = pytree.tree_leaves(K)
        if self.uses_kernel(base):
            if idx is not None:
                raise ValueError("row pruning is a plain-path optimization")
            out = [_FusedAxpy.apply(lb, lk, self._hc(
                coefs, h, acc_dtype(lb.dtype), lb.device))
                for lb, lk in zip(leaves_b, leaves_K)]
        else:
            out = [self._combine_leaf_torch(lb, lk, coefs, h, idx)
                   for lb, lk in zip(leaves_b, leaves_K)]
        return pytree.tree_unflatten(out, spec)

    def _combine_leaf_torch(self, base, K, coefs, h, idx=None):
        # accumulate in >= f32, and in f64 when the state is f64, strictly
        # in stage order.  Statically-zero coefficients (explicit-tableau
        # rows are sparse, e.g. dopri5's b_2 = 0) cost a slope-row read
        # each: skip them.  ``idx`` is the caller's static sparsity pattern
        # for h-dependent rows.
        acc_dt = acc_dtype(base.dtype)
        hc = self._hc(coefs, h, acc_dt, base.device)
        if idx is not None:
            pairs = [(p, int(col)) for p, col in enumerate(idx)]
        elif isinstance(coefs, np.ndarray):
            pairs = [(p, p) for p in np.nonzero(coefs)[0]]
        else:
            pairs = [(p, p) for p in range(K.shape[0])]
        acc = base.to(acc_dt)
        for p, col in pairs:
            acc = acc + lane_bcast(hc[..., p], base) * K[col].to(acc_dt)
        return acc.to(base.dtype)

    def combine_rows(self, x: Pytree, K: Pytree, rows: np.ndarray,
                     base_scale: np.ndarray, h):
        """Multi-row combine: out[r] = base_scale[r]*x + h sum_i rows[r,i] K[i].

        One read of (x, K) produces all m outputs — used to fuse the step
        update and the embedded error estimate into a single pass.  Returns
        a list of m pytrees.  A (B,) ``h`` gives each lane its own rows.
        """
        m = int(rows.shape[0])
        leaves_x, spec = pytree.tree_flatten(x)
        leaves_K = pytree.tree_leaves(K)
        kernel = self.uses_kernel(x)
        outs = [[] for _ in range(m)]
        for lx, lk in zip(leaves_x, leaves_K):
            acc_dt = acc_dtype(lx.dtype)
            hc = self._hc(rows, h, acc_dt, lx.device)
            sc = self._device_row(base_scale, acc_dt, lx.device)
            if kernel:
                o = _FusedAxpyRows.apply(lx, lk, hc, sc)
                for r in range(m):
                    outs[r].append(o[r])
                continue
            xf = lx.to(acc_dt)
            for r in range(m):
                acc = sc[r] * xf
                for i in np.nonzero(rows[r])[0]:
                    acc = acc + lane_bcast(hc[..., r, i], lx) * \
                        lk[i].to(acc_dt)
                outs[r].append(acc.to(lx.dtype))
        return [pytree.tree_unflatten(o, spec) for o in outs]

    # -- forward (Eq. 5) ---------------------------------------------------

    def stage_state(self, x: Pytree, K: Pytree, h, i: int) -> Pytree:
        """X_i = x + h sum_{j<i} a_ij k_j over the buffer prefix K[:i]."""
        if i == 0 or not self.a_np[i, :i].any():
            return x
        return self.combine(x, stage_prefix(K, i), self.a_np[i, :i], h)

    def solution(self, x: Pytree, K: Pytree, h) -> Pytree:
        """x_{n+1} = x + h sum_i b_i k_i."""
        return self.combine(x, K, self.b_np, h)

    def error(self, x: Pytree, K_err: Pytree, h) -> Pytree:
        """err = h sum_i b_err_i k_i (K_err includes the FSAL slope when
        the tableau's error weights reference f(x_{n+1}))."""
        zeros = pytree.tree_map(torch.zeros_like, x)
        return self.combine(zeros, K_err, self.b_err_np, h)

    def solution_and_error(self, x: Pytree, K: Pytree, h):
        """(x_{n+1}, err) from ONE read of (x, K).

        Only valid when the error weights do not reference the FSAL stage
        (err_uses_fsal=False): both rows then combine the same s slopes.
        """
        if self.tab.err_uses_fsal or self.b_err_np is None:
            raise ValueError(f"{self.tab.name}: no fused solution+error")
        rows = np.stack([self.b_np, self.b_err_np])
        x_next, err = self.combine_rows(x, K, rows, np.array([1.0, 0.0]), h)
        return x_next, err

    # -- dense output (cubic Hermite) ----------------------------------------

    def interpolate(self, x0: Pytree, x1: Pytree, f0: Pytree, f1: Pytree,
                    h: torch.Tensor, theta: torch.Tensor) -> Pytree:
        """Cubic-Hermite dense output x(t_n + theta h) over one step.

        ``x0``/``x1`` are the step endpoints, ``f0``/``f1`` their slopes,
        ``theta`` in [0, 1].  ONE row combine over the stacked buffer
        [f0, f1, x1 - x0] with the row ``HERMITE_DENSE_W @ [1, theta,
        theta^2, theta^3]``, h folded into the slope rows:

            out = x0 + (h w0) f0 + (h w1) f1 + w2 (x1 - x0).

        With (L,) ``h``/``theta`` the L interpolations are the lanes of
        one combine (leaves (L, ...)): one coefficient row per lane.
        Local error O(h^4).
        """
        powers = torch.stack([torch.ones_like(theta), theta,
                              theta * theta, theta ** 3], dim=-1)
        w = powers @ self._device_row(HERMITE_DENSE_W, theta.dtype,
                                      theta.device).t()
        row = torch.stack([h * w[..., 0], h * w[..., 1], w[..., 2]], dim=-1)
        D = pytree.tree_map(
            lambda a, b, g0, g1: torch.stack([g0.to(a.dtype),
                                              g1.to(a.dtype), b - a]),
            x0, x1, f0, f1)
        return self.combine(x0, D, row, 1.0)

    # -- backward (Algorithm 2, Eq. 7/8) -----------------------------------

    def lambda_stage(self, lam_next: Pytree, L: Pytree, h: torch.Tensor,
                     i: int) -> Pytree:
        """Lambda_{n,i} from the adjoint-slope buffer suffix L[i+1:]."""
        if self.b_np[i] != 0.0:
            base = lam_next
        else:
            base = pytree.tree_map(torch.zeros_like, lam_next)
        s = self.tab.s
        R = self._lam_R[i, i + 1:]
        P = self._lam_P[i, i + 1:]
        Q = self._lam_Q[i, i + 1:]
        if i == s - 1 or not (R.any() or P.any() or Q.any()):
            return base
        if not self.uses_kernel(lam_next):
            # the row is h-dependent but its sparsity is static: prune the
            # structurally-dead adjoint-slope rows from the read.
            nz = np.nonzero((R != 0.0) | (P != 0.0) | (Q != 0.0))[0]
            R, P, Q = R[nz], P[nz], Q[nz]
        hh = h[:, None] if h.dim() else h     # a (B,) step: a row per lane
        row = (self._device_row(R, h.dtype, h.device)
               + hh * self._device_row(P, h.dtype, h.device)
               + (hh * hh) * self._device_row(Q, h.dtype, h.device))
        if self.uses_kernel(lam_next):
            # the kernel reads the whole suffix in its single pass anyway
            return self.combine(base, stage_suffix(L, i + 1), row, 1.0)
        return self.combine(base, L, row, 1.0, idx=nz + i + 1)

    def lambda_update(self, lam_next: Pytree, L: Pytree,
                      h: torch.Tensor) -> Pytree:
        """lambda_n = lambda_{n+1} - h sum_i btilde_i l_{n,i}."""
        hh = h[:, None] if h.dim() else h     # a (B,) step: a row per lane
        coefs = -(self._device_row(self.b_np, h.dtype, h.device)
                  + hh * self._device_row(self.i0_np, h.dtype, h.device))
        return self.combine(lam_next, L, coefs, h)


@functools.lru_cache(maxsize=None)
def get_combiner(tab: ButcherTableau,
                 backend: str = "auto") -> StageCombiner:
    return StageCombiner(tab, backend)
