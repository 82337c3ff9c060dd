"""Butcher tableaus for explicit Runge-Kutta methods.

Every tableau is explicit (a[i][j] == 0 for j >= i).  ``b_err`` (when present)
is the embedded lower-order weight vector used for adaptive step control; for
DOP853 the error weights reference an extra FSAL-style stage k_{s+1} =
f(x_{n+1}), flagged by ``err_uses_fsal``.

The symplectic adjoint method (core/symplectic.py) consumes ``a``, ``b``, ``c``
directly and handles b_i == 0 stages via the paper's Eq. (7)/(8) I0 set.

This module is numpy-only and is the PyTorch package's own copy of the JAX
package's tableau module: the dense coefficient arrays are identical.
"""
from __future__ import annotations

import dataclasses
import functools
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

__all__ = ["ButcherTableau", "get_tableau", "TABLEAUS", "register_tableau",
           "HERMITE_DENSE_W"]

# ---------------------------------------------------------------------------
# Dense-output (interpolation) tableau.
#
# Dense output observes interior times via 4th-order cubic-Hermite
# dense output over each accepted step [t_n, t_n + h_n].  With theta in
# [0, 1] the interpolant is
#
#   x(t_n + theta h) = x_n + h [w0(theta) f_n + w1(theta) f_{n+1}]
#                          + w2(theta) (x_{n+1} - x_n),
#
# where (w0, w1, w2) are the Hermite basis polynomials h10, h11, h01.  The
# rows of HERMITE_DENSE_W give their monomial coefficients against
# [1, theta, theta^2, theta^3], so the combine row for a given theta is
# ``HERMITE_DENSE_W @ [1, theta, theta^2, theta^3]``, fed to the row-combine
# primitive exactly like a Butcher row (dense output is not ported yet:
# ROADMAP queue 1 item 9).  Local error is O(h^4) for
# any tableau of order >= 3 (the interpolant only consumes the step
# endpoints and their slopes, so it is tableau-independent).
# ---------------------------------------------------------------------------

HERMITE_DENSE_W = np.array([
    [0.0, 1.0, -2.0, 1.0],   # w0 = h10(theta) = theta - 2 theta^2 + theta^3
    [0.0, 0.0, -1.0, 1.0],   # w1 = h11(theta) = -theta^2 + theta^3
    [0.0, 0.0, 3.0, -2.0],   # w2 = h01(theta) = 3 theta^2 - 2 theta^3
], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ButcherTableau:
    name: str
    order: int
    a: Tuple[Tuple[float, ...], ...]  # s rows; row i has entries a[i][j], j<i
    b: Tuple[float, ...]
    c: Tuple[float, ...]
    b_err: Optional[Tuple[float, ...]] = None  # embedded error weights (b - b*)
    err_order: Optional[int] = None
    err_uses_fsal: bool = False  # b_err has s+1 entries, last for f(x_{n+1})
    fsal: bool = False  # last stage of step n == first stage of step n+1

    @property
    def s(self) -> int:
        return len(self.b)

    @property
    def n_fevals(self) -> int:
        """Effective function evaluations per step (FSAL reuses one)."""
        return self.s - 1 if self.fsal else self.s

    def __post_init__(self):
        s = len(self.b)
        assert len(self.c) == s, (self.name, "c length")
        assert len(self.a) == s, (self.name, "a rows")
        for i, row in enumerate(self.a):
            assert len(row) == s, (self.name, "a row length", i)
            for j in range(i, s):
                assert row[j] == 0.0, (self.name, "not explicit", i, j)
        if self.b_err is not None:
            expect = s + 1 if self.err_uses_fsal else s
            assert len(self.b_err) == expect, (self.name, "b_err length")

    def a_np(self, dtype=np.float64) -> np.ndarray:
        return np.array(self.a, dtype=dtype)

    def b_np(self, dtype=np.float64) -> np.ndarray:
        return np.array(self.b, dtype=dtype)

    def c_np(self, dtype=np.float64) -> np.ndarray:
        return np.array(self.c, dtype=dtype)

    # Dense coefficient arrays alongside the Python tuples.  The solver
    # stack (core/combine.py) consumes these as host-side numpy and moves
    # each row to the device once, in the precision it combines in.
    # cached_property writes straight to __dict__, which bypasses the
    # frozen-dataclass __setattr__ guard, so each array is built once per
    # tableau.

    @functools.cached_property
    def a_dense(self) -> np.ndarray:
        return np.array(self.a, dtype=np.float64)

    @functools.cached_property
    def b_dense(self) -> np.ndarray:
        return np.array(self.b, dtype=np.float64)

    @functools.cached_property
    def c_dense(self) -> np.ndarray:
        return np.array(self.c, dtype=np.float64)

    @functools.cached_property
    def b_err_dense(self) -> Optional[np.ndarray]:
        if self.b_err is None:
            return None
        return np.array(self.b_err, dtype=np.float64)


def _frac_rows(rows, s):
    """Pad variable-length lower-triangular rows with zeros to s columns."""
    out = []
    for row in rows:
        vals = [float(Fraction(x) if isinstance(x, str) else x) for x in row]
        vals = vals + [0.0] * (s - len(vals))
        out.append(tuple(vals))
    return tuple(out)


def _fr(seq):
    return tuple(float(Fraction(x) if isinstance(x, str) else x) for x in seq)


TABLEAUS = {}


def register_tableau(t: ButcherTableau) -> ButcherTableau:
    TABLEAUS[t.name] = t
    return t


# --- Euler (order 1, s=1) ---------------------------------------------------
register_tableau(ButcherTableau(
    name="euler", order=1,
    a=((0.0,),), b=(1.0,), c=(0.0,),
))

# --- Midpoint (order 2, s=2) ------------------------------------------------
register_tableau(ButcherTableau(
    name="midpoint", order=2,
    a=_frac_rows([[], ["1/2"]], 2),
    b=_fr(["0", "1"]), c=_fr(["0", "1/2"]),
))

# --- Heun-Euler (adaptive heun; order 2(1), s=2) -----------------------------
register_tableau(ButcherTableau(
    name="heun12", order=2,
    a=_frac_rows([[], ["1"]], 2),
    b=_fr(["1/2", "1/2"]), c=_fr(["0", "1"]),
    b_err=_fr(["-1/2", "1/2"]), err_order=1,
))

# --- Bogacki-Shampine (bosh3; order 3(2), s=4 with FSAL, b4=0) ---------------
register_tableau(ButcherTableau(
    name="bosh3", order=3,
    a=_frac_rows([[], ["1/2"], ["0", "3/4"], ["2/9", "1/3", "4/9"]], 4),
    b=_fr(["2/9", "1/3", "4/9", "0"]),
    c=_fr(["0", "1/2", "3/4", "1"]),
    b_err=_fr([str(Fraction(2, 9) - Fraction(7, 24)),
               str(Fraction(1, 3) - Fraction(1, 4)),
               str(Fraction(4, 9) - Fraction(1, 3)),
               str(Fraction(0) - Fraction(1, 8))]),
    err_order=2, fsal=True,
))

# --- Classic RK4 (order 4, s=4) ----------------------------------------------
register_tableau(ButcherTableau(
    name="rk4", order=4,
    a=_frac_rows([[], ["1/2"], ["0", "1/2"], ["0", "0", "1"]], 4),
    b=_fr(["1/6", "1/3", "1/3", "1/6"]),
    c=_fr(["0", "1/2", "1/2", "1"]),
))

# --- Fehlberg 4(5) (order 5 weights used; s=6) --------------------------------
_fb = {
    "b5": ["16/135", "0", "6656/12825", "28561/56430", "-9/50", "2/55"],
    "b4": ["25/216", "0", "1408/2565", "2197/4104", "-1/5", "0"],
}
register_tableau(ButcherTableau(
    name="fehlberg45", order=5,
    a=_frac_rows([
        [],
        ["1/4"],
        ["3/32", "9/32"],
        ["1932/2197", "-7200/2197", "7296/2197"],
        ["439/216", "-8", "3680/513", "-845/4104"],
        ["-8/27", "2", "-3544/2565", "1859/4104", "-11/40"],
    ], 6),
    b=_fr(_fb["b5"]),
    c=_fr(["0", "1/4", "3/8", "12/13", "1", "1/2"]),
    b_err=tuple(float(Fraction(x5) - Fraction(x4))
                for x5, x4 in zip(_fb["b5"], _fb["b4"])),
    err_order=4,
))

# --- Dormand-Prince 5(4) (dopri5; s=7 with FSAL, b2=b7=0 handled by I0) -------
_dp_b = ["35/384", "0", "500/1113", "125/192", "-2187/6784", "11/84", "0"]
_dp_bstar = ["5179/57600", "0", "7571/16695", "393/640",
             "-92097/339200", "187/2100", "1/40"]
register_tableau(ButcherTableau(
    name="dopri5", order=5,
    a=_frac_rows([
        [],
        ["1/5"],
        ["3/40", "9/40"],
        ["44/45", "-56/15", "32/9"],
        ["19372/6561", "-25360/2187", "64448/6561", "-212/729"],
        ["9017/3168", "-355/33", "46732/5247", "49/176", "-5103/18656"],
        ["35/384", "0", "500/1113", "125/192", "-2187/6784", "11/84"],
    ], 7),
    b=_fr(_dp_b),
    c=_fr(["0", "1/5", "3/10", "4/5", "8/9", "1", "1"]),
    b_err=tuple(float(Fraction(x) - Fraction(y))
                for x, y in zip(_dp_b, _dp_bstar)),
    err_order=4, fsal=True,
))


# --- Dormand-Prince 8 (DOP853 core; s=12, order 8) ---------------------------
def _register_dopri8():
    try:
        from scipy.integrate._ivp import dop853_coefficients as dc
    except Exception:  # pragma: no cover - scipy always present in this env
        return
    s = int(dc.N_STAGES)  # 12
    A = np.asarray(dc.A, dtype=np.float64)[:s, :s]
    B = np.asarray(dc.B, dtype=np.float64)[:s]
    C = np.asarray(dc.C, dtype=np.float64)[:s]
    E5 = np.asarray(dc.E5, dtype=np.float64)[:s + 1]  # 5th-order err, uses f_new
    a = tuple(tuple(float(A[i, j]) if j < i else 0.0 for j in range(s))
              for i in range(s))
    register_tableau(ButcherTableau(
        name="dopri8", order=8,
        a=a, b=tuple(float(x) for x in B), c=tuple(float(x) for x in C),
        b_err=tuple(float(x) for x in E5), err_order=5, err_uses_fsal=True,
    ))


_register_dopri8()


def get_tableau(name: str) -> ButcherTableau:
    if name not in TABLEAUS:
        raise KeyError(f"unknown tableau {name!r}; have {sorted(TABLEAUS)}")
    return TABLEAUS[name]
