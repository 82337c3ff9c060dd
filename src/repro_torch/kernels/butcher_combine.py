"""CUDA kernels for the fused Runge-Kutta stage combination (Hopper, sm_90a).

Two kernels over a stacked slope buffer ``ks`` with leading stage dim s,
both in ``csrc/butcher_combine.cu``:

  * ``butcher_combine``      — one coefficient row:
        out = x + sum_i hc[i] * ks[i]
    (replaces the JAX package's ``butcher_combine_pallas``)
  * ``butcher_combine_rows`` — m rows from ONE read of (x, ks):
        out[r] = sc[r] * x + sum_i hc[r, i] * ks[i]
    (replaces ``butcher_combine_rows_pallas``; the solver uses it for the
    fused step update + embedded error, rows = [b; b_err], sc = [1; 0])

``hc``/``sc`` arrive already scaled by the step size, in the accumulation
dtype ``promote(x.dtype, float32)``, as device tensors: the wrappers never
read them on the host.  The plain PyTorch versions of both functions are in
``kernels/ref.py``; ``kernels/ops.py`` routes CPU tensors there and CUDA
tensors here.

The source is compiled with ``nvcc`` at first use into a shared library
with a plain C interface under ``repro_torch/_build/`` (named by the
source's hash, so an edited source rebuilds) and loaded with ``ctypes``.
Each wrapper counts its kernel launches in ``<wrapper>.launches``, a plain
integer that callers may reset.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

import torch

from .ref import acc_dtype

__all__ = ["butcher_combine", "butcher_combine_rows", "build", "MAX_STAGES",
           "MAX_ROWS", "SOURCE", "BUILD_DIR"]

MAX_STAGES = 13
MAX_ROWS = 13
_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "butcher_combine.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
               torch.bfloat16: 3}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "butcher_combine CUDA kernels cannot be built")
    return found


class _Library:
    """The compiled kernels: built on first use, then cached for the
    process.  ``log`` keeps the compiler's output (``-Xptxas -v``: registers
    and shared memory per kernel)."""

    def __init__(self):
        self.cdll: Optional[ctypes.CDLL] = None
        self.path: Optional[pathlib.Path] = None
        self.log = ""

    def load(self) -> ctypes.CDLL:
        if self.cdll is None:
            self.path, self.log = _compile()
            lib = ctypes.CDLL(str(self.path))
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.butcher_combine_launch.argtypes = [i32, vp, vp, vp, vp, i64,
                                                   i32, vp]
            lib.butcher_combine_launch.restype = i32
            lib.butcher_combine_rows_launch.argtypes = [i32, vp, vp, vp, vp,
                                                        vp, i64, i32, i32, vp]
            lib.butcher_combine_rows_launch.restype = i32
            self.cdll = lib
        return self.cdll


_LIB = _Library()


def _compile():
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"butcher_combine_{tag}.so"
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so, proc.stdout + proc.stderr


def build() -> str:
    """Compile (if needed) and load the kernels; returns the compiler log
    (empty when a cached build of the same source was loaded)."""
    _LIB.load()
    return _LIB.log


def _check(x: torch.Tensor, ks: torch.Tensor, coef: torch.Tensor,
           coef_shape, name: str):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(have {sorted(map(str, _DTYPE_CODE))})")
    if ks.dtype != x.dtype:
        raise TypeError(f"{name}: ks dtype {ks.dtype} != x dtype {x.dtype}")
    if tuple(ks.shape[1:]) != tuple(x.shape) or ks.ndim != x.ndim + 1:
        raise ValueError(f"{name}: ks shape {tuple(ks.shape)} is not "
                         f"(s,) + {tuple(x.shape)}")
    s = ks.shape[0]
    if not 1 <= s <= MAX_STAGES:
        raise ValueError(f"{name}: s={s} stages not in [1, {MAX_STAGES}]")
    acc = acc_dtype(x.dtype)
    if coef.dtype != acc or tuple(coef.shape) != tuple(coef_shape):
        raise ValueError(f"{name}: coefficients must be {acc} of shape "
                         f"{tuple(coef_shape)}, got {coef.dtype} "
                         f"{tuple(coef.shape)}")
    for t in (ks, coef):
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
    for t in (x, ks, coef):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return s


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")


def butcher_combine(x: torch.Tensor, ks: torch.Tensor,
                    hc: torch.Tensor) -> torch.Tensor:
    """out = x + sum_i hc[i] * ks[i] on the card.

    x: (...,) CUDA tensor of float32/float64/float16/bfloat16; ks: (s,) +
    x.shape of the same dtype, 1 <= s <= 13; hc: (s,) in promote(x.dtype,
    float32).  All contiguous on one device.
    """
    s = _check(x, ks, hc, (ks.shape[0],), "butcher_combine")
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    lib = _LIB.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.butcher_combine_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), ks.data_ptr(), hc.data_ptr(),
            out.data_ptr(), n, s, stream)
    _raise_on(err, "butcher_combine")
    butcher_combine.launches += 1
    return out


def butcher_combine_rows(x: torch.Tensor, ks: torch.Tensor, hc: torch.Tensor,
                         sc: torch.Tensor) -> torch.Tensor:
    """out[r] = sc[r] * x + sum_i hc[r, i] * ks[i] on the card, all m rows
    from one read of (x, ks).  hc: (m, s), sc: (m,), both in
    promote(x.dtype, float32); 1 <= m <= 13.  Returns (m,) + x.shape."""
    m = hc.shape[0] if hc.ndim == 2 else -1
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"butcher_combine_rows: hc must be (m, s) with "
                         f"1 <= m <= {MAX_ROWS}, got {tuple(hc.shape)}")
    s = _check(x, ks, hc, (m, ks.shape[0]), "butcher_combine_rows")
    _check(x, ks, sc, (m,), "butcher_combine_rows")
    out = torch.empty((m,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    lib = _LIB.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.butcher_combine_rows_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), ks.data_ptr(), hc.data_ptr(),
            sc.data_ptr(), out.data_ptr(), n, s, m, stream)
    _raise_on(err, "butcher_combine_rows")
    butcher_combine_rows.launches += 1
    return out


butcher_combine.launches = 0
butcher_combine_rows.launches = 0
