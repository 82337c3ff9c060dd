"""Build and load the hand-written CUDA kernels of this package.

Each source in ``csrc/`` is compiled with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, at first use, under
``build_dir()`` (named by a hash of the source, the ``csrc/`` headers it
includes and the flags, so an edited source or header rebuilds what reads
it and nothing else), and loaded with ``ctypes``.  No PyTorch headers are
included, so a build takes seconds.  A failed build raises; nothing falls
back to a plain version.

``build_dir()`` is ``repro_torch/_build/`` beside the sources
(``BUILD_DIR``) when the package directory is writable (a checkout, an
editable install); else, for an install into a read-only site-packages,
``repro_torch/_build`` under the user's cache directory
(``$XDG_CACHE_HOME``, or ``~/.cache``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["CudaLibrary", "build_all", "build_dir", "call", "raise_on",
           "NVCC_FLAGS", "BUILD_DIR", "CSRC"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels cannot be built")
    return found


def build_dir() -> pathlib.Path:
    """Where the built libraries go (see the module note): ``BUILD_DIR`` if
    it exists writable or can be made in a writable package directory,
    else the user cache directory."""
    here = BUILD_DIR if BUILD_DIR.exists() else BUILD_DIR.parent
    if os.access(here, os.W_OK | os.X_OK):
        return BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or \
        os.path.join(os.path.expanduser("~"), ".cache")
    return pathlib.Path(cache) / "repro_torch" / "_build"


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _with_local_headers(source: pathlib.Path) -> bytes:
    """The source's text followed by that of every ``#include "..."`` it
    reaches in its own directory (each once, depth first): what a build of
    it reads from ``csrc/``."""
    seen, out, todo = set(), [], [source]
    while todo:
        path = todo.pop()
        if path in seen or not path.exists():
            continue
        seen.add(path)
        text = path.read_bytes()
        out.append(text)
        todo.extend(path.parent / m.decode()
                    for m in reversed(_LOCAL_INCLUDE.findall(text)))
    return b"".join(out)


def _compile(source: pathlib.Path):
    src = _with_local_headers(source)
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    so = out_dir / f"{source.stem}_{tag}.so"
    if so.exists():
        return so, ""
    try:
        out_dir.mkdir(parents=True, exist_ok=True)
    except OSError as exc:
        raise RuntimeError(
            f"cannot make the kernel build directory {out_dir} ({exc}): "
            f"the package's own _build/ when it is writable, else "
            f"repro_torch/_build under $XDG_CACHE_HOME or ~/.cache") from exc
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}) building into {out_dir}: "
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so, proc.stdout + proc.stderr


class CudaLibrary:
    """One ``csrc/<name>.cu`` source: built on first ``load()``, then cached
    for the process.  ``entries`` maps each C entry point to its ctypes
    argument types (every entry returns an ``int`` cudaError code).
    ``log`` keeps the compiler's output (``-Xptxas -v``: registers, shared
    memory and spills per kernel); it is empty when a cached build of the
    same source was loaded."""

    def __init__(self, name: str, entries: Dict[str, Sequence]):
        self.source = CSRC / f"{name}.cu"
        self.entries = entries
        self.cdll: Optional[ctypes.CDLL] = None
        self.path: Optional[pathlib.Path] = None
        self.log = ""

    def load(self) -> ctypes.CDLL:
        if self.cdll is None:
            self.path, self.log = _compile(self.source)
            lib = ctypes.CDLL(str(self.path))
            for entry, argtypes in self.entries.items():
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self.cdll = lib
        return self.cdll


def build_all(libraries: List[CudaLibrary]) -> Dict[str, str]:
    """Compile the given libraries' sources in parallel (one ``nvcc`` each,
    all started together), then load them; returns each source's compiler
    log by name."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        futures = [pool.submit(lib.load) for lib in libraries]
        for f in futures:
            f.result()
    return {lib.source.stem: lib.log for lib in libraries}


def call(fn, index: int, *args) -> int:
    """Call the C entry point ``fn(*args, stream)`` on the current stream of
    CUDA device ``index`` (read as a raw handle, with no Stream object),
    under a device guard only when ``index`` is not the current device;
    returns its cudaError code."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {err}")
