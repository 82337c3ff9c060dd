"""Fault-tolerant checkpointing: atomic, keep-last-k, async (the JAX
package's ``repro.runtime.checkpoint``, the same on-disk contract).

Layout:  <dir>/step_<N>/host_<i>.npz  +  <dir>/step_<N>/MANIFEST.json
The manifest is written LAST and the step directory published by an atomic
rename, so a checkpoint directory is valid iff its manifest exists: a crash
mid-write is never mistaken for a complete checkpoint, and ``restore``
picks the newest valid step.  Stale ``.tmp_step_*`` directories left by a
crash mid-write are swept on init and before every save.

Async saves overlap the next train step: ``save(..., block=False)`` pulls
every leaf to host memory synchronously (so the caller may overwrite the
device tensors at once) and writes in a background thread.
``REPRO_CKPT_WRITE_DELAY_S`` (or ``write_delay_s``) injects a delay between
the array write and the manifest publish: the fault-injection tests SIGKILL
a run there and prove the resume contract.

A state laid out on a mesh (DTensor leaves, ``runtime.elastic.OwnedShard``
leaves) is saved as its full logical arrays: every rank calls ``save``,
each leaf is made whole (``elastic.full_leaf``, collective), and rank 0
alone writes.  ``restore(..., shardings=)`` reads the full arrays on every
rank and lays each leaf out per its sharding (``elastic.shard_leaf``, no
communication), so a checkpoint written on one mesh restores on another.

Leaves are flattened with ``torch.utils._pytree`` (a ``TrainState``
flattens in its field order; a None leaf, such as ``compress_err`` without
compression, is skipped, as the JAX package's tree utilities skip it),
saved as numpy arrays
(``leaf_<i>``), and restored into the structure, dtypes and devices of a
``like`` tree.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..parallel import comm


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of a leaf: a CUDA tensor's ``.cpu()`` copies; a CPU
    tensor's numpy view would share the caller's storage, so it is copied
    (an async write must not see later in-place updates).  A laid-out leaf
    is made whole first (a collective)."""
    from .elastic import full_leaf
    leaf = full_leaf(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        a = t.cpu().numpy()
        return a.copy() if t.device.type == "cpu" else a
    return np.array(leaf)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False, host_id: int = 0,
                 n_hosts: int = 1, write_delay_s: Optional[float] = None):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.host_id = host_id
        self.n_hosts = n_hosts
        if write_delay_s is None:
            write_delay_s = float(
                os.environ.get("REPRO_CKPT_WRITE_DELAY_S", "0") or 0)
        self.write_delay_s = write_delay_s
        self._thread: Optional[threading.Thread] = None
        # of an SPMD program's ranks, rank 0 alone writes
        self._writer = comm.is_writer()
        os.makedirs(directory, exist_ok=True)
        if self._writer:
            self._clean_stale_tmp()

    def _clean_stale_tmp(self) -> None:
        """Remove ``.tmp_step_*`` leftovers of a crash mid-write.  Safe
        before a write: within one Checkpointer one writer runs at a time
        (``save`` joins the previous thread), so a tmp dir found here
        belongs to a dead process."""
        for name in os.listdir(self.dir):
            if name.startswith(".tmp_step_"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -- save -------------------------------------------------------------
    def save(self, step: int, state: Any, block: bool = True):
        # the device -> host pull is synchronous, the file write is not
        arrays = [_to_numpy(l) for l in pytree.tree_leaves(state)
                  if l is not None]
        if not self._writer:
            return

        def _write():
            self._clean_stale_tmp()
            tmp = os.path.join(self.dir, f".tmp_step_{step}_{self.host_id}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, f"host_{self.host_id}.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(arrays)})
            if self.write_delay_s:   # fault-injection window (tests)
                time.sleep(self.write_delay_s)
            manifest = {"step": step, "n_leaves": len(arrays),
                        "n_hosts": self.n_hosts, "time": time.time()}
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)   # atomic publish
            self._gc()

        if self.async_save:
            self.wait()
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
            if block:
                self.wait()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "MANIFEST.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                shardings: Any = None):
        """Restore into the structure of ``like``: each leaf takes the
        dtype and device of ``like``'s leaf, and, with ``shardings`` (a
        tree like ``like`` of ``elastic.NamedSharding``, from
        ``elastic.mesh_shardings``), its layout on a mesh.  Returns
        (state, step)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        stepdir = os.path.join(self.dir, f"step_{step}")
        leaves, spec = pytree.tree_flatten(like)
        n_leaves = sum(l is not None for l in leaves)
        with open(os.path.join(stepdir, "MANIFEST.json")) as f:
            manifest = json.load(f)
        if manifest.get("n_leaves") != n_leaves:
            raise ValueError(
                f"checkpoint step {step} in {self.dir} holds "
                f"{manifest.get('n_leaves')} leaves but the restore target "
                f"``like`` has {n_leaves}: restore must be given the "
                "same train-state pytree structure that was saved "
                "(shape-contract mismatch, not a corrupt checkpoint)")
        out = []
        i = -1
        with np.load(os.path.join(stepdir, f"host_{self.host_id}.npz")) as data:
            for l in leaves:
                if l is None:
                    out.append(None)
                    continue
                i += 1
                arr = data[f"leaf_{i}"]
                if isinstance(l, torch.Tensor):
                    t = torch.from_numpy(np.array(arr))
                    if tuple(t.shape) != tuple(l.shape):
                        raise ValueError(
                            f"checkpoint step {step} leaf {i}: shape "
                            f"{tuple(t.shape)} but the restore target has "
                            f"{tuple(l.shape)} (shape-contract mismatch)")
                    out.append(t.to(device=l.device, dtype=l.dtype))
                else:
                    out.append(type(l)(arr) if np.ndim(arr) == 0 else arr)
        if shardings is not None:
            from .elastic import shard_leaf
            out = [shard_leaf(t, sh) for t, sh in
                   zip(out, spec.flatten_up_to(shardings))]
        return pytree.tree_unflatten(out, spec), step
