"""The full-train-state checkpoint contract (the JAX package's
``repro.train.state``).

``TrainState`` carries everything a training run needs to resume
bit-identically after process death:

  * ``params``        — model parameters,
  * ``opt``           — AdamW state (m, v, step = the LR-schedule step,
                        optional float32 master copies),
  * ``rng``           — the state of the training ``torch.Generator`` (a
                        uint8 tensor, ``Generator.get_state()``), advanced
                        once per step, so a stochastic layer added later
                        rides the same contract,
  * ``data_step``     — the data cursor: the next pipeline step to consume
                        (``TokenPipeline`` is keyed by step),
  * ``solver_stats``  — cumulative ODE-solve counters (fixed-grid node
                        forward solves are static counts, see
                        ``node_solver_counts``),
  * ``compress_err``  — int8 gradient-compression error-feedback residual
                        (None when compression is off).

It is a dataclass registered with ``torch.utils._pytree`` (its leaves
flatten in field order), which ``runtime.Checkpointer`` saves and
restores.  Mapping-style access (``state["params"]``, ``"compress_err" in
state``) is kept, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

_FIELDS = ("params", "opt", "rng", "data_step", "solver_stats",
           "compress_err")


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any
    rng: Any                       # uint8 tensor: a generator's state
    data_step: Any                 # int32 0-dim: next data step to consume
    solver_stats: Any              # {"n_steps", "n_fevals"}: int32 0-dim
    compress_err: Optional[Any] = None

    def __getitem__(self, key):
        if key not in _FIELDS or (key == "compress_err"
                                  and self.compress_err is None):
            raise KeyError(key)
        return getattr(self, key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key):
        return key in _FIELDS and not (key == "compress_err"
                                       and self.compress_err is None)

    def keys(self):
        return tuple(f for f in _FIELDS if f in self)

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


pytree.register_pytree_node(
    TrainState,
    lambda s: ([getattr(s, f) for f in _FIELDS], None),
    lambda children, _ctx: TrainState(*children),
    serialized_type_name="repro_torch.train.state.TrainState")


def init_solver_stats(device="cpu") -> dict:
    return {"n_steps": torch.zeros((), dtype=torch.int32, device=device),
            "n_fevals": torch.zeros((), dtype=torch.int32, device=device)}


def node_solver_counts(arch) -> tuple:
    """Static per-forward-solve counts of a fixed-grid node arch: n_steps
    steps of s = len(b) stage evaluations each; (0, 0) for a discrete
    arch."""
    if arch.node.mode != "node":
        return 0, 0
    from repro_torch.core.tableau import get_tableau
    n_steps = arch.node.n_steps or arch.n_repeats
    return n_steps, n_steps * len(get_tableau(arch.node.method).b)


def generator_from_state(rng: torch.Tensor) -> torch.Generator:
    """A CPU ``torch.Generator`` set to a saved state."""
    g = torch.Generator()
    g.set_state(rng.detach().cpu().to(torch.uint8))
    return g


def train_state_from_jax(np_tree, cfg, device="cuda") -> TrainState:
    """The JAX package's ``TrainState`` (its leaves as numpy arrays, e.g.
    after ``tree_map(np.asarray, state)``; read by field name) as this
    package's, on ``device``: params, and AdamW's m, v and master trees,
    through ``models.lm.params_from_jax`` (the stacked unit leaves split
    per unit; ``models.encdec.params_from_jax`` for the enc-dec model); the step, data cursor, solver counters and compression
    residual as tensors.  The JAX PRNG key has no counterpart in a
    ``torch.Generator``: ``rng`` is the state ``init_train_state(...,
    seed=0)`` makes.  The dtypes are the JAX package's, bfloat16 leaves
    included (bit for bit: ``models.lm.tensor_from_numpy``)."""
    from repro_torch.models import encdec, lm
    params_from_jax = encdec.params_from_jax if cfg.encdec else \
        lm.params_from_jax

    def scalar(a, dt):
        return lm.tensor_from_numpy(a, dtype=dt, device=device)

    params = params_from_jax(np_tree["params"], cfg, device=device)
    jopt = np_tree["opt"]
    opt = {k: params_from_jax(jopt[k], cfg, device=device)
           for k in ("m", "v", "master") if k in jopt}
    opt["step"] = scalar(jopt["step"], torch.int32)
    err = np_tree.get("compress_err") if hasattr(np_tree, "get") else None
    return TrainState(
        params=params, opt=opt,
        rng=torch.Generator().manual_seed(1).get_state(),
        data_step=scalar(np_tree["data_step"], torch.int32),
        solver_stats={k: scalar(v, torch.int32)
                      for k, v in np_tree["solver_stats"].items()},
        compress_err=None if err is None else params_from_jax(
            err, cfg, device=device))
