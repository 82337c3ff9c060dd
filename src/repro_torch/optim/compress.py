"""Gradient compression for the data-parallel all-reduce (the JAX
package's ``repro.optim.compress``), applied to the gradient tree before
the optimizer:

  * "bf16": cast grads to bfloat16 (2x fewer bytes, no state).
  * "int8": per-tensor symmetric int8 quantization with error feedback:
    the residual is carried in the train state and added back next step.

The data-parallel step (``train.data_parallel``) compresses the reduced
gradient, as the JAX program compresses that of the global batch.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    mode: str = "none"           # none | bf16 | int8
    error_feedback: bool = True


def init_error_state(params, cfg: CompressionConfig):
    if cfg.mode == "int8" and cfg.error_feedback:
        return pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return None


def compress_grads(grads, cfg: CompressionConfig, error_state=None,
                   leaf_max=None, groups=None):
    """Returns (compressed representation, new error state).  int8 leaves
    become (int8 tensor, float32 0-dim scale) pairs.  ``leaf_max`` (int8)
    maps the stacked per-leaf max |g| of this rank's blocks to those of the
    whole leaves (tensor parallelism: ``DataParallel.leaf_max``); without
    it the leaves are whole.  ``groups`` (int8) gives each leaf, in
    ``tree_leaves`` order, a key: the leaves of one key share one scale,
    from the largest |g| among them.  The JAX package stacks a model's
    repeated units into one leaf, whose per-tensor scale spans every unit
    (``train.train_step.stack_groups``)."""
    if cfg.mode == "none":
        return grads, error_state
    if cfg.mode == "bf16":
        return pytree.tree_map(lambda g: g.to(torch.bfloat16), grads), \
            error_state
    if cfg.mode == "int8":
        leaves_g, spec = pytree.tree_flatten(grads)
        leaves_e = [None] * len(leaves_g) if error_state is None else \
            pytree.tree_leaves(error_state)
        g32s = []
        for g, e in zip(leaves_g, leaves_e):
            g32 = g.to(torch.float32)
            g32s.append(g32 + e if e is not None else g32)
        amax = [torch.max(torch.abs(g32)) for g32 in g32s]
        if leaf_max is not None and amax:
            amax = list(leaf_max(torch.stack(amax)).unbind())
        if groups is not None:
            top: dict = {}
            for key, mx in zip(groups, amax):
                top[key] = mx if key not in top else torch.maximum(top[key],
                                                                   mx)
            amax = [top[key] for key in groups]
        qs, errs = [], []
        for g32, mx in zip(g32s, amax):
            scale = torch.clamp(mx, min=1e-12) / 127.0
            qi = torch.clamp(torch.round(g32 / scale), -127, 127).to(
                torch.int8)
            qs.append((qi, scale))
            errs.append(g32 - qi.to(torch.float32) * scale)
        return pytree.tree_unflatten(qs, spec), pytree.tree_unflatten(errs,
                                                                       spec)
    raise ValueError(cfg.mode)


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and \
        isinstance(x[0], torch.Tensor) and x[0].dtype == torch.int8


def decompress_grads(comp, cfg: CompressionConfig):
    if cfg.mode == "none":
        return comp
    if cfg.mode == "bf16":
        return pytree.tree_map(lambda g: g.to(torch.float32), comp)
    if cfg.mode == "int8":
        return pytree.tree_map(
            lambda t: t[0].to(torch.float32) * t[1], comp, is_leaf=_is_pair)
    raise ValueError(cfg.mode)
