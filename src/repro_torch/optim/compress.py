"""Gradient compression for the data-parallel all-reduce (the JAX
package's ``repro.optim.compress``), applied to the gradient tree before
the optimizer:

  * "bf16": cast grads to bfloat16 (2x fewer bytes, no state).
  * "int8": per-tensor symmetric int8 quantization with error feedback:
    the residual is carried in the train state and added back next step.

On one card there is no all-reduce; the round trip is the same arithmetic
the multi-card path would apply (item 15 brings the collectives).
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


def compress_grads(grads, cfg: CompressionConfig, error_state=None):
    """Returns (compressed representation, new error state).  int8 leaves
    become (int8 tensor, float32 0-dim scale) pairs."""
    if cfg.mode == "none":
        return grads, error_state
    if cfg.mode == "bf16":
        return pytree.tree_map(lambda g: g.to(torch.bfloat16), grads), \
            error_state
    if cfg.mode == "int8":
        leaves_g, spec = pytree.tree_flatten(grads)
        leaves_e = [None] * len(leaves_g) if error_state is None else \
            pytree.tree_leaves(error_state)
        qs, errs = [], []
        for g, e in zip(leaves_g, leaves_e):
            g32 = g.to(torch.float32)
            if e is not None:
                g32 = g32 + e
            scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
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
