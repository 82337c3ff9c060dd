"""Decoder-only LM over a layer pattern (the dense GQA layers so far).

Depth structure: optional prefix layers followed by ``n_repeats`` copies of
the repeating ``pattern`` unit, run by a plain Python loop (the JAX package
scans over stacked unit params).

Parameters: ``{"embed", "final_norm", ["lm_head"], ["prefix_<i>"],
"unit"}`` where ``unit`` is a list of ``n_repeats`` tuples, one layer dict
per pattern entry (the JAX package stacks each leaf over a leading R axis
instead; ``params_from_jax`` unstacks it).  Caches likewise:
``{"prefix": [...], "unit": [tuple of per-layer caches] * R}``.

Modes: ``"train"`` runs the discrete residual stack forward (no caches;
the kernels have no backward yet, so gradients are the plain versions'
business, ROADMAP queue 1 item 14); ``"prefill"`` fills the cache buffers
in place and returns the logits; ``"decode"`` advances one token at
position ``pos``.  Node mode (the paper's depth-time ODE) is the training
slice's (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
from repro_torch.nn.common import dense_init, embed_init
from repro_torch.nn.norm import init_rmsnorm, rmsnorm
from .blocks import init_layer, init_layer_cache, layer_forward

_MODES = ("train", "prefill", "decode")


def _check_ported(cfg: ArchConfig):
    if cfg.encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the enc-dec model and the audio/patch frontends "
            f"are not ported yet (ROADMAP queue 1, item 13)")


def init_lm(cfg: ArchConfig, *, seed: int = 0, device="cuda",
            dtype: torch.dtype = torch.float32):
    """Random weights from ``seed``, drawn by a generator on ``device`` (so
    full-width weights are made on the card; a CPU device gives the same
    weights on every machine)."""
    _check_ported(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict = {
        "embed": embed_init((cfg.vocab, cfg.d_model), dtype, gen, device),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((cfg.d_model, cfg.vocab), dtype, gen,
                                       device)
    for i, spec in enumerate(cfg.prefix):
        params[f"prefix_{i}"] = init_layer(gen, spec, cfg, dtype, device)
    params["unit"] = [tuple(init_layer(gen, spec, cfg, dtype, device)
                            for spec in cfg.pattern)
                      for _ in range(cfg.n_repeats)]
    return params


def init_caches(cfg: ArchConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16, device="cuda"):
    return {
        "prefix": [init_layer_cache(s, cfg, batch, max_len, dtype, device)
                   for s in cfg.prefix],
        "unit": [tuple(init_layer_cache(s, cfg, batch, max_len, dtype,
                                        device) for s in cfg.pattern)
                 for _ in range(cfg.n_repeats)],
    }


def params_from_jax(np_tree, cfg: ArchConfig, *, device="cuda",
                    dtype: Optional[torch.dtype] = None):
    """The JAX package's ``init_lm`` params (as numpy arrays, e.g. after
    ``tree_map(np.asarray, params)``) in this package's layout: the stacked
    ``unit`` leaves are split along their leading R axis into a list of R
    per-unit tuples.  Tensors land on ``device`` (dtype kept unless given).
    """
    def to_t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    out = {k: pytree.tree_map(to_t, v) for k, v in np_tree.items()
           if k != "unit"}
    out["unit"] = [tuple(pytree.tree_map(lambda a, r=r: to_t(a[r]), layer)
                         for layer in np_tree["unit"])
                   for r in range(cfg.n_repeats)]
    return out


def _head_parts(params, cfg: ArchConfig, x: torch.Tensor):
    x = rmsnorm(params["final_norm"], x, eps=cfg.norm_eps,
                use_kernels=cfg.use_kernels)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return x, head


def lm_forward(params, cfg: ArchConfig, tokens: torch.Tensor, *,
               caches=None, pos: Optional[int] = None, extra_embeds=None,
               mode: str = "train", return_hidden: bool = False):
    """Returns {"logits", "caches", "aux"} — or, with return_hidden=True,
    {"hidden", "head", "caches", "aux"} so the caller can apply the head to
    the positions it needs without the full (B, S, V) logits.

    tokens: (B, S) integer tensor; mode: "train" (no caches), "prefill"
    (fill ``caches`` from position 0), "decode" (tokens (B, 1), write and
    attend at ``pos``)."""
    _check_ported(cfg)
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r} not in {_MODES}")
    if extra_embeds is not None:
        raise NotImplementedError("extra_embeds (the VLM patch frontend) is "
                                  "not ported yet (ROADMAP queue 1, item 13)")
    if cfg.node.mode == "node":
        raise NotImplementedError(
            "node mode (the depth-time ODE trained with the symplectic "
            "adjoint) is the LM training slice (ROADMAP queue 1, item 14)")
    if (mode == "train") != (caches is None) or \
            (mode == "decode") != (pos is not None):
        raise ValueError(f"mode {mode!r}: caches are required for prefill "
                         f"and decode only, pos for decode only")

    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device) \
        if pos is None else None
    aux = 0.0
    new_prefix = []
    for i, spec in enumerate(cfg.prefix):
        c = None if caches is None else caches["prefix"][i]
        x, nc, a = layer_forward(params[f"prefix_{i}"], x, spec, cfg,
                                 cache=c, pos=pos, positions=positions)
        new_prefix.append(nc)
        aux = aux + a
    new_unit = []
    for r, unit in enumerate(params["unit"]):
        unit_caches = None if caches is None else caches["unit"][r]
        ncs = []
        for i, spec in enumerate(cfg.pattern):
            c = None if unit_caches is None else unit_caches[i]
            x, nc, a = layer_forward(unit[i], x, spec, cfg, cache=c, pos=pos,
                                     positions=positions)
            ncs.append(nc)
            aux = aux + a
        new_unit.append(tuple(ncs))

    new_caches = None if caches is None else \
        {"prefix": new_prefix, "unit": new_unit}
    h, head = _head_parts(params, cfg, x)
    if return_hidden:
        return {"hidden": h, "head": head, "caches": new_caches, "aux": aux}
    return {"logits": (h @ head).to(torch.float32), "caches": new_caches,
            "aux": aux}
