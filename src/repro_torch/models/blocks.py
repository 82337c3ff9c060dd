"""Per-layer block dispatch: init / forward / cache-init.

Ported mixers: ``attn`` (GQA) and ``mla`` (DeepSeek-V2 latent attention);
FFNs: ``dense`` (SwiGLU), ``moe`` (``nn/moe.py``) and ``none``.  The
recurrent mixers (``mamba``, ``mlstm``, ``slstm``) raise
``NotImplementedError`` naming ROADMAP queue 1, item 13.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.nn.attention import (gqa_attention, init_gqa, init_gqa_cache,
                                      init_mla, init_mla_cache, mla_attention)
from repro_torch.nn.mlp import init_swiglu, swiglu
from repro_torch.nn.moe import init_moe, moe_ffn
from repro_torch.nn.norm import init_rmsnorm, rmsnorm

_MIXERS = ("attn", "mla", "mamba", "mlstm", "slstm")
_FFNS = ("dense", "moe", "none")
_PORTED_MIXERS = ("attn", "mla")


def _check_spec(spec: LayerSpec):
    if spec.mixer not in _MIXERS or spec.ffn not in _FFNS:
        raise ValueError(f"unknown layer spec {spec}")
    if spec.mixer not in _PORTED_MIXERS:
        raise NotImplementedError(
            f"layer {spec} is not ported to repro_torch yet (ROADMAP queue "
            f"1, item 13: Mamba, xLSTM); the mixers "
            f"{_PORTED_MIXERS} are")


def init_layer(generator: torch.Generator, spec: LayerSpec, cfg: ArchConfig,
               dtype: torch.dtype = torch.float32, device="cuda"):
    _check_spec(spec)
    init_mixer = init_gqa if spec.mixer == "attn" else init_mla
    p = {"mixer_norm": init_rmsnorm(cfg.d_model, dtype, device),
         "attn": init_mixer(generator, cfg.attn_config(), dtype, device)}
    if spec.ffn != "none":
        p["ffn_norm"] = init_rmsnorm(cfg.d_model, dtype, device)
        if spec.ffn == "dense":
            p["mlp"] = init_swiglu(generator, cfg.d_model, cfg.d_ff, dtype,
                                   device)
        else:
            p["moe"] = init_moe(generator, cfg.moe_config(), dtype, device)
    return p


def init_layer_cache(spec: LayerSpec, cfg: ArchConfig, batch: int,
                     max_len: int, dtype: torch.dtype = torch.bfloat16,
                     device="cuda"):
    _check_spec(spec)
    init = init_gqa_cache if spec.mixer == "attn" else init_mla_cache
    return init(cfg.attn_config(), batch, max_len, dtype, device)


def layer_forward(p, x: torch.Tensor, spec: LayerSpec, cfg: ArchConfig, *,
                  cache: Optional[Any] = None, pos: Optional[int] = None,
                  positions=None, causal: bool = True):
    """Pre-norm residual block: x + mixer(norm(x)), then + ffn(norm(x)).

    Returns (x, cache, aux_loss); the aux loss is the MoE router's (a
    float32 scalar tensor), 0.0 for the other FFNs."""
    _check_spec(spec)
    eps = cfg.norm_eps
    uk = cfg.use_kernels
    rs = cfg.residual_scale
    h = rmsnorm(p["mixer_norm"], x, eps=eps, use_kernels=uk)
    if spec.mixer == "attn":
        y, new_cache = gqa_attention(p["attn"], h, cfg.attn_config(),
                                     positions=positions, cache=cache,
                                     pos=pos, use_kernels=uk, causal=causal)
    else:
        y, new_cache = mla_attention(p["attn"], h, cfg.attn_config(),
                                     positions=positions, cache=cache,
                                     pos=pos, use_kernels=uk)
    x = x + rs * y
    aux = 0.0
    if spec.ffn != "none":
        h = rmsnorm(p["ffn_norm"], x, eps=eps, use_kernels=uk)
        if spec.ffn == "dense":
            y = swiglu(p["mlp"], h)
        else:
            y, aux = moe_ffn(p["moe"], h, cfg.moe_config())
        x = x + rs * y
    return x, new_cache, aux
