"""Per-layer block dispatch: init / forward / cache-init.

Ported: ``LayerSpec("attn", "dense")`` (GQA + SwiGLU).  Every other mixer
or FFN raises ``NotImplementedError`` naming ROADMAP queue 1, item 13.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.nn.attention import gqa_attention, init_gqa, init_gqa_cache
from repro_torch.nn.mlp import init_swiglu, swiglu
from repro_torch.nn.norm import init_rmsnorm, rmsnorm

_MIXERS = ("attn", "mla", "mamba", "mlstm", "slstm")
_FFNS = ("dense", "moe", "none")


def _check_spec(spec: LayerSpec):
    if spec.mixer not in _MIXERS or spec.ffn not in _FFNS:
        raise ValueError(f"unknown layer spec {spec}")
    if spec.mixer != "attn" or spec.ffn != "dense":
        raise NotImplementedError(
            f"layer {spec} is not ported to repro_torch yet (ROADMAP queue "
            f"1, item 13: MLA, MoE, Mamba, xLSTM); only "
            f"LayerSpec('attn', 'dense') is")


def init_layer(generator: torch.Generator, spec: LayerSpec, cfg: ArchConfig,
               dtype: torch.dtype = torch.float32, device="cuda"):
    _check_spec(spec)
    return {
        "mixer_norm": init_rmsnorm(cfg.d_model, dtype, device),
        "attn": init_gqa(generator, cfg.attn_config(), dtype, device),
        "ffn_norm": init_rmsnorm(cfg.d_model, dtype, device),
        "mlp": init_swiglu(generator, cfg.d_model, cfg.d_ff, dtype, device),
    }


def init_layer_cache(spec: LayerSpec, cfg: ArchConfig, batch: int,
                     max_len: int, dtype: torch.dtype = torch.bfloat16,
                     device="cuda"):
    _check_spec(spec)
    return init_gqa_cache(cfg.attn_config(), batch, max_len, dtype, device)


def layer_forward(p, x: torch.Tensor, spec: LayerSpec, cfg: ArchConfig, *,
                  cache: Optional[Any] = None, pos: Optional[int] = None,
                  positions=None, causal: bool = True):
    """Pre-norm residual block: x + mixer(norm(x)), then + ffn(norm(x)).

    Returns (x, cache, aux_loss); the dense FFN's aux loss is 0.0."""
    _check_spec(spec)
    eps = cfg.norm_eps
    uk = cfg.use_kernels
    rs = cfg.residual_scale
    h = rmsnorm(p["mixer_norm"], x, eps=eps, use_kernels=uk)
    y, new_cache = gqa_attention(p["attn"], h, cfg.attn_config(),
                                 positions=positions, cache=cache, pos=pos,
                                 use_kernels=uk, causal=causal)
    x = x + rs * y
    h = rmsnorm(p["ffn_norm"], x, eps=eps, use_kernels=uk)
    x = x + rs * swiglu(p["mlp"], h)
    return x, new_cache, 0.0
