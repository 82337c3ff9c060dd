"""Per-layer block dispatch: init / forward / cache-init for every mixer.

Mixers: ``attn`` (GQA), ``mla`` (DeepSeek-V2 latent attention), ``mamba``
(``nn/mamba.py``), ``mlstm`` and ``slstm`` (``nn/xlstm.py``); FFNs:
``dense`` (SwiGLU), ``moe`` (``nn/moe.py``) and ``none``.  The recurrent
mixers' caches are their states, float32 whatever the cache dtype (the
JAX package's rule); attention caches take the cache dtype.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.nn.attention import (gqa_attention, init_gqa, init_gqa_cache,
                                      init_mla, init_mla_cache, mla_attention)
from repro_torch.nn.mamba import (channel_split, init_mamba,
                                  init_mamba_state, mamba_forward)
from repro_torch.nn.mlp import init_swiglu, swiglu
from repro_torch.nn.moe import init_moe, moe_ffn
from repro_torch.nn.norm import init_rmsnorm, rmsnorm
from repro_torch.nn.xlstm import (init_mlstm, init_mlstm_state, init_slstm,
                                  init_slstm_state, mlstm_forward,
                                  slstm_forward)

_MIXERS = ("attn", "mla", "mamba", "mlstm", "slstm")
_FFNS = ("dense", "moe", "none")


def _check_spec(spec: LayerSpec):
    if spec.mixer not in _MIXERS or spec.ffn not in _FFNS:
        raise ValueError(f"unknown layer spec {spec}")


def init_layer(generator: torch.Generator, spec: LayerSpec, cfg: ArchConfig,
               dtype: torch.dtype = torch.float32, device="cuda"):
    _check_spec(spec)
    p = {"mixer_norm": init_rmsnorm(cfg.d_model, dtype, device)}
    if spec.mixer == "attn":
        p["attn"] = init_gqa(generator, cfg.attn_config(), dtype, device)
    elif spec.mixer == "mla":
        p["attn"] = init_mla(generator, cfg.attn_config(), dtype, device)
    elif spec.mixer == "mamba":
        p["mamba"] = init_mamba(generator, cfg.mamba_config(), dtype, device)
    elif spec.mixer == "mlstm":
        p["mlstm"] = init_mlstm(generator, cfg.xlstm_config(), dtype, device)
    else:
        p["slstm"] = init_slstm(generator, cfg.xlstm_config(), dtype, device)
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
    if spec.mixer == "attn":
        return init_gqa_cache(cfg.attn_config(), batch, max_len, dtype,
                              device)
    if spec.mixer == "mla":
        return init_mla_cache(cfg.attn_config(), batch, max_len, dtype,
                              device)
    if spec.mixer == "mamba":
        return init_mamba_state(cfg.mamba_config(), batch, device=device)
    if spec.mixer == "mlstm":
        return init_mlstm_state(cfg.xlstm_config(), batch, device=device)
    return init_slstm_state(cfg.xlstm_config(), batch, device=device)


def layer_forward(p, x: torch.Tensor, spec: LayerSpec, cfg: ArchConfig, *,
                  cache: Optional[Any] = None, pos: Optional[int] = None,
                  positions=None, causal: bool = True, tp=None,
                  aux_group=None):
    """Pre-norm residual block: x + mixer(norm(x)), then + ffn(norm(x)).

    Returns (x, cache, aux_loss); the aux loss is the MoE router's (a
    float32 scalar tensor), 0.0 for the other FFNs.  The recurrent mixers
    return a new state (S == 1 with a cache: one decode step; S > 1 with a
    cache: prefill); attention writes its cache in place.

    With ``tp`` (a ``parallel.tensor.TensorParallel``: training on a
    "model" axis) ``x`` is the rank's sequence block (``seq_carry``) or
    whole, the weights are the rank's blocks, and the attention (GQA or
    MLA), the recurrent mixers (Mamba by channel, the mLSTM and the sLSTM
    by head), a split SwiGLU and an MoE FFN (routed and shared experts
    together) take their input through ``enter`` and give their output
    through ``leave``; the norms run on the rows the rank holds.  A Mamba
    laid out whole runs whole on every rank (on the entered sequence under
    ``seq_carry``, keeping the rank's rows).
    ``aux_group``: the data ranks of a data-parallel step, over whose rows
    the MoE aux loss runs (``nn.moe.moe_ffn``)."""
    _check_spec(spec)
    eps = cfg.norm_eps
    uk = cfg.use_kernels
    rs = cfg.residual_scale
    h = rmsnorm(p["mixer_norm"], x, eps=eps, use_kernels=uk)
    if spec.mixer in ("attn", "mla"):
        attn = gqa_attention if spec.mixer == "attn" else mla_attention
        kw = {"causal": causal} if spec.mixer == "attn" else {}
        y, new_cache = attn(p["attn"], h if tp is None else tp.enter(h),
                            cfg.attn_config(), positions=positions,
                            cache=cache, pos=pos, use_kernels=uk, **kw)
        if tp is not None:
            y = tp.leave(y)
    elif spec.mixer == "mamba":
        mcfg = cfg.mamba_config()
        if tp is None:
            y, new_cache = mamba_forward(p["mamba"], h, mcfg, state=cache)
        elif channel_split(p["mamba"], mcfg):
            y, new_cache = mamba_forward(p["mamba"], tp.enter(h), mcfg,
                                         tp=tp)
            y = tp.leave(y)
        else:       # laid out whole: the whole layer, the rank's rows kept
            y, new_cache = mamba_forward(
                p["mamba"], tp.enter(h) if tp.seq_carry else h, mcfg)
            y = tp.rows(y)
    else:
        fwd = mlstm_forward if spec.mixer == "mlstm" else slstm_forward
        if tp is None:
            y, new_cache = fwd(p[spec.mixer], h, cfg.xlstm_config(),
                               state=cache)
        else:
            y, new_cache = fwd(p[spec.mixer], tp.enter(h),
                               cfg.xlstm_config(), tp=tp)
            y = tp.leave(y)
    x = x + rs * y
    aux = 0.0
    if spec.ffn != "none":
        h = rmsnorm(p["ffn_norm"], x, eps=eps, use_kernels=uk)
        if spec.ffn == "dense" and tp is not None and tp.ffn_split:
            y = tp.leave(swiglu(p["mlp"], tp.enter(h)))
        elif spec.ffn == "dense":
            y = swiglu(p["mlp"], h)
        elif tp is not None:
            y, aux = moe_ffn(p["moe"], tp.enter(h), cfg.moe_config(), tp,
                             aux_group)
            y = tp.leave(y)
        else:
            y, aux = moe_ffn(p["moe"], h, cfg.moe_config(),
                             aux_group=aux_group)
        x = x + rs * y
    return x, new_cache, aux
