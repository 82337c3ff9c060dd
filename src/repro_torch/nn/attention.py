"""Attention blocks: GQA (with qk-norm, sliding window, partial rope).

Shapes: activations (B, S, d_model); heads layout (B, H, S, Dh) internally.
KV cache: {"k": (B, Smax, Hkv, Dh), "v": ...}, bfloat16 as a rule.  Prefill
and decode write the cache IN PLACE and return the same dict (the JAX
package returns an updated copy).  MLA (DeepSeek-V2) is not ported yet
(ROADMAP queue 1, item 13): ``AttnConfig`` keeps its fields so the configs
match the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from .common import dense_init
from .norm import init_rmsnorm, rmsnorm
from .rope import apply_rope, rope_freqs


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    window: Optional[int] = None
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0           # stablelm uses 0.25
    # MLA (deepseek) fields
    mla: bool = False
    kv_lora: int = 512
    q_lora: int = 0                    # 0 = no q compression (v2-lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


def init_gqa(generator: torch.Generator, cfg: AttnConfig,
             dtype: torch.dtype = torch.float32, device="cuda"):
    d, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init((d, H * Dh), dtype, generator, device),
        "wk": dense_init((d, Hkv * Dh), dtype, generator, device),
        "wv": dense_init((d, Hkv * Dh), dtype, generator, device),
        "wo": dense_init((H * Dh, d), dtype, generator, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(Dh, dtype, device)
        p["k_norm"] = init_rmsnorm(Dh, dtype, device)
    return p


def gqa_attention(p, x: torch.Tensor, cfg: AttnConfig, *, positions=None,
                  cache=None, pos: Optional[int] = None,
                  use_kernels: Optional[bool] = None, causal: bool = True):
    """x: (B, S, d).  Training/prefill when ``pos`` is None (prefill writes
    positions [0, S) of ``cache`` when one is given); decode when ``pos``
    (the new token's absolute position) is given with S == 1: the token's
    k/v are written at ``pos`` and attention runs against the cache.

    Returns (out, cache_or_None).
    """
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rd = int(Dh * cfg.rotary_pct)
    inv = rope_freqs(Dh, cfg.rope_theta, rd, device=x.device)

    q = (x @ p["wq"]).reshape(B, S, H, Dh)
    k = (x @ p["wk"]).reshape(B, S, Hkv, Dh)
    v = (x @ p["wv"]).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, use_kernels=use_kernels)
        k = rmsnorm(p["k_norm"], k, use_kernels=use_kernels)
    q = q.transpose(1, 2)   # (B,H,S,Dh) views
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    if pos is None:
        pp = positions if positions is not None else \
            torch.arange(S, device=x.device)
        q = apply_rope(q, pp, inv, rd)
        k = apply_rope(k, pp, inv, rd)
        if cache is not None:  # prefill: write into the cache buffer
            cache["k"][:, :S].copy_(k.transpose(1, 2))
            cache["v"][:, :S].copy_(v.transpose(1, 2))
        out = kops.attention(q, k, v, causal=causal, window=cfg.window,
                             q_offset=0, use_kernels=use_kernels)
    else:
        # decode: S == 1, append to the cache at index ``pos``
        ppos = torch.full((1,), pos, device=x.device)
        q = apply_rope(q, ppos, inv, rd)
        k = apply_rope(k, ppos, inv, rd)
        cache["k"][:, pos:pos + 1].copy_(k.transpose(1, 2))
        cache["v"][:, pos:pos + 1].copy_(v.transpose(1, 2))
        # decode: no head repeat; the cache stays in its dtype (see ref)
        out = kref.decode_attention_ref(q, cache["k"], cache["v"], pos,
                                        window=cfg.window)
    out = out.transpose(1, 2).reshape(B, S, H * Dh)
    return out @ p["wo"], cache


def init_gqa_cache(cfg: AttnConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, device="cuda"):
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, max_len, Hkv, Dh), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, Hkv, Dh), dtype=dtype,
                             device=device)}
