"""Attention blocks: GQA (with qk-norm, sliding window, partial rope), MLA.

Shapes: activations (B, S, d_model); heads layout (B, H, S, Dh) internally.
KV caches, bfloat16 as a rule: GQA {"k": (B, Smax, Hkv, Dh), "v": ...};
MLA {"ckv": (B, Smax, kv_lora), "kr": (B, Smax, rope_dim)} (the compressed
latent, DeepSeek-V2's memory win; decode runs the absorbed formulation
against it).  Prefill and decode write the caches IN PLACE and return the
same dict (the JAX package returns an updated copy).
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
    Dh = cfg.head_dim
    # the heads of this rank's column blocks of wq / wk (all of them on one
    # device; H / TP and Hkv / TP under tensor parallelism, each q head with
    # its kv group)
    H, Hkv = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def init_mla(generator: torch.Generator, cfg: AttnConfig,
             dtype: torch.dtype = torch.float32, device="cuda"):
    d, H = cfg.d_model, cfg.n_heads
    qd = cfg.nope_head_dim + cfg.rope_head_dim
    return {
        "wq": dense_init((d, H * qd), dtype, generator, device),
        "wdkv": dense_init((d, cfg.kv_lora), dtype, generator, device),
        "kv_norm": init_rmsnorm(cfg.kv_lora, dtype, device),
        "wuk": dense_init((cfg.kv_lora, H * cfg.nope_head_dim), dtype,
                          generator, device),
        "wuv": dense_init((cfg.kv_lora, H * cfg.v_head_dim), dtype,
                          generator, device),
        "wkr": dense_init((d, cfg.rope_head_dim), dtype, generator, device),
        "wo": dense_init((H * cfg.v_head_dim, d), dtype, generator, device),
    }


def mla_attention(p, x: torch.Tensor, cfg: AttnConfig, *, positions=None,
                  cache=None, pos: Optional[int] = None,
                  use_kernels: Optional[bool] = None):
    """DeepSeek-V2 MLA.  Prefill (``pos`` None) makes the per-head K
    (nope + rope, dn + dr wide) and V (dv wide) from the latent and attends
    with the plain ``attention_ref`` at scale (dn + dr)^-1/2, as the JAX
    package does (q.k and v differ in width, which the flash kernel does not
    take), over the un-rounded latent; a given cache gets positions [0, S)
    of the latent and the rotated key.  Decode (``pos`` given, S == 1)
    writes the token's latent at ``pos`` and attends in float32 against the
    cache with the absorbed formulation: q_nope is taken through wuk into
    the latent space, and the latent output through wuv.

    Under tensor parallelism (training) ``wq``, ``wuk`` and ``wuv`` are
    the rank's column blocks (whole heads) and ``wo`` its rows: the rank
    attends with its heads; the latent and the rotated key (``wdkv``,
    ``kv_norm``, ``wkr``, whole) are computed alike on every rank.

    Returns (out, cache_or_None)."""
    B, S, _ = x.shape
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    # the heads of this rank's column block of wq (all of them on one
    # device)
    H = p["wq"].shape[-1] // (dn + dr)
    inv = rope_freqs(dr, cfg.rope_theta, dr, device=x.device)
    scale = (dn + dr) ** -0.5

    q = (x @ p["wq"]).reshape(B, S, H, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv = rmsnorm(p["kv_norm"], x @ p["wdkv"], use_kernels=use_kernels)
    kr = (x @ p["wkr"]).reshape(B, S, 1, dr).transpose(1, 2)

    if pos is None:
        pp = positions if positions is not None else \
            torch.arange(S, device=x.device)
        q_rope = apply_rope(q_rope, pp, inv)
        kr = apply_rope(kr, pp, inv)
        k_nope = (ckv @ p["wuk"]).reshape(B, S, H, dn).transpose(1, 2)
        v = (ckv @ p["wuv"]).reshape(B, S, H, dv).transpose(1, 2)
        k = torch.cat([k_nope, kr.expand(B, H, S, dr)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = kref.attention_ref(qq, k, v, causal=True, q_offset=0,
                                 scale=scale)
        if cache is not None:
            cache["ckv"][:, :S].copy_(ckv)
            cache["kr"][:, :S].copy_(kr[:, 0])
    else:
        ppos = torch.full((1,), pos, device=x.device)
        q_rope = apply_rope(q_rope, ppos, inv)
        kr = apply_rope(kr, ppos, inv)
        cache["ckv"][:, pos:pos + 1].copy_(ckv)
        cache["kr"][:, pos:pos + 1].copy_(kr[:, 0])
        f32 = torch.float32
        lat_cache = cache["ckv"].to(f32)                   # (B, Smax, dl)
        rot_cache = cache["kr"].to(f32)                    # (B, Smax, dr)
        wuk = p["wuk"].reshape(cfg.kv_lora, H, dn).to(f32)
        q_abs = torch.einsum("bhsd,lhd->bhsl", q_nope.to(f32), wuk)
        s = (torch.matmul(q_abs, lat_cache.transpose(1, 2)[:, None])
             + torch.matmul(q_rope.to(f32),
                            rot_cache.transpose(1, 2)[:, None])) * scale
        kpos = torch.arange(lat_cache.shape[1], device=x.device)
        s = s.masked_fill(kpos > pos, float("-inf"))
        pr = torch.softmax(s, dim=-1)
        lat = torch.matmul(pr, lat_cache[:, None])         # (B, H, 1, dl)
        wuv = p["wuv"].reshape(cfg.kv_lora, H, dv).to(f32)
        out = torch.einsum("bhsl,lhd->bhsd", lat, wuv).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, S, H * dv)
    return out @ p["wo"], cache


def init_mla_cache(cfg: AttnConfig, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16, device="cuda"):
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora), dtype=dtype,
                               device=device),
            "kr": torch.zeros((batch, max_len, cfg.rope_head_dim),
                              dtype=dtype, device=device)}
