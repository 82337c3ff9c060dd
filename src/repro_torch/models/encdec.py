"""Encoder-decoder transformer (seamless-m4t style, audio frontend stubbed):
the JAX package's ``repro.models.encdec`` in PyTorch.

Encoder: a linear frontend over precomputed fbank-stacked frames (B, S_enc,
d_frontend), then a non-causal self-attention stack (no RoPE: the JAX
package rotates only causal attention).  Decoder: causal self-attention
(RoPE) + cross-attention over the encoder memory (no RoPE) + SwiGLU FFN.

Parameters: ``{"frontend", "enc_unit", "enc_norm", "embed", "dec_unit",
"dec_norm", "lm_head"}``, where ``enc_unit`` and ``dec_unit`` are lists of
per-layer dicts (the JAX package stacks each leaf over a leading L axis;
``params_from_jax`` unstacks it).

Tensor parallelism (training, ``tp``): the encoder and the decoder each
decide ``seq_carry`` on their own length; the frontend's column blocks are
joined, the attentions run on the rank's heads and a split SwiGLU on its
ffn columns (each through ``enter`` and ``leave``), the memory is entered
whole once for every decoder layer's cross-attention (its gradient, the
sum of the layers', summed over "model" once), and the lookup and the head
are vocab-parallel where "model" divides the vocab (256206 at 2; whole at
4).

Serving: the prefill encodes the source, precomputes every decoder
layer's cross K/V into the cache (in the cache dtype) and fills the
self-attention caches; decode advances one target token.  Caches, stacked
over the decoder layers as in the JAX package and written in place:
  {"self": {"k", "v": (L, B, Smax, H, Dh)},
   "cross": {"k", "v": (L, B, Senc, H, Dh)}}
As in the JAX package, the prefill's cross-attention reads the
precomputed K/V rounded to the cache dtype (cast to q's dtype), and a
decode step's cross-attention attends to every memory position
(``decode_attention_ref`` at position Senc - 1) against that cache.

The JAX package's decode step reaches its cross-attention with no memory
(``decode_forward(..., memory=None)``), which takes ``_mha``'s cached
self-attention branch instead: it projects the decoder token with the
cross weights, rotates q and k by RoPE at the decode position and writes
that k/v over the last memory position before it attends.  Here a decode
step's cross-attention is the memory route that the JAX package's
``_mha`` holds for it (reached there when a memory is passed): the
parity tests hold the port against that route (README, ROADMAP queue 3).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.nn.common import dense_init, embed_init, remat
from repro_torch.nn.mlp import init_swiglu, swiglu
from repro_torch.nn.norm import init_rmsnorm, rmsnorm
from repro_torch.nn.rope import apply_rope, rope_freqs
from .lm import _embed_tp, tensor_from_numpy

_MODES = ("train", "prefill", "decode")


def _init_attn(gen, d, H, Dh, dtype, device):
    return {"wq": dense_init((d, H * Dh), dtype, gen, device),
            "wk": dense_init((d, H * Dh), dtype, gen, device),
            "wv": dense_init((d, H * Dh), dtype, gen, device),
            "wo": dense_init((H * Dh, d), dtype, gen, device)}


def init_encdec(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                dtype: torch.dtype = torch.float32):
    """Random weights from ``seed`` (see ``models.lm.init_lm``; ``meta``
    gives the shapes alone)."""
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)
    d, H, Dh = cfg.d_model, cfg.n_heads, cfg.head_dim

    def enc_layer():
        return {"attn_norm": init_rmsnorm(d, dtype, device),
                "attn": _init_attn(gen, d, H, Dh, dtype, device),
                "ffn_norm": init_rmsnorm(d, dtype, device),
                "mlp": init_swiglu(gen, d, cfg.d_ff, dtype, device)}

    def dec_layer():
        return {"self_norm": init_rmsnorm(d, dtype, device),
                "self_attn": _init_attn(gen, d, H, Dh, dtype, device),
                "cross_norm": init_rmsnorm(d, dtype, device),
                "cross_attn": _init_attn(gen, d, H, Dh, dtype, device),
                "ffn_norm": init_rmsnorm(d, dtype, device),
                "mlp": init_swiglu(gen, d, cfg.d_ff, dtype, device)}

    return {
        "frontend": dense_init((cfg.d_frontend, d), dtype, gen, device),
        "enc_unit": [enc_layer() for _ in range(cfg.enc_layers)],
        "enc_norm": init_rmsnorm(d, dtype, device),
        "embed": embed_init((cfg.vocab, d), dtype, gen, device),
        "dec_unit": [dec_layer() for _ in range(cfg.n_layers)],
        "dec_norm": init_rmsnorm(d, dtype, device),
        "lm_head": dense_init((d, cfg.vocab), dtype, gen, device),
    }


def params_from_jax(np_tree, cfg: ArchConfig, *, device="cuda",
                    dtype: Optional[torch.dtype] = None):
    """The JAX package's ``init_encdec`` params (as numpy arrays) in this
    package's layout: the stacked ``enc_unit`` and ``dec_unit`` leaves
    split along their leading axis into per-layer dicts."""
    def to_t(a):
        return tensor_from_numpy(a, device=device, dtype=dtype)

    out = {k: pytree.tree_map(to_t, v) for k, v in np_tree.items()
           if k not in ("enc_unit", "dec_unit")}
    for key, n in (("enc_unit", cfg.enc_layers), ("dec_unit", cfg.n_layers)):
        out[key] = [pytree.tree_map(lambda a, i=i: to_t(a[i]), np_tree[key])
                    for i in range(n)]
    return out


def _mha(p, x: torch.Tensor, cfg: ArchConfig, *, kv=None,
         cross: bool = False, causal: bool, positions=None,
         pos: Optional[int] = None, cache=None):
    """Self-attention (``cross`` False and no ``kv``) or cross-attention.

    Self: training (no cache), prefill into ``cache`` {"k", "v": (B, Smax,
    H, Dh)} (``pos`` None), or one decode step at ``pos``.  Cross: against
    the memory ``kv`` (B, S_kv, d) (training), against the precomputed K/V
    in ``cache`` (prefill, S > 1), or one decode step against that cache
    (S == 1, every memory position).  Returns (out, cache)."""
    B, S, d = x.shape
    Dh = cfg.head_dim
    H = p["wq"].shape[-1] // Dh     # the rank's heads under tensor parallelism
    uk = cfg.use_kernels
    q = (x @ p["wq"]).reshape(B, S, H, Dh).transpose(1, 2)

    def heads(w, src):
        return (src @ w).reshape(B, src.shape[1], H, Dh).transpose(1, 2)

    if not cross and kv is None:
        inv = rope_freqs(Dh, cfg.rope_theta, device=x.device)
        k, v = heads(p["wk"], x), heads(p["wv"], x)
        if cache is None:                                # training
            pp = positions if positions is not None else \
                torch.arange(S, device=x.device)
            if causal:
                q, k = apply_rope(q, pp, inv), apply_rope(k, pp, inv)
            out = kops.attention(q, k, v, causal=causal, use_kernels=uk)
        elif pos is None:                                # prefill
            pp = torch.arange(S, device=x.device)
            q, k = apply_rope(q, pp, inv), apply_rope(k, pp, inv)
            cache["k"][:, :S].copy_(k.transpose(1, 2))
            cache["v"][:, :S].copy_(v.transpose(1, 2))
            out = kops.attention(q, k, v, causal=True, use_kernels=uk)
        else:                                            # decode
            ppos = torch.full((1,), pos, device=x.device)
            q, k = apply_rope(q, ppos, inv), apply_rope(k, ppos, inv)
            cache["k"][:, pos:pos + 1].copy_(k.transpose(1, 2))
            cache["v"][:, pos:pos + 1].copy_(v.transpose(1, 2))
            out = kref.decode_attention_ref(q, cache["k"], cache["v"], pos)
    elif cache is not None and S == 1:                   # decode vs memory
        out = kref.decode_attention_ref(q, cache["k"], cache["v"],
                                        cache["k"].shape[1] - 1)
    else:
        if cache is not None:                            # precomputed K/V
            k = cache["k"].transpose(1, 2).to(q.dtype)
            v = cache["v"].transpose(1, 2).to(q.dtype)
        else:
            k, v = heads(p["wk"], kv), heads(p["wv"], kv)
        out = kops.attention(q, k, v, causal=False, use_kernels=uk)
    out = out.transpose(1, 2).reshape(B, S, H * Dh) @ p["wo"]
    return out, cache


def _enter(tp, h):
    return h if tp is None else tp.enter(h)


def _leave(tp, y):
    return y if tp is None else tp.leave(y)


def _ffn(p, h, tp):
    """The SwiGLU, column / row split under ``tp`` when "model" divides
    d_ff, else whole on the rows the rank holds."""
    if tp is not None and tp.ffn_split:
        return tp.leave(swiglu(p, tp.enter(h)))
    return swiglu(p, h)


def _enc_layer(lp, x, cfg: ArchConfig, tp=None):
    eps, uk = cfg.norm_eps, cfg.use_kernels
    h = rmsnorm(lp["attn_norm"], x, eps=eps, use_kernels=uk)
    y, _ = _mha(lp["attn"], _enter(tp, h), cfg, causal=False)
    x = x + _leave(tp, y)
    h = rmsnorm(lp["ffn_norm"], x, eps=eps, use_kernels=uk)
    return x + _ffn(lp["mlp"], h, tp)


def encode(params, frames: torch.Tensor, cfg: ArchConfig,
           tp=None) -> torch.Tensor:
    """frames (B, S_enc, d_frontend) -> memory (B, S_enc, d).  ``tp`` (a
    ``parallel.tensor.TensorParallel`` decided on S_enc): the frontend's
    column blocks joined (``join_columns``), the layers on the rank's
    blocks, and the memory the rank's sequence block under ``seq_carry``
    (else whole)."""
    if tp is None:
        x = frames.to(params["frontend"].dtype) @ params["frontend"]
    else:           # the kernels take contiguous rows
        x = tp.rows(frames.to(params["frontend"].dtype)
                    @ tp.join_columns(params["frontend"])).contiguous()
    for lp in params["enc_unit"]:
        x = remat(lambda lp_, xx: _enc_layer(lp_, xx, cfg, tp), lp, x)
    return rmsnorm(params["enc_norm"], x, eps=cfg.norm_eps,
                   use_kernels=cfg.use_kernels)


def precompute_cross_kv(params, memory: torch.Tensor, cfg: ArchConfig):
    """Every decoder layer's cross-attention K and V of the memory,
    stacked: {"k", "v": (L, B, S_enc, H, Dh)} in the memory's dtype."""
    B, Se, _ = memory.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    ks, vs = [], []
    for lp in params["dec_unit"]:
        ks.append((memory @ lp["cross_attn"]["wk"]).reshape(B, Se, H, Dh))
        vs.append((memory @ lp["cross_attn"]["wv"]).reshape(B, Se, H, Dh))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def _dec_layer(lp, x, cfg: ArchConfig, memory, self_c, cross_c, positions,
               pos, tp=None):
    eps, uk = cfg.norm_eps, cfg.use_kernels
    h = rmsnorm(lp["self_norm"], x, eps=eps, use_kernels=uk)
    y, _ = _mha(lp["self_attn"], _enter(tp, h), cfg, causal=True,
                positions=positions, pos=pos, cache=self_c)
    x = x + _leave(tp, y)
    h = rmsnorm(lp["cross_norm"], x, eps=eps, use_kernels=uk)
    y, _ = _mha(lp["cross_attn"], _enter(tp, h), cfg, kv=memory, cross=True,
                causal=False, cache=cross_c)
    x = x + _leave(tp, y)
    h = rmsnorm(lp["ffn_norm"], x, eps=eps, use_kernels=uk)
    return x + _ffn(lp["mlp"], h, tp)


def decode_forward(params, cfg: ArchConfig, tokens: torch.Tensor, *,
                   memory=None, caches=None, pos: Optional[int] = None,
                   mode: str = "train", return_hidden: bool = False,
                   tp=None):
    """The decoder stack.  train: ``memory`` given, no caches (each layer
    recomputed in the backward); prefill: ``caches`` (cross K/V filled) and
    ``memory``, tokens from position 0; decode: ``caches`` and ``pos``,
    tokens (B, 1).

    ``tp`` (training; a ``parallel.tensor.TensorParallel`` decided on
    S_dec): the lookup vocab-parallel (``models.lm._embed_tp``), the layers
    on the rank's heads and ffn columns, the residual stream the rank's
    sequence block under ``seq_carry``; ``memory`` whole on every rank (the
    caller enters it: each layer's cross-attention projects K and V from
    all of it), and the head the rank's vocab block (``return_hidden``).

    Returns {"logits" (B, S, V) float32, "caches", "aux": 0.0}, or with
    return_hidden {"hidden", "head", "caches", "aux"}."""
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r} not in {_MODES}")
    if (mode == "train") != (caches is None) or \
            (mode == "decode") != (pos is not None) or \
            (mode == "train" and memory is None):
        raise ValueError(f"mode {mode!r}: caches are for prefill and decode "
                         f"only, pos for decode only, memory for training")
    if tp is not None and not return_hidden:
        raise ValueError("under tensor parallelism the head is the rank's "
                         "vocab block: ask for return_hidden (the loss is "
                         "vocab-parallel)")
    if tp is None:
        x = params["embed"][tokens]
        seq = x.shape[1]
    else:
        x = _embed_tp(params["embed"], tokens, tp)
        seq = tokens.shape[1]
    positions = torch.arange(seq, device=x.device) if pos is None else None
    for i, lp in enumerate(params["dec_unit"]):
        if caches is None:
            x = remat(lambda lp_, xx, mem: _dec_layer(
                lp_, xx, cfg, mem, None, None, positions, None, tp),
                lp, x, memory)
        else:
            self_c = {"k": caches["self"]["k"][i],
                      "v": caches["self"]["v"][i]}
            cross_c = {"k": caches["cross"]["k"][i],
                       "v": caches["cross"]["v"][i]}
            x = _dec_layer(lp, x, cfg, memory, self_c, cross_c, positions,
                           pos)
    x = rmsnorm(params["dec_norm"], x, eps=cfg.norm_eps,
                use_kernels=cfg.use_kernels)
    if return_hidden:
        return {"hidden": x, "head": params["lm_head"], "caches": caches,
                "aux": 0.0}
    return {"logits": (x @ params["lm_head"]).to(torch.float32),
            "caches": caches, "aux": 0.0}


def init_encdec_caches(cfg: ArchConfig, batch: int, max_len: int,
                       enc_len: int, dtype: torch.dtype = torch.bfloat16,
                       device="cuda"):
    L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.head_dim

    def zeros(S):
        return torch.zeros((L, batch, S, H, Dh), dtype=dtype, device=device)

    return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
            "cross": {"k": zeros(enc_len), "v": zeros(enc_len)}}
