"""Serving steps: prefill (build the caches, return the last position's
logits) and decode (one token against the caches), for the decoder-only
LM, the VLM (its patches go into the prefill, "patch_embeds") and the
enc-dec model (the source frames go into the prefill, "frames": encoder
memory and every decoder layer's cross K/V precomputed into the cache).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.encdec import (decode_forward, encode,
                                       init_encdec_caches,
                                       precompute_cross_kv)
from repro_torch.models.lm import init_caches, lm_forward


def make_prefill_step(arch: ArchConfig, batch: int, max_len: int,
                      cache_dtype: torch.dtype = torch.bfloat16):
    """prefill(params, {"tokens": (batch, S)[, "patch_embeds": (batch, P,
    d_frontend)][, "frames": (batch, S_enc, d_frontend)]}) -> (logits
    (batch, 1, V) float32, caches of ``max_len`` positions on the tokens'
    device).  With the patch frontend the P patches fill cache positions
    [0, P) and the tokens [P, P + S), so ``max_len`` counts them and
    decode starts at P + S.  The enc-dec model takes "frames" (its cross
    caches hold S_enc positions)."""
    if arch.encdec:
        @torch.no_grad()
        def prefill_encdec(params, batch_inputs):
            frames, tokens = batch_inputs["frames"], batch_inputs["tokens"]
            memory = encode(params, frames, arch)
            caches = init_encdec_caches(arch, batch, max_len,
                                        frames.shape[1], cache_dtype,
                                        device=tokens.device)
            cross = precompute_cross_kv(params, memory, arch)
            for name in ("k", "v"):
                caches["cross"][name].copy_(cross[name])
            del cross
            out = decode_forward(params, arch, tokens, memory=memory,
                                 caches=caches, mode="prefill",
                                 return_hidden=True)
            # the head on the LAST position only: never the (B, S, V)
            # prefill logits (V is 256206 for seamless-m4t-medium)
            logits = (out["hidden"][:, -1:] @ out["head"]).to(torch.float32)
            return logits, out["caches"]
        return prefill_encdec

    @torch.no_grad()
    def prefill(params, batch_inputs):
        tokens = batch_inputs["tokens"]
        caches = init_caches(arch, batch, max_len, cache_dtype,
                             device=tokens.device)
        out = lm_forward(params, arch, tokens, caches=caches,
                         extra_embeds=batch_inputs.get("patch_embeds"),
                         mode="prefill", return_hidden=True)
        # head applied to the LAST position only — never materialize the
        # (B, S, V) prefill logits
        logits = (out["hidden"][:, -1:] @ out["head"]).to(torch.float32)
        return logits, out["caches"]
    return prefill


def make_decode_step(arch: ArchConfig):
    """decode(params, caches, token (B, 1), pos) -> (logits (B, 1, V),
    caches); attention caches are updated in place, recurrent states
    replaced in the returned caches."""
    forward = decode_forward if arch.encdec else lm_forward

    @torch.no_grad()
    def decode(params, caches, token, pos: int):
        out = forward(params, arch, token, caches=caches, pos=pos,
                      mode="decode")
        return out["logits"], out["caches"]
    return decode
