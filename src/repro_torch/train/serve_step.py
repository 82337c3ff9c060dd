"""Serving steps for the decoder-only LM: prefill (build the caches, return
the last position's logits) and decode (one token against the caches).
The enc-dec model's steps come with it (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import init_caches, lm_forward


def _check(arch: ArchConfig):
    if arch.encdec:
        raise NotImplementedError(
            f"{arch.name}: enc-dec serving is not ported yet (ROADMAP queue "
            f"1, item 13)")


def make_prefill_step(arch: ArchConfig, batch: int, max_len: int,
                      cache_dtype: torch.dtype = torch.bfloat16):
    """prefill(params, {"tokens": (batch, S)}) -> (logits (batch, 1, V)
    float32, caches of ``max_len`` positions on the tokens' device)."""
    _check(arch)

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
    caches); the caches are updated in place."""
    _check(arch)

    @torch.no_grad()
    def decode(params, caches, token, pos: int):
        out = lm_forward(params, arch, token, caches=caches, pos=pos,
                         mode="decode")
        return out["logits"], out["caches"]
    return decode
