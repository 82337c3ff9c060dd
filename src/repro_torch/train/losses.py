"""Losses: causal-LM cross entropy (float32 accumulation, ignore_index),
the JAX package's ``repro.train.losses``."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

IGNORE = -100


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) float; labels (B, S) integer (IGNORE masked).  Mean
    negative log-likelihood over the unmasked positions, in
    promote(logits.dtype, float32)."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    mask = labels != IGNORE
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    lf = logits.to(acc)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)


def _chunk_nll(xi: torch.Tensor, head: torch.Tensor, li: torch.Tensor):
    acc = torch.promote_types(xi.dtype, torch.float32)
    logits = (xi @ head).to(acc)
    mask = li != IGNORE
    safe = torch.where(mask, li, torch.zeros_like(li)).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.sum((logz - gold) * mask)


def lm_loss_chunked(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """Cross entropy computed per sequence chunk: each (B, chunk, V) logits
    block is made, reduced and dropped, under ``torch.utils.checkpoint``,
    so the backward makes it again: the full (B, S, V) float32 logits never
    exist.

    hidden: (B, S, d) final normed hidden states; head: (d, V); labels
    (B, S).  The positions past S in the last chunk are IGNORE (as the JAX
    package pads them)."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    total = None
    count = torch.sum(labels != IGNORE)
    for c0 in range(0, S, chunk):
        xi = hidden[:, c0:c0 + chunk]
        li = labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_nll, xi, head, li, use_reentrant=False)
        else:
            part = _chunk_nll(xi, head, li)
        total = part if total is None else total + part
    return total / torch.clamp(count, min=1)
