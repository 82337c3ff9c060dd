"""Losses: causal-LM cross entropy (float32 accumulation, ignore_index),
the JAX package's ``repro.train.losses``."""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import comm

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
                    labels: torch.Tensor, chunk: int = 512,
                    tp=None) -> torch.Tensor:
    """Cross entropy computed per sequence chunk: each (B, chunk, V) logits
    block is made, reduced and dropped, under ``torch.utils.checkpoint``,
    so the backward makes it again: the full (B, S, V) float32 logits never
    exist.

    hidden: (B, S, d) final normed hidden states; head: (d, V); labels
    (B, S).  The positions past S in the last chunk are IGNORE (as the JAX
    package pads them).

    With ``tp`` (a ``parallel.tensor.TensorParallel``) ``head`` is the
    rank's vocab block and ``hidden`` the rank's sequence block
    (``seq_carry``) or the whole: see ``_nll_sum_tp``."""
    count = torch.sum(labels != IGNORE)
    if tp is not None:
        return _nll_sum_tp(hidden, head, labels, chunk, tp) / torch.clamp(
            count, min=1)
    return _nll_sum(hidden, head, labels, chunk) / torch.clamp(count, min=1)


def _nll_sum(hidden, head, labels, chunk: int):
    """The summed negative log-likelihood, chunk by chunk (each under
    ``torch.utils.checkpoint`` when a gradient is taken)."""
    S = hidden.shape[1]
    chunk = min(chunk, S)
    total = None
    for c0 in range(0, S, chunk):
        xi = hidden[:, c0:c0 + chunk]
        li = labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_nll, xi, head, li, use_reentrant=False)
        else:
            part = _chunk_nll(xi, head, li)
        total = part if total is None else total + part
    return total


def _nll_sum_tp(hidden, head, labels, chunk: int, tp):
    """The tensor-parallel summed negative log-likelihood (the same value
    on every rank of "model").  With the vocab split, ``hidden`` is made
    whole on every rank (``enter``: its backward sums the ranks' partial
    gradients) and each chunk is ``_VocabParallelNLL``: one all_gather, a
    local backward.  With the head whole (a vocab "model" does not
    divide), each rank sums the chunks of its own rows, then the ranks'
    sums are summed under ``seq_carry`` (``reduce_from``)."""
    if not tp.vocab_split:
        total = _nll_sum(hidden, head, tp.rows(labels), chunk)
        return comm.reduce_from(total, tp.group) if tp.seq_carry else total
    h = tp.enter(hidden)
    S = h.shape[1]
    chunk = min(chunk, S)
    lo, _ = tp.vocab_block(head.shape[1])
    total = None
    for c0 in range(0, S, chunk):
        part = _VocabParallelNLL.apply(h[:, c0:c0 + chunk], head,
                                       labels[:, c0:c0 + chunk], lo,
                                       tp.group)
        total = part if total is None else total + part
    return total


class _VocabParallelNLL(torch.autograd.Function):
    """The summed negative log-likelihood of one chunk from the rank's
    vocab block of the logits, ``xi @ head`` (B, c, V / TP): per row the
    block's max m, its sum of exp(logit - m) and the target logit where the
    block holds the target (0 elsewhere) go round in one all_gather of the
    (3, B, c) stack; every rank then forms logz = M + log(sum_r s_r
    exp(m_r - M)) and the target logit (the sum over blocks, one of them
    non-zero) alike.  No MAX reduction is needed (``comm`` has none).

    The logits are not kept: the backward makes the block again from
    ``xi`` and ``head`` and forms (softmax - onehot) from the saved logz,
    all local (the sum over "model" of the input's gradient is the
    caller's ``enter`` region)."""

    @staticmethod
    def forward(ctx, xi, head, li, lo: int, group):
        acc = torch.promote_types(xi.dtype, torch.float32)
        logits = (xi @ head).to(acc)
        mask = li != IGNORE
        local = li - lo
        inside = mask & (local >= 0) & (local < head.shape[1])
        safe = torch.where(inside, local, torch.zeros_like(local)).long()
        m = torch.amax(logits, dim=-1)
        s = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0] * inside
        parts = comm.all_gather(torch.stack([m, s, gold]), group.group)
        st = torch.stack([parts[g] for g in group.order])
        mx = torch.amax(st[:, 0], dim=0)
        logz = mx + torch.log(torch.sum(st[:, 1] * torch.exp(st[:, 0] - mx),
                                        dim=0))
        gold = torch.sum(st[:, 2], dim=0)
        ctx.save_for_backward(xi, head, logz, safe, inside, mask)
        return torch.sum((logz - gold) * mask)

    @staticmethod
    def backward(ctx, g):
        xi, head, logz, safe, inside, mask = ctx.saved_tensors
        acc = logz.dtype
        d = torch.exp((xi @ head).to(acc) - logz[..., None])
        d = d.scatter_add(-1, safe[..., None], -inside[..., None].to(acc))
        d = (d * (mask[..., None] * g)).to(xi.dtype)
        dxi = d @ head.t()
        dhead = xi.reshape(-1, xi.shape[-1]).t() @ d.reshape(-1, d.shape[-1])
        return dxi, dhead, None, None, None
