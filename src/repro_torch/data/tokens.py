"""Deterministic synthetic LM tokens (numpy; the JAX package's
``synthetic_lm_batch``, copied so the port needs nothing of it)."""
from __future__ import annotations

import numpy as np


def synthetic_lm_batch(step: int, batch: int, seq_len: int, vocab: int,
                       seed: int = 0) -> dict:
    """Markov-ish synthetic tokens: t_{i+1} = (a*t_i + noise) % vocab."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    first = rng.integers(0, vocab, size=(batch, 1))
    mult = 6364136223846793005 % vocab or 1
    noise = rng.integers(0, 17, size=(batch, seq_len - 1))
    toks = [first]
    for i in range(seq_len - 1):
        nxt = (toks[-1] * mult + 7 + noise[:, i:i + 1]) % vocab
        toks.append(nxt)
    tokens = np.concatenate(toks, axis=1).astype(np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
