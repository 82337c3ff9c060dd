"""Deterministic synthetic LM tokens (numpy; the JAX package's
``synthetic_lm_batch`` and ``TokenPipeline``, copied so the port needs
nothing of it).

``TokenPipeline`` is an infinite iterator of host batches keyed by (step,
host_id), so a restart at a saved data cursor replays the exact sample
stream (the fault-tolerance path of ``launch/train.py`` relies on it);
each batch lands on the requested device as int64 tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


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


@dataclasses.dataclass
class TokenPipeline:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    start_step: int = 0
    device: str = "cpu"

    def __iter__(self) -> Iterator[dict]:
        step = self.start_step
        per_host = self.global_batch // self.n_hosts
        while True:
            b = synthetic_lm_batch(step * self.n_hosts + self.host_id,
                                   per_host, self.seq_len + 1, self.vocab,
                                   self.seed)
            yield {k: torch.as_tensor(v, dtype=torch.long).to(self.device)
                   for k, v in b.items()}
            step += 1
