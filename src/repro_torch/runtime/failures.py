"""Failure handling: bounded retry around the train step (the JAX
package's ``repro.runtime.failures``).

A failed or preempted process resumes from the newest valid checkpoint on
boot (``launch/train.py``); a transient error inside a step is retried
here; the data pipeline is keyed by step, so a restart replays identical
batches.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

log = logging.getLogger("repro_torch.failures")


@dataclasses.dataclass(frozen=True)
class RetryConfig:
    max_retries: int = 3
    backoff_s: float = 1.0
    retryable: tuple = (RuntimeError,)


def run_with_retries(fn: Callable, cfg: RetryConfig = RetryConfig(),
                     on_failure: Callable = None, sleep: Callable = None):
    """Run fn(); on a retryable error call on_failure() (e.g. restore from
    a checkpoint) and retry with linear backoff.  Raises after max_retries.

    Contract:
      * ``on_failure`` is invoked exactly once per FAILED attempt —
        including the final one whose exception propagates;
      * backoff before retry k (1-based) is ``backoff_s * k`` and is paid
        only before attempts that actually happen (never after the last);
      * exceptions outside ``cfg.retryable`` propagate unwrapped
        immediately, with no on_failure call and no sleep;
      * success after k <= max_retries failures returns fn()'s value.

    ``sleep`` (default ``time.sleep``) is injectable so tests can observe
    the schedule without waiting it out.
    """
    if sleep is None:
        sleep = time.sleep
    attempt = 0
    while True:
        try:
            return fn()
        except cfg.retryable as e:
            attempt += 1
            if on_failure is not None:
                on_failure()
            if attempt > cfg.max_retries:
                raise
            log.warning("step failed (%s); retry %d/%d", e, attempt,
                        cfg.max_retries)
            sleep(cfg.backoff_s * attempt)
