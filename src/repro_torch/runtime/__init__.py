"""Fault-tolerant training runtime: checkpoints and bounded retries.  The
elastic resharding of the JAX package (``runtime/elastic.py``) comes with
the multi-card slice (ROADMAP queue 1, item 15)."""
from .checkpoint import Checkpointer
from .failures import RetryConfig, run_with_retries

__all__ = ["Checkpointer", "RetryConfig", "run_with_retries"]
