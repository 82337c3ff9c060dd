"""Fault-tolerant training runtime: checkpoints, bounded retries, and the
elastic layout of a train state on a (different) mesh."""
from .checkpoint import Checkpointer
from .elastic import (NamedSharding, OwnedShard, full_leaf, mesh_shardings,
                      reshard_state, shard_leaf)
from .failures import RetryConfig, run_with_retries

__all__ = ["Checkpointer", "NamedSharding", "OwnedShard", "RetryConfig",
           "full_leaf", "mesh_shardings", "reshard_state",
           "run_with_retries", "shard_leaf"]
