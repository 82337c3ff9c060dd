from .losses import IGNORE, lm_loss, lm_loss_chunked
from .serve_step import make_decode_step, make_prefill_step
from .state import (TrainState, init_solver_stats, node_solver_counts,
                    train_state_from_jax)
from .train_step import (TrainConfig, init_train_state, loss_and_grads,
                         make_train_step)

__all__ = ["IGNORE", "lm_loss", "lm_loss_chunked", "TrainConfig",
           "TrainState", "make_train_step", "init_train_state",
           "init_solver_stats", "loss_and_grads", "node_solver_counts",
           "make_prefill_step", "make_decode_step", "train_state_from_jax"]
