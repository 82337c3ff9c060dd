from .adamw import AdamWConfig, adamw_init, adamw_update
from .clip import clip_by_global_norm, global_norm
from .compress import (CompressionConfig, compress_grads, decompress_grads,
                       init_error_state)
from .schedules import constant_schedule, cosine_schedule, wsd_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "wsd_schedule", "constant_schedule", "clip_by_global_norm",
           "global_norm", "compress_grads", "decompress_grads",
           "CompressionConfig", "init_error_state"]
