"""minicpm-2b [dense]: 40L d_model=2304 36H (MHA kv=36) d_ff=5760
vocab=122753 — llama-like with depth-scaled residuals; trained with the
WSD schedule (optim/schedules.py). [arXiv:2404.06395; hf]"""
import math

from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="minicpm-2b", family="dense",
    d_model=2304, n_layers=40, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab=122753,
    pattern=(LayerSpec("attn", "dense"),),
    residual_scale=1.4 / math.sqrt(40), tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="minicpm-2b-smoke", family="dense",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    pattern=(LayerSpec("attn", "dense"),),
    residual_scale=1.4 / math.sqrt(2), tie_embeddings=True,
)
