"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, head_dim=128, tied embeddings.
[hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="qwen3-1.7b", family="dense",
    d_model=2048, n_layers=28, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab=151936,
    pattern=(LayerSpec("attn", "dense"),),
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="qwen3-1.7b-smoke", family="dense",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab=256,
    pattern=(LayerSpec("attn", "dense"),),
    qk_norm=True, tie_embeddings=True,
)
