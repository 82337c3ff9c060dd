"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 — qk_norm, head_dim=128 (projected above d_model), tied.
[hf:Qwen/Qwen3-8B; hf]"""
from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="qwen3-0.6b", family="dense",
    d_model=1024, n_layers=28, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab=151936,
    pattern=(LayerSpec("attn", "dense"),),
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="qwen3-0.6b-smoke", family="dense",
    d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=128,
    pattern=(LayerSpec("attn", "dense"),),
    qk_norm=True, tie_embeddings=True,
)
