"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — Qwen2-0.5B language backbone; the InternViT frontend is a
stub: the caller gives precomputed patch embeddings (B, 256, 1024), which a
linear projector maps into the token stream (models/lm.py, the "patch"
frontend). [arXiv:2404.16821; hf]"""
from .base import ArchConfig, LayerSpec

N_PATCHES = 256  # one 448x448 tile

FULL = ArchConfig(
    name="internvl2-1b", family="vlm",
    d_model=896, n_layers=24, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab=151655,
    pattern=(LayerSpec("attn", "dense"),),
    rope_theta=1e6,
    frontend="patch", d_frontend=1024, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="internvl2-1b-smoke", family="vlm",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    pattern=(LayerSpec("attn", "dense"),),
    frontend="patch", d_frontend=32, tie_embeddings=True,
)
