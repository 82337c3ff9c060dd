"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="mixtral-8x7b", family="moe",
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    pattern=(LayerSpec("attn", "moe"),),
    window=4096, rope_theta=1e6,
    moe_experts=8, moe_top_k=2, moe_d_ff=14336,
)

SMOKE = ArchConfig(
    name="mixtral-8x7b-smoke", family="moe",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    pattern=(LayerSpec("attn", "moe"),),
    window=32, moe_experts=4, moe_top_k=2, moe_d_ff=128,
)
