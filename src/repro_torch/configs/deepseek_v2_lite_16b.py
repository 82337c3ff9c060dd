"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (MLA kv_lora=512)
vocab=102400, MoE 64 routed experts top-6 + 2 shared, per-expert d_ff=1408.
First layer uses a dense FFN (d_ff=10944), per the HF config.
[arXiv:2405.04434; hf]

64 routed experts is the v2-LITE config (160 routed is full V2), with 2
shared experts.  Field for field the JAX package's config.
"""
from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    d_model=2048, n_layers=27, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab=102400,
    prefix=(LayerSpec("mla", "dense"),),
    pattern=(LayerSpec("mla", "moe"),),
    mla_kv_lora=512, mla_rope_dim=64, mla_nope_dim=128, mla_v_dim=128,
    moe_experts=64, moe_top_k=6, moe_d_ff=1408,
    moe_shared=2, moe_shared_d_ff=2816,
)

SMOKE = ArchConfig(
    name="deepseek-v2-lite-16b-smoke", family="moe",
    d_model=64, n_layers=3, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    prefix=(LayerSpec("mla", "dense"),),
    pattern=(LayerSpec("mla", "moe"),),
    mla_kv_lora=32, mla_rope_dim=8, mla_nope_dim=16, mla_v_dim=16,
    moe_experts=8, moe_top_k=2, moe_d_ff=32, moe_shared=2,
    moe_shared_d_ff=64,
)
