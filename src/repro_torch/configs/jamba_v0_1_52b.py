"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2 — Mamba+attention 1:7 interleave (one
attention layer per 8-layer Jamba block, at index 4), MoE every 2 layers.
[arXiv:2403.19887; hf]"""
from .base import ArchConfig, LayerSpec


def _jamba_unit():
    unit = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        unit.append(LayerSpec(mixer, ffn))
    return tuple(unit)


FULL = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    pattern=_jamba_unit(),
    moe_experts=16, moe_top_k=2, moe_d_ff=14336,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
)

SMOKE = ArchConfig(
    name="jamba-v0.1-52b-smoke", family="hybrid",
    d_model=64, n_layers=8, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    pattern=_jamba_unit(),
    moe_experts=4, moe_top_k=2, moe_d_ff=64,
    mamba_d_state=8, mamba_d_conv=4, mamba_expand=2,
)
