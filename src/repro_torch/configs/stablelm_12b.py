"""stablelm-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=13824
vocab=100352 — partial rotary (25%), head_dim=160.
[hf:stabilityai/stablelm-2-1_6b; hf]"""
from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="stablelm-12b", family="dense",
    d_model=5120, n_layers=40, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=13824, vocab=100352,
    pattern=(LayerSpec("attn", "dense"),),
    rotary_pct=0.25,
)

SMOKE = ArchConfig(
    name="stablelm-12b-smoke", family="dense",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256,
    pattern=(LayerSpec("attn", "dense"),),
    rotary_pct=0.25,
)
