"""seamless-m4t-medium [audio]: enc-dec, 12L each side, d_model=1024 16H
(MHA) d_ff=4096 vocab=256206 — the speech frontend is a stub: the input
is precomputed fbank-stacked frames (B, S, 160), which a linear frontend
projects to d_model.
[arXiv:2308.11596; hf]"""
from .base import ArchConfig, LayerSpec

FULL = ArchConfig(
    name="seamless-m4t-medium", family="audio",
    d_model=1024, n_layers=12, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=256206,
    pattern=(LayerSpec("attn", "dense"),),
    encdec=True, enc_layers=12,
    frontend="audio", d_frontend=160,
)

SMOKE = ArchConfig(
    name="seamless-m4t-medium-smoke", family="audio",
    d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=256,
    pattern=(LayerSpec("attn", "dense"),),
    encdec=True, enc_layers=2,
    frontend="audio", d_frontend=16,
)
