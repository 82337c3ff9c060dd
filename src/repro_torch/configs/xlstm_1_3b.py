"""xlstm-1.3b [ssm]: 48L d_model=2048 4H vocab=50304 — mLSTM + sLSTM
blocks at the paper's 7:1 ratio (sLSTM every 8th block); no separate FFN
(both blocks carry internal up/down projections).
[arXiv:2405.04517; unverified]"""
from .base import ArchConfig, LayerSpec

_UNIT = tuple([LayerSpec("mlstm", "none")] * 7 + [LayerSpec("slstm", "none")])

FULL = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    d_model=2048, n_layers=48, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304,
    pattern=_UNIT,
    xlstm_heads=4, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="xlstm-1.3b-smoke", family="ssm",
    d_model=64, n_layers=8, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab=256,
    pattern=_UNIT,
    xlstm_heads=4, tie_embeddings=True,
)
