"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544.  [arXiv:2403.17297]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    head_dim=128,
    rope="standard",
    rope_theta=1e6,
    sliding_window=8192,
    optimizer="adamw",
    citation="arXiv:2403.17297",
)
