"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  [arXiv:2407.21783]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    head_dim=128,
    rope="standard",
    rope_theta=5e5,
    sliding_window=8192,
    optimizer="adafactor",
    citation="arXiv:2407.21783",
)
