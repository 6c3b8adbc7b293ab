"""Port copy of ``repro/configs/phi3_mini_38b.py`` (plain data, kept in step by hand).

phi3-mini-3.8b [dense]: 32L d_model=3072 32H (kv=32 -> MHA) d_ff=8192
vocab=32064, RoPE + SwiGLU. [arXiv:2404.14219; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv=32, d_ff=8192,
    vocab=32064, rope_theta=10000.0,
)
