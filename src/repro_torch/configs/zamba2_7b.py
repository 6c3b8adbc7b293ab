"""Port copy of ``repro/configs/zamba2_7b.py`` (plain data, kept in step by hand).

zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81 Mamba2 layers, d_model=3584, shared attn block (32H MHA, d_ff=14336)
applied after every 6th mamba layer (13 applications of ONE weight set),
ssm_state=64, vocab=32000. [arXiv:2411.15242; unverified]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336,
    vocab=32000, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6, subquadratic=True, rope_theta=10000.0,
)
