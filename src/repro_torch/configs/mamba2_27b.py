"""Port copy of ``repro/configs/mamba2_27b.py`` (plain data, kept in step by hand).

mamba2-2.7b [ssm]: attention-free SSD backbone. 64L d_model=2560,
ssm_state=128, vocab=50280. [arXiv:2405.21060; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    subquadratic=True,
)
