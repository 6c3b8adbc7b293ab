"""Port copy of ``repro/configs/granite3_8b.py`` (plain data, kept in step by hand).

granite-3-8b [dense]: 40L d_model=4096 32H GQA kv=8 d_ff=12800
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=12800,
    vocab=49155, rope_theta=10000.0,
)
