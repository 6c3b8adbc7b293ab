"""Port copy of ``repro/configs/command_r_35b.py`` (plain data, kept in step by hand).

command-r-35b [dense]: 40L d_model=8192 64H GQA kv=8 d_ff=22528
vocab=256000, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv=8, d_ff=22528,
    vocab=256000, rope_theta=500000.0,
)
