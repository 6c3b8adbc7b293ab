"""Port copy of ``repro/configs/phi35_moe_42b.py`` (plain data, kept in step by hand).

phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H GQA kv=8, MoE FFN
16 experts top-2, d_ff(expert)=6400, vocab=32064.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400,
    vocab=32064, n_experts=16, top_k=2, moe_every=1,
    rope_theta=10000.0,
)
