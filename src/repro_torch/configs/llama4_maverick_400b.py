"""Port copy of ``repro/configs/llama4_maverick_400b.py`` (plain data, kept in step by hand).

llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H GQA kv=8,
interleaved MoE (every other layer), 128 experts top-1,
d_ff(expert)=8192, vocab=202048, early-fusion multimodal (text path here).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
    vocab=202048, n_experts=128, top_k=1, moe_every=2,
    rope_theta=500000.0,
)
