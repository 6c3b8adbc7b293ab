"""Port copy of ``repro/configs/llama32_vision_90b.py`` (plain data, kept in step by hand).

llama-3.2-vision-90b [vlm]: text backbone with cross-attn image layers.

100L total = 80 self-attn + 20 cross-attn (every 5th), d_model=8192,
64H GQA kv=8, d_ff=28672, vocab=128256. Vision frontend is a STUB:
input_specs() provides precomputed patch embeddings (B, 1024, d).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv=8, d_ff=28672,
    vocab=128256, cross_attn_every=5, n_img_tokens=1024,
    rope_theta=500000.0,
)
