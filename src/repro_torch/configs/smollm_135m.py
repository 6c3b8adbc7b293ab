"""Port copy of ``repro/configs/smollm_135m.py`` (plain data, kept in step by hand).

smollm-135m [dense]: llama-arch small. 30L d_model=576 9H GQA kv=3
d_ff=1536 vocab=49152, tied embeddings.
[hf:HuggingFaceTB/SmolLM-135M; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv=3, d_ff=1536,
    vocab=49152, tie_embeddings=True, rope_theta=10000.0,
)
