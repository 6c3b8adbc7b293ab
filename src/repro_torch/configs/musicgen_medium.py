"""Port copy of ``repro/configs/musicgen_medium.py`` (plain data, kept in step by hand).

musicgen-medium [audio]: decoder-only transformer over EnCodec tokens.

48L d_model=1536 24H (kv=24 -> MHA) d_ff=6144 vocab=2048, GELU MLP.
The EnCodec frontend is a STUB: the backbone consumes the flattened
audio-token stream; input_specs() provides token ids over the 2048-entry
codebook. [arXiv:2306.05284; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv=24, d_ff=6144,
    vocab=2048, mlp="gelu", rope_theta=10000.0,
)
