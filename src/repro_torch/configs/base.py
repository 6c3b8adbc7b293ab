"""Port copy of ``repro/configs/base.py`` (plain data, kept in step by hand).

Architecture + shape configuration schema.

One ``ArchConfig`` per assigned architecture (src/repro/configs/<id>.py) with
the exact published dimensions, plus ``reduced()`` for the CPU smoke tests.
The four assignment shapes are fixed here; ``long_500k`` only applies to
sub-quadratic (SSM/hybrid) architectures — DESIGN.md §7.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    mlp: str = "swiglu"  # swiglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # every Nth layer is MoE (1 = all)
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    d_conv: int = 4
    shared_attn_every: int = 0  # hybrid: shared attn block after every N mamba
    # VLM
    cross_attn_every: int = 0  # 0 = no cross attention
    n_img_tokens: int = 0
    # misc
    rope_theta: float = 500000.0
    tie_embeddings: bool = False
    subquadratic: bool = False  # eligible for long_500k
    dtype: str = "bfloat16"
    ssd_chunk: int = 256
    q_block: int = 512
    kv_block: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows padded to a multiple of 64 so the vocab dim
        shards evenly on the model axis (49155 -> 49216, 50280 -> 50304).
        Padding rows are ordinary never-targeted classes (standard practice;
        DESIGN.md §8)."""
        return -(-self.vocab // 64) * 64

    def reduced(self) -> "ArchConfig":
        """Same family/topology, laptop-sized — used by the smoke tests."""
        scale = {
            "n_layers": min(self.n_layers, 4),
            "d_model": 64,
            "n_heads": 4,
            "n_kv": max(1, min(self.n_kv, 2)) if self.n_kv else 0,
            "d_ff": 128,
            "vocab": 128,
            "head_dim": 16,
            "ssd_chunk": 16,
            "q_block": 16,
            "kv_block": 16,
        }
        if self.family in ("ssm", "hybrid"):
            scale.update(ssm_state=8, ssm_head_dim=16)
            if self.family == "hybrid":
                scale.update(n_layers=5, shared_attn_every=2)
        if self.n_experts:
            # dropless capacity in the reduced configs so the decode path is
            # bit-consistent with the full forward (capacity drops are a
            # known train/serve divergence of capacity-based MoE routing)
            scale.update(n_experts=4, top_k=min(self.top_k, 2),
                         capacity_factor=4.0)
        if self.cross_attn_every:
            scale.update(n_layers=4, cross_attn_every=2, n_img_tokens=8)
        return dataclasses.replace(self, **scale)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic context handling (DESIGN.md §7)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True
