"""Config registry of the port: one module per assigned architecture.

Reference: ``repro/configs/__init__.py`` (``REGISTRY``, ``ALIASES``,
``get_config``, ``ARCH_IDS``); the modules are plain data and the port
keeps its own copy. ``get_config(arch_id)`` resolves --arch flags."""
from . import (
    command_r_35b,
    granite3_8b,
    llama32_vision_90b,
    llama4_maverick_400b,
    mamba2_27b,
    musicgen_medium,
    phi3_mini_38b,
    phi35_moe_42b,
    smollm_135m,
    zamba2_7b,
)
from .base import SHAPES, ArchConfig, ShapeConfig, shape_applicable

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        zamba2_7b, llama32_vision_90b, granite3_8b, smollm_135m,
        phi3_mini_38b, command_r_35b, musicgen_medium, phi35_moe_42b,
        llama4_maverick_400b, mamba2_27b,
    )
}
# short aliases for --arch
ALIASES = {
    "zamba2-7b": "zamba2-7b",
    "llama-3.2-vision-90b": "llama-3.2-vision-90b",
    "granite-3-8b": "granite-3-8b",
    "smollm-135m": "smollm-135m",
    "phi3-mini-3.8b": "phi3-mini-3.8b",
    "command-r-35b": "command-r-35b",
    "musicgen-medium": "musicgen-medium",
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b-a6.6b",
    "llama4-maverick-400b-a17b": "llama4-maverick-400b-a17b",
    "mamba2-2.7b": "mamba2-2.7b",
}


def get_config(name: str) -> ArchConfig:
    return REGISTRY[ALIASES.get(name, name)]


ARCH_IDS = sorted(REGISTRY)

__all__ = [
    "ArchConfig", "ShapeConfig", "SHAPES", "shape_applicable",
    "REGISTRY", "get_config", "ARCH_IDS",
]
