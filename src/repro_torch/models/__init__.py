"""The LM stack of the port: dense, ssm and hybrid families.

Reference: ``repro/models/__init__.py``.
"""
from .model import LM, layer_plan

__all__ = ["LM", "layer_plan"]
