"""Training substrate of the port: AdamW, the train step, checkpoints.

Reference: the modules of ``repro/train/``. ``train/compression.py`` (int8
error-feedback and the compressed pod all-reduce) is not ported: no path
of the port calls it, and its collective waits for ROADMAP.md step 11.
"""
from .checkpoint import CheckpointManager
from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm, lr_at
from .train_state import (
    StepConfig,
    abstract_train_state,
    init_train_state,
    make_train_step,
)

__all__ = ["AdamWConfig", "CheckpointManager", "StepConfig",
           "abstract_train_state", "adamw_init", "adamw_update",
           "global_norm", "init_train_state", "lr_at", "make_train_step"]
