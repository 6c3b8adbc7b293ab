"""Training substrate of the port: AdamW, the train step, checkpoints,
and int8 error-feedback compression with the compressed pod all-reduce
over ``torch.distributed`` (``compression``).

Reference: the modules of ``repro/train/``.
"""
from .checkpoint import CheckpointManager
from .compression import (
    compress_with_feedback,
    dequantize,
    init_residual,
    pod_allreduce_compressed,
    quantize,
)
from .optimizer import AdamWConfig, adamw_init, adamw_update, global_norm, lr_at
from .train_state import (
    StepConfig,
    abstract_train_state,
    init_train_state,
    make_train_step,
    state_specs,
)

__all__ = ["AdamWConfig", "CheckpointManager", "StepConfig",
           "abstract_train_state", "adamw_init", "adamw_update",
           "compress_with_feedback", "dequantize", "global_norm",
           "init_residual", "init_train_state", "lr_at", "make_train_step",
           "pod_allreduce_compressed", "quantize", "state_specs"]
