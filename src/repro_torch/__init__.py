"""repro_torch: the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

``repro`` (JAX, Pallas kernels for the TPU) is the unchanged reference;
this package mirrors it module for module and never imports it or JAX.
Its entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU. See ROADMAP.md for what is ported.
"""
from .core import (
    DMMCSolution,
    MatroidSpec,
    StreamState,
    ingest_batch,
    init_stream_state,
    snapshot_coreset,
    solve_dmmc,
    stream_coreset,
)
from .device import CUDA, resolve_device

__version__ = "0.1.0"

__all__ = ["CUDA", "DMMCSolution", "MatroidSpec", "StreamState",
           "ingest_batch", "init_stream_state", "resolve_device",
           "snapshot_coreset", "solve_dmmc", "stream_coreset"]
