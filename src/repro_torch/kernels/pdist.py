"""K1: pairwise squared distances, a CUDA C++ kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/pdist.py`` (``pairwise_sqdist``,
body ``_pdist_kernel``). The kernel is ``csrc/pdist.cu``; its header says
what bounds it on an H100 and how the design meets that. This module is
its wrapper: it checks what the kernel takes, allocates the output, and
launches on PyTorch's current stream. The plain version is
``ref.pairwise_sqdist``; ``ops.pairwise_sqdist`` picks between the two by
the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # kernel launches since the last reset (see ops.reset_launches)

_DTYPES = {torch.float32: "pdist_f32", torch.bfloat16: "pdist_bf16"}
_TILE = 64  # BN of csrc/pdist.cu: y rows per block, on grid axis y
_GRID_Y_MAX = 65535
_INT_MAX = 2**31 - 1


def _fn(name: str):
    lib = _build.library("pdist")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, d), (m, d) CUDA tensors, f32 or bf16 -> (n, m) f32 on the card."""
    global launches
    if not (x.is_cuda and y.is_cuda) or x.device != y.device:
        raise ValueError(
            f"pdist kernel needs both inputs on one CUDA device, got "
            f"{x.device} and {y.device}"
        )
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise ValueError(f"pdist kernel takes f32 or bf16, got {x.dtype}, {y.dtype}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"pdist kernel needs (n, d), (m, d); got {x.shape}, {y.shape}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("pdist kernel needs contiguous row-major inputs")
    n, d = x.shape
    m = y.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    if d == 0:
        return out.zero_()
    if -(-m // _TILE) > _GRID_Y_MAX or max(n, m, d) > _INT_MAX:
        raise ValueError(f"pdist kernel cannot take shape n={n}, m={m}, d={d}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _fn(_DTYPES[x.dtype])(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), n, m, d,
        x.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"pdist kernel launch failed: cudaError {err}")
    launches += 1
    return out
