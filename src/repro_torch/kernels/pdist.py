"""K1: pairwise squared distances, a CUDA C++ kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/pdist.py`` (``pairwise_sqdist``,
body ``_pdist_kernel``). The kernel is ``csrc/pdist.cu``; its header says
what bounds it on an H100 and how the design meets that. This module is
its wrapper: it checks what the kernel takes, allocates the output, and
launches on PyTorch's current stream. The plain version is
``ref.pairwise_sqdist``; ``ops.pairwise_sqdist`` picks between the two by
the tensor's device.

Two routes, chosen by an explicit branch in the C launcher: ``"sym"`` when
x and y are one tensor (same storage, shape and strides, as
``core/final_solve.coreset_distance_matrix`` calls it), which computes
the tiles on and above the diagonal and mirrors them, so D equals its
transpose bit for bit; ``"full"`` for any other pair. ``last_route`` and
``last_splits`` (how many blocks share the d axis of a tile) record the
latest launch.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCH_MU, _build

launches = 0  # kernel launches since the last reset (see ops.reset_launches)
last_route: str | None = None  # "sym" or "full"
last_splits: int | None = None

_DTYPES = {torch.float32: "pdist_f32", torch.bfloat16: "pdist_bf16"}
_TILE = 64  # rows of an output tile of csrc/pdist.cu
_INT_MAX = 2**31 - 1
# (n, m, d, sym, device index) -> (splits, scratch floats) of pdist_plan
_plans: dict[tuple, tuple[int, int]] = {}


def _lib():
    lib = _build.library("pdist")
    if lib.pdist_plan.argtypes is None:
        lib.pdist_plan.argtypes = [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.pdist_plan.restype = ctypes.c_int
        for name in _DTYPES.values():
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, d), (m, d) CUDA tensors, f32 or bf16 -> (n, m) f32 on the card."""
    global launches, last_route, last_splits
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
    tiles = -(-n // _TILE) * -(-m // _TILE)
    if tiles > _INT_MAX or max(n, m, d) > _INT_MAX:
        raise ValueError(f"pdist kernel cannot take shape n={n}, m={m}, d={d}")
    sym = (x.data_ptr() == y.data_ptr() and x.shape == y.shape
           and x.stride() == y.stride())
    lib = _lib()
    key = (n, m, d, sym, x.device.index)
    if key not in _plans:
        need = ctypes.c_longlong(0)
        splits = lib.pdist_plan(n, m, d, int(sym), x.device.index,
                                ctypes.byref(need))
        _plans[key] = (splits, need.value)
    splits, need = _plans[key]
    scratch = torch.empty(need, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(lib, _DTYPES[x.dtype])(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, m,
        d, int(sym), x.device.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"pdist kernel launch failed: cudaError {err}")
    with LAUNCH_MU:
        launches += 1
        last_route, last_splits = ("sym" if sym else "full"), splits
    return out
