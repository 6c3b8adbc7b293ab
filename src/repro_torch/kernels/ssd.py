"""K6: the Mamba2 SSD intra-chunk step, a CUDA C++ kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/ssd.py``
(``ssd_intra_chunk_batched`` :53, body ``_ssd_kernel`` :25). The kernel is
``csrc/ssd.cu``; its header says what bounds it on an H100 and how the
design meets that. This module is its wrapper: it checks what the kernel
takes, passes every operand by its strides (so a permuted view of the
model's (B, S, H, P) activations and a stride-0 head broadcast of its B
and C go in without a copy), allocates the outputs and launches on
PyTorch's current stream. The plain version is ``ref.ssd_intra_chunk``;
``ops.ssd_intra_chunk`` picks between the two and adds the decays.

Two routes, chosen by an explicit branch in the C launcher and recorded
in ``last_route``: ``"shared_bc"`` when B and C have stride 0 along the
cells' second axis (the model's head broadcast), where C B^T is computed
once per first-axis index into scratch that this wrapper allocates, and
``"per_cell"`` for any other B and C.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCH_MU, _build

launches = 0  # kernel launches since the last reset (see ops.reset_launches)
last_route: str | None = None  # "shared_bc" or "per_cell"

_P_MAX, _N_MAX = 64, 128
_GRID_MAX = 2**31 - 1


def _lib():
    lib = _build.library("ssd")
    if lib.ssd_f32.argtypes is None:
        lib.ssd_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.ssd_plan.restype = ctypes.c_int
        lib.ssd_f32.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                                + [ctypes.c_longlong] * 15
                                + [ctypes.c_int, ctypes.c_void_p])
        lib.ssd_f32.restype = ctypes.c_int
    return lib


def _two_lead(t: torch.Tensor, lead: tuple, tail: tuple) -> torch.Tensor:
    """``t`` broadcast to ``lead + tail`` (stride 0 where it broadcasts),
    with the leading dims made exactly two."""
    t = t.expand(*lead, *tail)
    return t.reshape(1, *t.shape) if len(lead) == 1 else t


def ssd_intra_chunk(xbar: torch.Tensor, loga: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor):
    """xbar (..., q, p), loga (..., q), B and C (..., q, n) f32 CUDA tensors
    with one or two leading dims (B and C broadcast to xbar's: stride 0 is
    fine) -> (y (..., q, p) f32 laid out like xbar, state (..., n, p) f32
    contiguous)."""
    global launches, last_route
    dev = xbar.device
    if not (xbar.is_cuda and all(t.device == dev for t in (loga, B, C))):
        raise ValueError(
            f"ssd kernel needs all inputs on one CUDA device, got "
            f"{[str(t.device) for t in (xbar, loga, B, C)]}"
        )
    if any(t.dtype != torch.float32 for t in (xbar, loga, B, C)):
        raise ValueError(
            f"ssd kernel takes f32, got "
            f"{[t.dtype for t in (xbar, loga, B, C)]}"
        )
    *lead, q, p = xbar.shape
    lead = tuple(lead)
    n = B.shape[-1]
    if not 1 <= len(lead) <= 2 or loga.shape != (*lead, q):
        raise ValueError(
            f"ssd kernel needs xbar (g1[, g2], q, p) and loga (..., q); got "
            f"{tuple(xbar.shape)}, {tuple(loga.shape)}"
        )
    if C.shape[-1] != n or B.shape[-2] != q or C.shape[-2] != q:
        raise ValueError(
            f"ssd kernel needs B, C (..., q, n); got {tuple(B.shape)}, "
            f"{tuple(C.shape)}"
        )
    if q < 1 or not 1 <= p <= _P_MAX or not 1 <= n <= _N_MAX:
        raise ValueError(f"ssd kernel takes q >= 1, p <= {_P_MAX}, "
                         f"n <= {_N_MAX}; got q={q}, p={p}, n={n}")
    x2 = _two_lead(xbar, lead, (q, p))
    l2 = _two_lead(loga, lead, (q,))
    b2 = _two_lead(B, lead, (q, n))
    c2 = _two_lead(C, lead, (q, n))
    if (x2.stride(-1) != 1 or b2.stride(-1) != 1 or c2.stride(-1) != 1):
        raise ValueError("ssd kernel needs xbar, B and C contiguous along "
                         "their last axis")
    # a dense xbar's layout is kept (the model's permuted view comes back
    # as one); any other gets a contiguous y
    y = torch.empty_like(xbar, memory_format=torch.preserve_format)
    y2 = _two_lead(y, lead, (q, p))
    state = torch.empty((*lead, n, p), dtype=torch.float32, device=dev)
    g1, g2 = x2.shape[:2]
    if g1 * g2 == 0:
        return y, state
    if g1 * g2 > _GRID_MAX:
        raise ValueError(f"ssd kernel cannot take {g1 * g2} cells")
    strides = []
    for t in (x2, l2, b2, c2, y2):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    lib = _lib()
    need = ctypes.c_longlong(0)
    shared = lib.ssd_plan(g1, g2, q, b2.stride(1), c2.stride(1),
                          ctypes.byref(need))
    scratch = (torch.empty(need.value, dtype=torch.float32, device=dev)
               if need.value else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ssd_f32(
        x2.data_ptr(), l2.data_ptr(), b2.data_ptr(), c2.data_ptr(),
        y2.data_ptr(), state.data_ptr(),
        None if scratch is None else scratch.data_ptr(), g1, g2, q, p, n,
        *strides, dev.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed: cudaError {err}")
    with LAUNCH_MU:
        launches += 1
        last_route = "shared_bc" if shared else "per_cell"
    return y, state
