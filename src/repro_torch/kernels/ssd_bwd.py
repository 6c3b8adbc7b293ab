"""K6b: the backward of the Mamba2 SSD intra-chunk step, a CUDA C++
kernel for Hopper.

Replaces no TPU kernel: the JAX package differentiates the jnp chunked
form (``repro/models/mamba.py`` ``ssd_chunked`` :60) with XLA's autodiff,
and this computes that same gradient for K6's (y, state). The kernel is
``csrc/ssd_bwd.cu``, 3xTF32 ``wgmma`` in four launches a call (the G^T
tiles, the cells over head slices and s-tile pairs, dB and dC, dloga);
its header says what bounds it on an H100 and how the design meets that.
This module is its wrapper: it checks what the kernel takes, passes every
operand by its strides (the model's permuted (B * nc, H, Q, .) views of
xbar and dy go in without a copy), allocates the outputs and the scratch
the kernel sums through (its size follows the head slices, which the
kernel sizes to the card's SM count: ``describe`` reports them), and
launches on PyTorch's current stream. The plain version is
``ref.ssd_intra_chunk_bwd``; ``ops.ssd_intra_chunk_bwd`` picks between the
two, and ``models.mamba.SSDIntraChunk`` is the autograd route to it.

Two routes, recorded in ``last_route``: ``"shared_bc"`` when B and C have
size 1 along the cells' last leading axis (the model's B and C, shared by
all heads), where dB and dC come back summed over that axis in a fixed
order; ``"per_cell"`` otherwise, with one dB and dC per cell. Either way
dB and dC come back in B's and C's shapes: summed over every axis along
which they broadcast.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCH_MU, _build
from .ssd import _two_lead

launches = 0  # kernel launches since the last reset (see ops.reset_launches)
last_route: str | None = None  # "shared_bc" or "per_cell"

_Q_MAX, _P_MAX, _N_MAX = 256, 64, 128
_GRID_MAX = 2**31 - 1


def _lib():
    lib = _build.library("ssd_bwd")
    if lib.ssd_bwd_f32.argtypes is None:
        lib.ssd_bwd_plan.argtypes = [ctypes.c_int] * 6
        lib.ssd_bwd_plan.restype = ctypes.c_longlong
        lib.ssd_bwd_describe.argtypes = [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.ssd_bwd_describe.restype = ctypes.c_int
        lib.ssd_bwd_f32.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                                    + [ctypes.c_longlong] * 21
                                    + [ctypes.c_int, ctypes.c_void_p])
        lib.ssd_bwd_f32.restype = ctypes.c_int
    return lib


def _lead_shape(t: torch.Tensor, nd: int) -> tuple:
    """``t``'s shape with missing leading axes as 1, ``nd`` axes in all."""
    return (1,) * (nd - t.dim()) + tuple(t.shape)


def _last_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def ssd_intra_chunk_bwd(xbar: torch.Tensor, loga: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                        dstate: torch.Tensor):
    """xbar (..., q, p), loga (..., q), B and C (..., q, n) as K6 takes
    them, dy (..., q, p) and dstate (..., n, p): f32 CUDA tensors with one
    or two leading (cell) dims -> (dxbar (..., q, p) laid out like xbar,
    dloga (..., q), dB in B's shape, dC in C's shape), f32."""
    global launches, last_route
    tensors = (xbar, loga, B, C, dy, dstate)
    dev = xbar.device
    if not (xbar.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError(
            f"ssd_bwd kernel needs all inputs on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"ssd_bwd kernel takes f32, got "
                         f"{[t.dtype for t in tensors]}")
    *lead, q, p = xbar.shape
    lead = tuple(lead)
    n = B.shape[-1]
    if (not 1 <= len(lead) <= 2 or loga.shape != (*lead, q)
            or dy.shape != xbar.shape or dstate.shape != (*lead, n, p)):
        raise ValueError(
            f"ssd_bwd kernel needs xbar and dy (g1[, g2], q, p), loga (..., "
            f"q) and dstate (..., n, p); got {tuple(xbar.shape)}, "
            f"{tuple(loga.shape)}, {tuple(dy.shape)}, {tuple(dstate.shape)}")
    if C.shape[-1] != n or B.shape[-2] != q or C.shape[-2] != q:
        raise ValueError(f"ssd_bwd kernel needs B, C (..., q, n); got "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    if not 1 <= q <= _Q_MAX or not 1 <= p <= _P_MAX or not 1 <= n <= _N_MAX:
        raise ValueError(f"ssd_bwd kernel takes q <= {_Q_MAX}, p <= "
                         f"{_P_MAX}, n <= {_N_MAX}; got q={q}, p={p}, n={n}")
    nd = len(lead) + 2
    g2 = lead[-1]
    shared = g2 > 1 and all(_lead_shape(t, nd)[len(lead) - 1] == 1
                            for t in (B, C))
    x2 = _two_lead(xbar, lead, (q, p))
    l2 = _two_lead(loga, lead, (q,))
    b2 = _two_lead(B, lead, (q, n))
    c2 = _two_lead(C, lead, (q, n))
    y2 = _two_lead(_last_contiguous(dy), lead, (q, p))
    s2 = _two_lead(_last_contiguous(dstate), lead, (n, p))
    if x2.stride(-1) != 1 or b2.stride(-1) != 1 or c2.stride(-1) != 1:
        raise ValueError("ssd_bwd kernel needs xbar, B and C contiguous "
                         "along their last axis")
    g1 = x2.shape[0]
    dxbar = torch.empty_like(xbar, memory_format=torch.preserve_format)
    dx2 = _two_lead(dxbar, lead, (q, p))
    dloga = torch.empty((*lead, q), dtype=torch.float32, device=dev)
    groups = (g1, 1) if shared else (g1, g2)
    dB = torch.empty((*groups, q, n), dtype=torch.float32, device=dev)
    dC = torch.empty((*groups, q, n), dtype=torch.float32, device=dev)
    if g1 * g2 > 0:
        if g1 * g2 * 4 > _GRID_MAX:
            raise ValueError(f"ssd_bwd kernel cannot take {g1 * g2} cells")
        lib = _lib()
        floats = lib.ssd_bwd_plan(g1, g2, q, n, int(shared), dev.index)
        if floats < 0:
            raise RuntimeError("ssd_bwd kernel plan failed (a CUDA error)")
        scratch = torch.empty(floats, dtype=torch.float32, device=dev)
        strides = []
        for t in (x2, l2, b2, c2, y2, s2, dx2):
            strides += [t.stride(0), t.stride(1), t.stride(2)]
        err = lib.ssd_bwd_f32(
            x2.data_ptr(), l2.data_ptr(), b2.data_ptr(), c2.data_ptr(),
            y2.data_ptr(), s2.data_ptr(), dx2.data_ptr(), dloga.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), scratch.data_ptr(), g1, g2, q, p, n,
            int(shared), *strides, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"ssd_bwd kernel launch failed: cudaError {err}")
        with LAUNCH_MU:
            launches += 1
            last_route = "shared_bc" if shared else "per_cell"
    # back to the callers' leading dims, then to B's and C's own shapes
    dB = dB.reshape(*lead[:-1], groups[1], q, n)
    dC = dC.reshape(dB.shape)
    return dxbar, dloga, dB.sum_to_size(B.shape), dC.sum_to_size(C.shape)


def describe(g1: int, g2: int, q: int, n: int, shared: bool,
             device: int = 0) -> dict:
    """The design as launched for g1 x g2 cells of chunk q and state n on
    CUDA device ``device``: the cell kernel's grid, head slices, shared
    memory, blocks an SM, registers and local (stack and spill) bytes, and
    the grids of its pre- and finishing passes."""
    out = (ctypes.c_longlong * 9)()
    err = _lib().ssd_bwd_describe(g1, g2, q, n, int(shared), device, out)
    if err != 0:
        raise RuntimeError(f"ssd_bwd describe failed: cudaError {err}")
    keys = ("cell_blocks", "slices", "cells_a_slice", "smem_bytes",
            "blocks_per_sm", "registers", "local_bytes", "bc_blocks",
            "gram_blocks")
    return dict(zip(keys, map(int, out)))
