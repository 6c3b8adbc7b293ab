"""K3: the blocked-scan center precheck, a CUDA C++ kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/precheck.py``
(``center_precheck_stats`` :92, body ``_precheck_kernel`` :41). The kernel
is ``csrc/precheck.cu``; its header says what bounds it on an H100 and how
the design meets that (one thread-block cluster per 16-row tile along d,
partials summed over distributed shared memory in rank order, invalid
centers skipped, a lexicographic top-3 per row). It has two routes, one
launch each:

- ``center_precheck_stats``: the TPU kernel's five outputs;
  ``ops.center_precheck`` adds the error margin;
- ``block_precheck``: the device half of the streaming scan's block
  precheck (the reference's ``_block_precheck``): the margin, the exact
  refinement of the two candidate centers and the replay flag, into one
  (2, B) int32 tensor (z, then the flag).

This module is their wrapper: it checks what the kernel takes, picks the
cluster's split of d, allocates the outputs and launches on PyTorch's
current stream. Their plain versions are ``ref.center_precheck_matmul``
and ``ref.block_precheck``; ``ops`` picks by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCH_MU, _build

launches = 0  # kernel launches since the last reset (see ops.reset_launches)
last_plan: dict = {}  # the split of the latest launch (see _plan)

_BK = 32  # d columns of one ring stage of csrc/precheck.cu
_BR = 16  # rows of x a cluster
MAX_SPLIT = 16  # blocks a cluster (csrc/precheck.cu:MAX_SPLIT)
_MIN_CHUNK = 256  # d columns a block takes before a cluster grows
_GRID_Y_MAX = 65535
_INT_MAX = 2**31 - 1
_plans: dict = {}


def cluster_split(d: int) -> tuple[int, int]:
    """(S, chunk): the blocks of a cluster along d and the d columns each
    takes. S = ceil(d / 256), between 1 and 16; chunk = ceil(d / S) rounded
    up to whole 32-column stages, so a block past d may get an empty chunk
    (it contributes zeros). d = 0 gives one empty chunk."""
    S = min(MAX_SPLIT, max(1, -(-d // _MIN_CHUNK)))
    chunk = -(-max(d, 1) // S)
    return S, -(-chunk // _BK) * _BK


def _lib():
    lib = _build.library("precheck")
    if lib.precheck_stats_f32.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.precheck_smem_bytes.argtypes = [i]
        lib.precheck_max_clusters.argtypes = [i] * 5
        lib.precheck_stats_f32.argtypes = [vp] * 8 + [i] * 6 + [vp]
        lib.precheck_block_f32.argtypes = ([vp] * 5 + [i] * 5 + [f] * 4
                                           + [i, vp])
        for fn in (lib.precheck_smem_bytes, lib.precheck_max_clusters,
                   lib.precheck_stats_f32, lib.precheck_block_f32):
            fn.restype = ctypes.c_int
    return lib


def _plan(B: int, T: int, d: int, fused: bool, device: int) -> dict:
    """The split for one shape, checked once: the shared memory fits and
    at least one cluster can be resident (``cudaOccupancyMaxActiveClusters``);
    otherwise it raises. Cached per shape."""
    key = (B, T, d, fused, device)
    plan = _plans.get(key)
    if plan is None:
        S, chunk = cluster_split(d)
        lib = _lib()
        smem = lib.precheck_smem_bytes(T)
        if smem <= 0:
            raise ValueError(
                f"precheck kernel cannot take T={T}: its center list and "
                f"tiles do not fit a block's shared memory")
        clusters = lib.precheck_max_clusters(B, T, S, int(fused), device)
        if clusters <= 0:
            raise RuntimeError(
                f"precheck kernel: no cluster of {S} blocks with {smem} "
                f"bytes of shared memory each fits on the card "
                f"(cudaOccupancyMaxActiveClusters: {clusters})")
        plan = dict(S=S, chunk=chunk, tiles=-(-B // _BR), smem=smem,
                    max_active_clusters=clusters)
        _plans[key] = plan
    return plan


def _check(block, centers, cvalid, x1=None):
    dev = block.device
    tensors = (block, centers, cvalid) + (() if x1 is None else (x1,))
    if not (block.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError(
            f"precheck kernel needs all inputs on one CUDA device, got "
            f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors if t is not cvalid):
        raise ValueError(
            f"precheck kernel takes f32 points and centers, got "
            f"{[t.dtype for t in tensors if t is not cvalid]}")
    if cvalid.dtype != torch.bool:
        raise ValueError(f"precheck kernel takes a bool mask, got {cvalid.dtype}")
    B, d = block.shape if block.dim() == 2 else (-1, -1)
    T = centers.shape[0] if centers.dim() == 2 else 0
    if (block.dim() != 2 or centers.dim() != 2 or centers.shape[1] != d
            or cvalid.shape != (T,)
            or (x1 is not None and x1.shape != (d,))):
        raise ValueError(
            f"precheck kernel needs (B, d), (T, d), (T,)"
            f"{'' if x1 is None else ', (d,)'}; got {block.shape}, "
            f"{centers.shape}, {cvalid.shape}"
            f"{'' if x1 is None else f', {x1.shape}'}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("precheck kernel needs contiguous inputs")
    if T == 0:
        raise ValueError("precheck kernel needs at least one center")
    if -(-B // _BR) > _GRID_Y_MAX or max(B * d, T * d) > _INT_MAX:
        raise ValueError(f"precheck kernel cannot take B={B}, T={T}, d={d}")
    return B, T, d


def _raise_on(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"precheck kernel launch failed: cudaError {err}")


def center_precheck_stats(block: torch.Tensor, centers: torch.Tensor,
                          cvalid: torch.Tensor):
    """(B, d) f32, (T, d) f32, (T,) bool CUDA tensors -> (dmin, z int32,
    second, z2 int32, third), each (B,), on the card; one launch."""
    global launches, last_plan
    B, T, d = _check(block, centers, cvalid)
    dev = block.device
    out = torch.empty((5, B), dtype=torch.float32, device=dev)
    dmin, z, second, z2, third = out
    z, z2 = z.view(torch.int32), z2.view(torch.int32)
    if B == 0:
        return dmin, z, second, z2, third
    plan = _plan(B, T, d, False, dev.index)
    _raise_on(_lib().precheck_stats_f32(
        block.data_ptr(), centers.data_ptr(), cvalid.data_ptr(),
        dmin.data_ptr(), z.data_ptr(), second.data_ptr(), z2.data_ptr(),
        third.data_ptr(), B, T, d, plan["S"], plan["chunk"], dev.index,
        torch.cuda.current_stream(dev).cuda_stream))
    with LAUNCH_MU:
        launches += 1
        last_plan = plan
    return dmin, z, second, z2, third


def block_precheck(block: torch.Tensor, centers: torch.Tensor,
                   cvalid: torch.Tensor, x1, thr: float, slack_thr: float,
                   r2: float, slack_r2: float) -> torch.Tensor:
    """The scan's block precheck on the card, one launch: (B, d), (T, d),
    (T,) bool and, for the diameter variant, x1 (d,) (None for the radius
    variant, when r2 and slack_r2 are not read) -> (2, B) int32, z then
    the replay flag (0 or 1). The four thresholds go to the kernel as f32,
    as the caller computed them."""
    global launches, last_plan
    B, T, d = _check(block, centers, cvalid, x1)
    dev = block.device
    out = torch.empty((2, B), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    plan = _plan(B, T, d, True, dev.index)
    _raise_on(_lib().precheck_block_f32(
        block.data_ptr(), centers.data_ptr(), cvalid.data_ptr(),
        None if x1 is None else x1.data_ptr(), out.data_ptr(), B, T, d,
        plan["S"], plan["chunk"], thr, slack_thr, r2, slack_r2, dev.index,
        torch.cuda.current_stream(dev).cuda_stream))
    with LAUNCH_MU:
        launches += 1
        last_plan = plan
    return out
