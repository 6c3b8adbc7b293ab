"""K3: the blocked-scan center precheck, a CUDA C++ kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/precheck.py``
(``center_precheck_stats`` :92, body ``_precheck_kernel`` :41). The kernel
is ``csrc/precheck.cu``; its header says what bounds it on an H100 and how
the design meets that (d split across blocks, a fixed-order second pass
with a lexicographic top-3 per row). This module is its wrapper: it checks
what the kernel takes, picks the split of d, allocates the scratch and the
outputs, and launches both passes on PyTorch's current stream. The plain
version is ``ref.center_precheck_matmul``; ``ops.center_precheck`` picks
between the two by the tensor's device and adds the error margin.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # kernel launches since the last reset (see ops.reset_launches)

# tile of csrc/precheck.cu's first pass: rows x centers per block, d step
_BM, _BN, _BK = 32, 64, 16
_TARGET_BLOCKS = 264  # two blocks per SM of an H100 (132 SMs)
_GRID_YZ_MAX = 65535
_INT_MAX = 2**31 - 1


def splits(B: int, T: int, d: int) -> tuple[int, int]:
    """(S, chunk): d is cut into S chunks of ``chunk`` columns (a multiple
    of the 16-wide shared-memory step), enough that the first pass has
    about ``_TARGET_BLOCKS`` blocks. d = 0 gives one empty chunk."""
    tiles = -(-B // _BM) * -(-T // _BN)
    steps = max(1, -(-d // _BK))
    want = max(1, min(steps, -(-_TARGET_BLOCKS // tiles)))
    chunk = -(-steps // want) * _BK
    return (-(-d // chunk) if d else 1), chunk


def _fn():
    fn = _build.library("precheck").precheck_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def center_precheck_stats(block: torch.Tensor, centers: torch.Tensor,
                          cvalid: torch.Tensor):
    """(B, d) f32, (T, d) f32, (T,) bool CUDA tensors -> (dmin, z int32,
    second, z2 int32, third), each (B,), on the card."""
    global launches
    dev = block.device
    if not (block.is_cuda and centers.device == dev and cvalid.device == dev):
        raise ValueError(
            f"precheck kernel needs all inputs on one CUDA device, got "
            f"{block.device}, {centers.device}, {cvalid.device}"
        )
    if block.dtype != torch.float32 or centers.dtype != torch.float32:
        raise ValueError(
            f"precheck kernel takes f32 points and centers, got "
            f"{block.dtype}, {centers.dtype}"
        )
    if cvalid.dtype != torch.bool:
        raise ValueError(f"precheck kernel takes a bool mask, got {cvalid.dtype}")
    if (block.dim() != 2 or centers.dim() != 2
            or block.shape[1] != centers.shape[1]
            or cvalid.shape != (centers.shape[0],)):
        raise ValueError(
            f"precheck kernel needs (B, d), (T, d), (T,); got {block.shape}, "
            f"{centers.shape}, {cvalid.shape}"
        )
    if not (block.is_contiguous() and centers.is_contiguous()
            and cvalid.is_contiguous()):
        raise ValueError("precheck kernel needs contiguous inputs")
    B, d = block.shape
    T = centers.shape[0]
    if T == 0:
        raise ValueError("precheck kernel needs at least one center")
    S, chunk = splits(B, T, d)
    if (-(-T // _BN) > _GRID_YZ_MAX or S > _GRID_YZ_MAX
            or max(S * B * T, B * d, T * d) > _INT_MAX):
        raise ValueError(f"precheck kernel cannot take B={B}, T={T}, d={d}")
    f32 = dict(dtype=torch.float32, device=dev)
    dmin, second, third = (torch.empty(B, **f32) for _ in range(3))
    z, z2 = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(2))
    if B == 0:
        return dmin, z, second, z2, third
    dot = torch.empty((S, B, T), **f32)
    xn = torch.empty((S, B), **f32)
    cn = torch.empty((S, T), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(
        block.data_ptr(), centers.data_ptr(), cvalid.data_ptr(),
        dot.data_ptr(), xn.data_ptr(), cn.data_ptr(), dmin.data_ptr(),
        z.data_ptr(), second.data_ptr(), z2.data_ptr(), third.data_ptr(),
        B, T, d, S, chunk, dev.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"precheck kernel launch failed: cudaError {err}")
    launches += 1
    return dmin, z, second, z2, third
