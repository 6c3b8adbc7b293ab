"""K4: the flash-attention forward, a CUDA C++ kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/flash.py`` (``flash_attention_fwd``
:75, body ``_flash_fwd_kernel`` :32). The kernel is ``csrc/flash_fwd.cu``;
its header says what bounds it on an H100 and how the design meets that.
This module is its wrapper: it checks what the kernel takes, allocates
the outputs and launches on PyTorch's current stream. Unlike the TPU
kernel it also returns the logsumexp of each row, which the backward (K5,
not ported yet) needs. The plain version is ``ref.flash_attention_fwd``;
``ops.flash_attention_fwd`` picks between the two by the tensor's device.
The backward kernels (``flash_attention_bwd``) belong to the training
slice.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # kernel launches since the last reset (see ops.reset_launches)

_DTYPES = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_bf16"}
_HD_MAX = 256
_BQ = 64  # q rows per block of csrc/flash_fwd.cu, on grid axis y
_GRID_Y_MAX = 65535
_INT_MAX = 2**31 - 1


def _fn(name: str):
    fn = getattr(_build.library("flash_fwd"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """(BH, Sq, hd), (BH, Skv, hd) x2 CUDA tensors of one dtype (f32 or
    bf16) -> (o (BH, Sq, hd) in that dtype, lse (BH, Sq) f32)."""
    global launches
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev):
        raise ValueError(
            f"flash kernel needs q, k, v on one CUDA device, got {q.device}, "
            f"{k.device}, {v.device}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash kernel takes f32 or bf16 of one dtype, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if (q.dim() != 3 or k.dim() != 3 or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]):
        raise ValueError(
            f"flash kernel needs (BH, Sq, hd), (BH, Skv, hd) x2; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel needs contiguous inputs")
    bh, sq, hd = q.shape
    skv = k.shape[1]
    if not 1 <= hd <= _HD_MAX:
        raise ValueError(f"flash kernel takes 1 <= hd <= {_HD_MAX}, got {hd}")
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=dev)
    if bh == 0 or sq == 0:
        return o, lse
    if skv == 0:
        raise ValueError("flash kernel needs at least one key")
    if -(-sq // _BQ) > _GRID_Y_MAX or bh > _INT_MAX:
        raise ValueError(f"flash kernel cannot take BH={bh}, Sq={sq}, "
                         f"Skv={skv}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn(_DTYPES[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, sq, skv, hd, int(causal), dev.index, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: cudaError {err}")
    launches += 1
    return o, lse
