"""K4 and K5: the flash-attention forward and backward, CUDA C++ kernels
for Hopper.

Replaces the TPU kernels ``repro/kernels/flash.py``: the forward
(``flash_attention_fwd`` :75, body ``_flash_fwd_kernel`` :30) and the
backward (``flash_attention_bwd`` :219, bodies ``_flash_bwd_dq_kernel``
:132 and ``_flash_bwd_dkv_kernel`` :171). The kernels are
``csrc/flash_fwd.cu`` (K4) and ``csrc/flash_bwd.cu`` (K5); their headers
say what bounds them on an H100 and how the designs meet that. Each has
two routes, chosen in its C launcher: bf16 with hd % 8 == 0, hd <= 256
and 16-byte-aligned tensors runs on the tensor cores (``wgmma``); f32,
and bf16 at any other hd, runs the FFMA kernels. ``last_route`` records
the route of the latest launch of each. This module is their wrapper: it
checks what a kernel takes, allocates the outputs and launches on
PyTorch's current stream. Unlike the TPU kernel the forward also returns
the logsumexp of each row, from which the backward recomputes the
probabilities. The plain versions are
``ref.flash_attention_fwd`` and ``ref.flash_attention_bwd``;
``ops.flash_attention_fwd`` / ``ops.flash_attention_bwd`` pick between
the two by the tensor's device, and ``models.attention.FlashAttention``
ties them together as one ``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0  # K4 launches since the last reset (see ops.reset_launches)
bwd_launches = 0  # K5 launches (one dq and one dk/dv kernel each)
# the route of the latest launch: "wgmma" (bf16 tensor cores) or "ffma"
last_route: dict[str, str | None] = {"fwd": None, "bwd": None}

_DTYPES = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_bf16"}
_BWD_DTYPES = {torch.float32: "flash_bwd_f32",
               torch.bfloat16: "flash_bwd_bf16"}
_HD_MAX = 256
_BQ = 64  # q rows per block of csrc/flash_fwd.cu, on grid axis y
_BWD_TILE_MIN = 32  # the smallest q or kv tile of csrc/flash_bwd.cu
NEG_INF = -1e30
_GRID_Y_MAX = 65535
_INT_MAX = 2**31 - 1


def _fn(name: str):
    fn = getattr(_build.library("flash_fwd"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn(name: str):
    fn = getattr(_build.library("flash_bwd"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _route(lib: str, tensors) -> str:
    """The route the C launcher of ``lib`` takes for these tensors (its
    own ``*_bf16_route`` function decides; f32 always runs FFMA)."""
    if tensors[0].dtype != torch.bfloat16:
        return "ffma"
    fn = getattr(_build.library(lib), f"{lib}_bf16_route")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * len(tensors)
        fn.restype = ctypes.c_int
    hd = tensors[0].shape[-1]
    return "wgmma" if fn(hd, *(t.data_ptr() for t in tensors)) else "ffma"


def _check_qkv(q, k, v, what: str) -> None:
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev):
        raise ValueError(
            f"{what} needs q, k, v on one CUDA device, got {q.device}, "
            f"{k.device}, {v.device}"
        )
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"{what} takes f32 or bf16 of one dtype, got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if (q.dim() != 3 or k.dim() != 3 or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]):
        raise ValueError(
            f"{what} needs (BH, Sq, hd), (BH, Skv, hd) x2; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what} needs contiguous inputs")
    if not 1 <= q.shape[2] <= _HD_MAX:
        raise ValueError(f"{what} takes 1 <= hd <= {_HD_MAX}, got "
                         f"{q.shape[2]}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True):
    """(BH, Sq, hd), (BH, Skv, hd) x2 CUDA tensors of one dtype (f32 or
    bf16) -> (o (BH, Sq, hd) in that dtype, lse (BH, Sq) f32)."""
    global launches
    _check_qkv(q, k, v, "flash kernel")
    dev = q.device
    bh, sq, hd = q.shape
    skv = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=dev)
    if bh == 0 or sq == 0:
        return o, lse
    if skv == 0:
        raise ValueError("flash kernel needs at least one key")
    tiles = -(-sq // _BQ)
    # FFMA: q tiles on grid axis y; wgmma: bh x q tiles on grid axis x
    if tiles > _GRID_Y_MAX or bh * tiles > _INT_MAX:
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
    last_route["fwd"] = _route("flash_fwd", (q, k, v, o))
    return o, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True):
    """K5. q, o, do (BH, Sq, hd), k, v (BH, Skv, hd): contiguous CUDA
    tensors of one dtype (f32 or bf16); lse (BH, Sq) f32 from the forward.
    Returns (dq, dk, dv) in that dtype.

    dsum = rowsum(do * o) is one torch reduction here, outside the kernel,
    as in the reference. Every row needs a valid key (a row whose lse is
    -1e30 would have P = exp(+huge)): under the top-left causal mask that
    holds for every Skv >= 1, so Skv = 0 raises here and a -1e30 in
    ``lse`` fails a device-side assert (no host sync).
    """
    global bwd_launches
    _check_qkv(q, k, v, "flash backward kernel")
    dev = q.device
    bh, sq, hd = q.shape
    skv = k.shape[1]
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(
                f"flash backward kernel needs {name} contiguous, of q's "
                f"shape {tuple(q.shape)} and dtype {q.dtype}; got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if (lse.shape != (bh, sq) or lse.dtype != torch.float32
            or lse.device != dev or not lse.is_contiguous()):
        raise ValueError(
            f"flash backward kernel needs lse contiguous f32 of shape "
            f"{(bh, sq)}; got {tuple(lse.shape)} {lse.dtype}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if bh == 0 or (sq == 0 and skv == 0):
        return dq, dk, dv
    if skv == 0:
        raise ValueError("flash backward kernel needs at least one key")
    if sq == 0:
        return dq, dk.zero_(), dv.zero_()
    tiles = -(-max(sq, skv) // _BWD_TILE_MIN)
    if tiles > _GRID_Y_MAX or bh * tiles > _INT_MAX:
        raise ValueError(f"flash backward kernel cannot take BH={bh}, "
                         f"Sq={sq}, Skv={skv}")
    torch._assert_async(torch.all(lse > NEG_INF / 2))
    dsum = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_fn(_BWD_DTYPES[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bh, sq, skv, hd, int(causal), dev.index, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash backward kernel launch failed: cudaError {err}")
    bwd_launches += 1
    last_route["bwd"] = _route("flash_bwd", (q, k, v, do, dq, dk, dv))
    return dq, dk, dv
