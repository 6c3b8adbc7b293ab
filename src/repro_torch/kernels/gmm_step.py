"""K2: the fused GMM farthest-point step, a Triton kernel for Hopper.

Replaces the TPU kernel ``repro/kernels/gmm_step.py`` (``gmm_update``,
body ``_gmm_kernel``). One GMM iteration reads the point matrix once: for
each row it computes d(x_i, z) by the difference form, folds it into the
running minimum, and each program emits the max of the updated minima over
its rows (invalid rows count as -1) with the FIRST row attaining it.

Bound on an H100: bytes. At the main path's shape (n = 237,698 points of
d = 5000, f32) one launch must read 4.75 GB and does 3 flops per 4-byte
element, so at 3.35 TB/s it takes at least ~1.42 ms; the (n,) vectors add
0.2%.
The design therefore makes exactly one pass over x with no tensor cores:
one program per block of 32 rows loops over d in 128-wide tiles, keeping a
(32, 128) f32 partial sum in registers and reducing it once at the end, so
nothing but x streams from device memory. The first index of the block
maximum is ``min(where(masked == best, row, BIG))``, not ``tl.argmax``'s
own tie rule. The second stage over the (gn,) block maxima is
``torch.argmax``, which returns the first maximum as ``jnp.argmax`` does in
the reference wrapper: deterministic, no float atomics.

``triton`` is imported inside the launching function, so this module
imports on a host without it. The plain version is ``ref.gmm_update``. A
launch after which Triton's cache holds one more kernel (the first of a
specialisation) is a compile event of ``obs.torchprof``.
"""
from __future__ import annotations

import time

import torch

from ..obs.torchprof import report_compile
from . import LAUNCH_MU

launches = 0  # kernel launches since the last reset (see ops.reset_launches)

BLOCK_N = 32  # rows per program
BLOCK_D_MAX = 128  # width of one d tile
NUM_WARPS = 4
NUM_STAGES = 3

_kernel = None


def _get_kernel():
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def gmm_step_kernel(
        x_ptr, z_ptr, md_ptr, valid_ptr, nm_ptr, bv_ptr, bi_ptr,
        n, d, stride_x,
        BLOCK_N: tl.constexpr, BLOCK_D: tl.constexpr,
    ):
        pid = tl.program_id(0)
        rows = pid * BLOCK_N + tl.arange(0, BLOCK_N)
        row_ok = rows < n
        cols = tl.arange(0, BLOCK_D)
        row_base = x_ptr + rows.to(tl.int64)[:, None] * stride_x
        acc = tl.zeros((BLOCK_N, BLOCK_D), dtype=tl.float32)
        for k0 in range(0, d, BLOCK_D):
            c = k0 + cols
            c_ok = c < d
            xv = tl.load(
                row_base + c[None, :],
                mask=row_ok[:, None] & c_ok[None, :], other=0.0,
            ).to(tl.float32)
            zv = tl.load(z_ptr + c, mask=c_ok, other=0.0).to(tl.float32)
            diff = xv - zv[None, :]
            acc += diff * diff
        d2 = tl.sum(acc, axis=1)
        dist = tl.sqrt_rn(tl.maximum(d2, 0.0))
        md = tl.load(md_ptr + rows, mask=row_ok, other=0.0)
        nm = tl.minimum(md, dist)
        tl.store(nm_ptr + rows, nm, mask=row_ok)
        v = tl.load(valid_ptr + rows, mask=row_ok, other=0)
        masked = tl.where(row_ok & (v != 0), nm, -1.0)
        best = tl.max(masked, axis=0)
        first = tl.min(tl.where(masked == best, rows, 2147483647), axis=0)
        tl.store(bv_ptr + pid, best)
        tl.store(bi_ptr + pid, first)

    _kernel = gmm_step_kernel
    return _kernel


def _cached_kernels(fn) -> int:
    """Number of compiled specialisations in a Triton ``JITFunction``'s
    cache: ``device_caches`` (device -> (kernel cache, ...)) in Triton
    3.2 and later, ``cache`` (device -> kernel cache) before."""
    caches = getattr(fn, "device_caches", None)
    if caches is not None:
        return sum(len(c[0]) for c in caches.values())
    return sum(len(c) for c in getattr(fn, "cache", {}).values())


def block_d(d: int) -> int:
    """d-tile width for a row width d: a power of two in [16, 128]."""
    return max(16, min(BLOCK_D_MAX, 1 << max(d - 1, 0).bit_length()))


def gmm_update(
    x: torch.Tensor,  # (n, d) f32 or bf16, CUDA
    z: torch.Tensor,  # (d,)
    min_dist: torch.Tensor,  # (n,) f32
    valid: torch.Tensor,  # (n,) bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (new_min (n,) f32, far_idx int32, far_val f32), all on the card."""
    global launches
    dev = x.device
    if not x.is_cuda or any(t.device != dev for t in (z, min_dist, valid)):
        raise ValueError("gmm_step kernel needs all inputs on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or z.dtype != x.dtype:
        raise ValueError(f"gmm_step kernel takes f32 or bf16, got {x.dtype}, {z.dtype}")
    n, d = x.shape
    if z.shape != (d,) or min_dist.shape != (n,) or valid.shape != (n,):
        raise ValueError(
            f"gmm_step kernel shapes: x {tuple(x.shape)}, z {tuple(z.shape)}, "
            f"min_dist {tuple(min_dist.shape)}, valid {tuple(valid.shape)}"
        )
    if min_dist.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("gmm_step kernel needs f32 min_dist and bool valid")
    if x.stride(1) != 1 or not (z.is_contiguous() and min_dist.is_contiguous()
                                and valid.is_contiguous()):
        raise ValueError("gmm_step kernel needs unit-stride rows and vectors")
    if n == 0 or n >= 2**31 - BLOCK_N:
        raise ValueError(f"gmm_step kernel cannot take n={n}")
    gn = -(-n // BLOCK_N)
    new_min = torch.empty((n,), dtype=torch.float32, device=dev)
    bv = torch.empty((gn,), dtype=torch.float32, device=dev)
    bi = torch.empty((gn,), dtype=torch.int32, device=dev)
    kernel = _get_kernel()
    cached = _cached_kernels(kernel)
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        kernel[(gn,)](
            x, z, min_dist, valid.view(torch.uint8), new_min, bv, bi,
            n, d, x.stride(0),
            BLOCK_N=BLOCK_N, BLOCK_D=block_d(d),
            num_warps=NUM_WARPS, num_stages=NUM_STAGES,
        )
    with LAUNCH_MU:
        launches += 1
    if _cached_kernels(kernel) > cached:
        report_compile("triton", time.perf_counter() - t0)
    # index_select, not bi[blk]: indexing with a 0-d CUDA tensor reads it
    # on the host (a sync a launch)
    blk = torch.argmax(bv).view(1)
    return new_min, bi.index_select(0, blk).view(()), bv.index_select(
        0, blk).view(())
