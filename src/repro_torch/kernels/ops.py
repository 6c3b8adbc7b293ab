"""Public wrappers around the hand-written kernels.

Reference: ``repro/kernels/ops.py`` (``pairwise_sqdist`` :40,
``pairwise_dist`` :48, ``_pdist_e2`` :52, ``center_precheck`` :67,
``gmm_update`` :117, ``ssd_intra_chunk`` :127, ``flash_attention_fwd``
:144); ``flash_attention_bwd`` is ``repro/kernels/flash.py:219``, which
the reference's ops never exposes; ``ssd_intra_chunk_bwd`` (K6b) has no
counterpart there (the reference differentiates the jnp chunked SSD);
``block_precheck`` is the device half of
``repro/core/streaming.py:_block_precheck`` (:732), which the reference
leaves to XLA's fusion around its precheck kernel.

Dispatch: inputs are first moved to ``device`` (CUDA unless the caller asks
for the CPU). A CPU tensor runs the plain version in ``ref.py``; a CUDA
tensor launches the kernel, or the kernel's wrapper raises. ``force="ref"``
is the one way to run the plain version on the card (the chip smoke run
and the tests compare the two with it). No environment variable picks a
path, and nothing falls back from the kernel to the plain version.

No silent detach: the kernels are launches with no autograd graph, so a
kernel path called under grad mode with an input that requires grad
raises (a loss through it would lose the gradient without a word). The
differentiable routes are ``models.attention.FlashAttention`` (K4, whose
backward is K5) and ``models.mamba.SSDIntraChunk`` (K6, whose backward is
K6b); the plain versions are torch and differentiate as they are.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash as _flash
from . import gmm_step as _gmm_step
from . import pdist as _pdist
from . import precheck as _precheck
from . import ref as _ref
from . import ssd as _ssd
from . import ssd_bwd as _ssd_bwd
from ..device import CUDA, DeviceLike, resolve_device
from . import LAUNCH_MU

# op name -> (wrapper module, name of its launch counter)
_KERNELS = {"pairwise_sqdist": (_pdist, "launches"),
            "gmm_update": (_gmm_step, "launches"),
            "center_precheck": (_precheck, "launches"),
            "flash_attention_fwd": (_flash, "launches"),
            "flash_attention_bwd": (_flash, "bwd_launches"),
            "ssd_intra_chunk": (_ssd, "launches"),
            "ssd_intra_chunk_bwd": (_ssd_bwd, "launches")}


def _use_ref(t: torch.Tensor, force: Optional[str]) -> bool:
    if force not in (None, "ref"):
        raise ValueError(f"unknown force={force!r}; expected None or 'ref'")
    if force == "ref" or t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def _no_silent_detach(op: str, *tensors: torch.Tensor) -> None:
    """Raise if the kernel path of ``op`` would cut an autograd graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"ops.{op}: the kernel has no backward here, and an input "
            f"requires grad; the gradient would be cut silently. Run it "
            f"under torch.no_grad(), detach the inputs, or use a "
            f"differentiable route (models.attention.FlashAttention for "
            f"attention, models.mamba.SSDIntraChunk for the SSD step)")


def pairwise_sqdist(x, y, *, force: Optional[str] = None,
                    device: DeviceLike = CUDA):
    """(n, d), (m, d) -> (n, m) f32 squared Euclidean distances (K1)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    if _use_ref(x, force):
        return _ref.pairwise_sqdist(x, y)
    _no_silent_detach("pairwise_sqdist", x, y)
    return _pdist.pairwise_sqdist(x, y)


def pairwise_dist(x, y, *, force: Optional[str] = None,
                  device: DeviceLike = CUDA):
    return torch.sqrt(pairwise_sqdist(x, y, force=force, device=device))


def gmm_update(x, z, min_dist, valid, *, force: Optional[str] = None,
               device: DeviceLike = CUDA):
    """Fused GMM step (K2): (new_min (n,), far_idx int32, far_val f32)."""
    dev = resolve_device(device)
    x, z, min_dist, valid = (
        torch.as_tensor(t, device=dev) for t in (x, z, min_dist, valid)
    )
    if _use_ref(x, force):
        return _ref.gmm_update(x, z, min_dist, valid)
    _no_silent_detach("gmm_update", x, z, min_dist)
    return _gmm_step.gmm_update(x, z, min_dist, valid)


def _pdist_e2(block, centers, cvalid, *, per_row: bool = False):
    """Squared-space error bound of the matmul-form ||x||^2+||y||^2-2x.y
    distances: cancellation loses ~eps * (||x||^2+||y||^2); bound it by the
    operand norms in play -- per block row when ``per_row`` (each point's
    own norm against the largest valid center norm), the block-global max
    otherwise."""
    xnorm = torch.sum(block * block, dim=-1)
    if not per_row:
        xnorm = torch.amax(xnorm)
    cnorm = torch.where(cvalid, torch.sum(centers * centers, dim=-1), 0.0)
    scale = xnorm + torch.amax(cnorm)
    return 1e-5 * torch.clamp_min(scale, 1e-12)


def center_precheck(block, centers, cvalid, *, force: Optional[str] = None,
                    device: DeviceLike = CUDA):
    """Blocked-scan precheck (K3): distance to every center and the top-3
    nearest per row in one op.

    (B, d), (T, d), (T,) -> (dmin, z int32, second, z2 int32, third, each
    (B,), and the error margin: (B,) per row, or a 0-d zero on the exact
    path). Invalid centers count as float32 max; ``z``/``z2`` are the first
    columns attaining the two smallest distances.

    Paths: by default the kernel for a CUDA tensor and its matmul-form
    plain version (``ref.center_precheck_matmul``) for a CPU tensor;
    ``force="ref"`` the plain version on any device, with the margin;
    ``force="exact"`` the broadcast oracle (``ref.center_precheck``) with
    margin 0, which the reference calls ``force="ref"``. The matmul-form
    paths report the margin e2 / max(dmin, sqrt(e2)) of ``_pdist_e2``: the
    scan replays anything within it through the exact per-point step, so
    every path gives the same scan state.
    """
    if force not in (None, "ref", "exact"):
        raise ValueError(
            f"unknown force={force!r}; expected None, 'ref' or 'exact'")
    dev = resolve_device(device)
    block, centers, cvalid = (
        torch.as_tensor(t, device=dev) for t in (block, centers, cvalid)
    )
    if force == "exact":
        stats = _ref.center_precheck(block, centers, cvalid)
        return (*stats, torch.zeros((), dtype=torch.float32, device=dev))
    if _use_ref(block, force):
        stats = _ref.center_precheck_matmul(block, centers, cvalid)
    else:
        _no_silent_detach("center_precheck", block, centers)
        stats = _precheck.center_precheck_stats(block, centers, cvalid)
    # |sqrt(a) - sqrt(b)| = |a - b| / (sqrt(a) + sqrt(b)), and every center
    # the tie test compares sits at d >= dmin: e2 / dmin bounds the error,
    # and sqrt(e2) where dmin is tiny
    e2 = _pdist_e2(block, centers, cvalid, per_row=True)
    margin = e2 / torch.maximum(stats[0], torch.sqrt(e2))
    return (*stats, margin)


def block_precheck(xb, centers, cvalid, x1, thr: float, r2, *,
                   force: Optional[str] = None, device: DeviceLike = CUDA):
    """The streaming scan's block precheck (K3's fused route): which rows
    of a block must replay the exact per-point step, and each row's
    nearest center.

    (B, d) points, (T, d) centers, (T,) bool valid mask, the open
    threshold ``thr`` and, for the diameter variant, the first stream
    point ``x1`` (d,) and ``r2`` = 2 R (both None for the radius variant)
    -> one (2, B) int32 tensor, the kernel's own output: z, then the flag
    as 0 or 1 (one copy takes both to the host).

    Paths: by default the kernel for a CUDA tensor (one launch, counted
    under ``center_precheck``) and ``ref.block_precheck`` over
    ``center_precheck``'s plain matmul form for a CPU tensor; ``force=
    "ref"`` or ``"exact"`` run ``ref.block_precheck`` over that path of
    ``center_precheck`` on any device. The kernel sums in other orders
    than torch, so its flags may differ from the plain path's within the
    margin and the ``ref.SLACK`` band; a flag only decides a replay, and
    the replay is exact, so every path gives the same scan state.
    """
    if force not in (None, "ref", "exact"):
        raise ValueError(
            f"unknown force={force!r}; expected None, 'ref' or 'exact'")
    if (x1 is None) != (r2 is None):
        raise ValueError("x1 and r2 go together (the diameter variant)")
    dev = resolve_device(device)
    xb, centers, cvalid = (
        torch.as_tensor(t, device=dev) for t in (xb, centers, cvalid)
    )
    if x1 is not None:
        x1 = torch.as_tensor(x1, device=dev)
    if force is None and not _use_ref(xb, None):
        _no_silent_detach("block_precheck", xb, centers)
        return _precheck.block_precheck(
            xb, centers, cvalid, x1, thr, _ref.SLACK * thr,
            0.0 if r2 is None else r2, 0.0 if r2 is None else _ref.SLACK * r2)
    stats = center_precheck(xb, centers, cvalid, force=force, device=dev)
    z, flags = _ref.block_precheck(xb, centers, cvalid, x1, thr, r2, stats)
    return torch.stack((z, flags.to(torch.int32)))


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        force: Optional[str] = None,
                        device: DeviceLike = CUDA):
    """Flash-attention forward (K4). q: (BH, Sq, hd), k/v: (BH, Skv, hd),
    heads expanded and flattened, f32 or bf16. Returns (o (BH, Sq, hd) in
    q's dtype, lse (BH, Sq) f32). The TPU kernel's q/kv block sizes are
    not arguments here: they change no result."""
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(t, device=dev) for t in (q, k, v))
    if _use_ref(q, force):
        return _ref.flash_attention_fwd(q, k, v, causal=causal)
    _no_silent_detach("flash_attention_fwd", q, k, v)
    return _flash.flash_attention_fwd(q, k, v, causal=causal)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        force: Optional[str] = None,
                        device: DeviceLike = CUDA):
    """Flash-attention backward (K5): (dq, dk, dv) in the inputs' dtype
    from q (BH, Sq, hd), k/v (BH, Skv, hd), the forward's o and lse
    (BH, Sq) f32, and the output gradient do (BH, Sq, hd)."""
    dev = resolve_device(device)
    q, k, v, o, lse, do = (torch.as_tensor(t, device=dev)
                           for t in (q, k, v, o, lse, do))
    if _use_ref(q, force):
        return _ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    _no_silent_detach("flash_attention_bwd", q, k, v, o, do)
    return _flash.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)


def ssd_intra_chunk(xbar, loga, B, C, *, force: Optional[str] = None,
                    device: DeviceLike = CUDA):
    """Batched SSD intra-chunk (K6). xbar: (..., q, p), loga: (..., q),
    B/C: (..., q, n), f32, with one or two leading (cell) dims; B and C
    broadcast to xbar's, e.g. as stride-0 views shared by all heads.

    Returns (y_intra (..., q, p), state (..., n, p), decay_from_start
    (..., q), total_decay (...)); the two decays come from a torch cumsum
    here, not from the kernel, as in the reference.
    """
    dev = resolve_device(device)
    xbar, loga, B, C = (torch.as_tensor(t, device=dev)
                        for t in (xbar, loga, B, C))
    if _use_ref(xbar, force):
        y, s = _ref.ssd_intra_chunk(xbar, loga, B, C)
    else:
        _no_silent_detach("ssd_intra_chunk", xbar, loga, B, C)
        y, s = _ssd.ssd_intra_chunk(xbar, loga, B, C)
    cum = torch.cumsum(loga.to(torch.float32), dim=-1)
    return y, s, torch.exp(cum), torch.exp(cum[..., -1])


def ssd_intra_chunk_bwd(xbar, loga, B, C, dy, dstate, *,
                        force: Optional[str] = None,
                        device: DeviceLike = CUDA):
    """Backward of the SSD intra-chunk step (K6b): the vector-Jacobian
    product of ``ssd_intra_chunk``'s (y_intra, state) with their gradients
    dy (..., q, p) and dstate (..., n, p). Takes K6's inputs as K6 takes
    them and returns (dxbar (..., q, p), dloga (..., q), dB, dC), f32, dB
    and dC in B's and C's shapes (summed over the axes along which they
    broadcast, e.g. the heads that share them). The decays' share of
    dloga is the caller's, as the decays are computed outside the kernel.
    """
    dev = resolve_device(device)
    xbar, loga, B, C, dy, dstate = (torch.as_tensor(t, device=dev) for t in
                                    (xbar, loga, B, C, dy, dstate))
    if _use_ref(xbar, force):
        return _ref.ssd_intra_chunk_bwd(xbar, loga, B, C, dy, dstate)
    _no_silent_detach("ssd_intra_chunk_bwd", xbar, loga, B, C, dy, dstate)
    return _ssd_bwd.ssd_intra_chunk_bwd(xbar, loga, B, C, dy, dstate)


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last ``reset_launches``."""
    with LAUNCH_MU:
        return {name: getattr(mod, attr)
                for name, (mod, attr) in _KERNELS.items()}


def reset_launches() -> None:
    with LAUNCH_MU:
        for mod, attr in _KERNELS.values():
            setattr(mod, attr, 0)
