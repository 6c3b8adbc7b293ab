"""Plain PyTorch versions of the hand-written kernels.

Reference: ``repro/kernels/ref.py`` (``pairwise_sqdist``, ``gmm_update``,
and the precheck oracles ``_nearest_stats`` :31, ``center_precheck`` :59,
``center_precheck_matmul`` :79). These are the CPU path of ``ops`` and the
oracle that the CUDA/Triton kernels are held against on the card
(``force="ref"``).
"""
from __future__ import annotations

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, d), (m, d) -> (n, m) squared Euclidean distances, f32 accumulate."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xn = torch.sum(x * x, dim=-1)
    yn = torch.sum(y * y, dim=-1)
    d2 = xn[:, None] + yn[None, :] - 2.0 * (x @ y.T)
    return torch.clamp_min(d2, 0.0)


def gmm_update(
    x: torch.Tensor,  # (n, d)
    z: torch.Tensor,  # (d,)
    min_dist: torch.Tensor,  # (n,) f32
    valid: torch.Tensor,  # (n,) bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (new_min (n,), far_idx int32, far_val f32) as device tensors.

    new_min[i] = min(min_dist[i], d(x_i, z)); far = argmax over valid points
    of new_min, invalid rows counting as -1. ``torch.argmax`` returns the
    first maximum, the same tie rule as ``jnp.argmax``.
    """
    x = x.to(torch.float32)
    z = z.to(torch.float32)
    diff = x - z[None, :]
    d = torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0))
    new_min = torch.minimum(min_dist, d)
    masked = torch.where(valid, new_min, -1.0)
    far_idx = torch.argmax(masked).to(torch.int32)
    far_val = masked[far_idx.long()]
    return new_min, far_idx, far_val


_F32_MAX = float(torch.finfo(torch.float32).max)


def _nearest_stats(
    d: torch.Tensor,  # (B, T) masked distances
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """(dmin, z, second, z2, third) row reduction shared by both precheck
    oracles (reference ``repro/kernels/ref.py:_nearest_stats``): the three
    smallest distances and the indices of the two smallest, each the first
    column attaining its minimum (``jnp.argmin``'s tie rule). ``z`` is
    excluded from ``second`` by setting its column to float32 max, so a row
    with a single finite column gets ``second`` = max and ``z2`` = 0."""
    tcap = d.shape[1]
    cols = torch.arange(tcap, dtype=torch.int32, device=d.device)[None, :]
    big = torch.tensor(_F32_MAX, dtype=d.dtype, device=d.device)
    dmin = torch.amin(d, dim=1, keepdim=True)
    z = torch.amin(torch.where(d == dmin, cols, tcap), dim=1, keepdim=True)
    d_noz = torch.where(cols == z, big, d)
    second = torch.amin(d_noz, dim=1, keepdim=True)
    z2 = torch.amin(torch.where(d_noz == second, cols, tcap), dim=1,
                    keepdim=True)
    third = torch.amin(torch.where(cols == z2, big, d_noz), dim=1)
    return (dmin[:, 0], z[:, 0].to(torch.int32), second[:, 0],
            z2[:, 0].to(torch.int32), third)


def _masked(d: torch.Tensor, cvalid: torch.Tensor) -> torch.Tensor:
    return torch.where(cvalid[None, :], d,
                       torch.tensor(_F32_MAX, dtype=d.dtype, device=d.device))


def center_precheck(
    block: torch.Tensor,  # (B, d)
    centers: torch.Tensor,  # (T, d)
    cvalid: torch.Tensor,  # (T,) bool
):
    """Exact oracle (reference ``center_precheck``): the per-point broadcast
    arithmetic of ``core.streaming._dists_to_centers`` for every row, then
    ``_nearest_stats``. Materialises a (B, T, d) tensor; margin 0."""
    diff = centers[None, :, :] - block[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    return _nearest_stats(_masked(torch.sqrt(torch.clamp_min(d2, 0.0)),
                                  cvalid))


def center_precheck_matmul(
    block: torch.Tensor,  # (B, d)
    centers: torch.Tensor,  # (T, d)
    cvalid: torch.Tensor,  # (T,) bool
):
    """Matmul-form precheck (reference ``center_precheck_matmul``), the
    plain version of kernel K3: ||x||^2 + ||c||^2 - 2 x.c in f32, clamped,
    sqrt, invalid centers at float32 max, then ``_nearest_stats``. Subject
    to cancellation error; callers pair it with ``ops._pdist_e2``'s
    margin."""
    block = block.to(torch.float32)
    centers = centers.to(torch.float32)
    xn = torch.sum(block * block, dim=1)
    cn = torch.sum(centers * centers, dim=1)
    d2 = xn[:, None] + cn[None, :] - 2.0 * (block @ centers.T)
    return _nearest_stats(_masked(torch.sqrt(torch.clamp_min(d2, 0.0)),
                                  cvalid))
