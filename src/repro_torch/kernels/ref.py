"""Plain PyTorch versions of the hand-written kernels.

Reference: ``repro/kernels/ref.py`` (``pairwise_sqdist`` and
``gmm_update``). These are the CPU path of ``ops`` and the oracle that the
CUDA/Triton kernels are held against on the card (``force="ref"``).
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
