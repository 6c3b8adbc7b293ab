"""Synthetic Songs-like data, generated on the device from a seed.

The port's own copy of the structure of ``benchmarks/common.py``
(``songs_like``), at the widths of the paper's Songs deployment
(``repro/configs/dmmc_paper.py``: n = 237,698, dim = 5000, a partition
matroid over h = 16 genres of rank about 89): genre sizes from
Dirichlet(0.5), 5-d latent genre centres scaled by 2 and mapped to ``dim``
through a random basis, Gaussian noise of scale 1.2, and per-genre caps
proportional to frequency summing to about 89. The numbers come from a
``torch.Generator`` on ``device``, so they differ from the numpy version.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.matroid import MatroidSpec
from ..device import CUDA, DeviceLike, resolve_device

SONGS_N = 237_698
SONGS_DIM = 5000
SONGS_GENRES = 16
SONGS_RANK = 89


def songs_sim(
    n: int = SONGS_N,
    dim: int = SONGS_DIM,
    *,
    seed: int = 0,
    device: DeviceLike = CUDA,
) -> tuple[torch.Tensor, np.ndarray, np.ndarray, MatroidSpec]:
    """Returns (points f32 (n, dim) on ``device``, cats int32 (n, 1) on the
    host, caps int32 (16,), partition spec)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    h = SONGS_GENRES
    # Dirichlet(0.5): normalised Gamma(1/2) draws, and Gamma(1/2) = Z^2 / 2
    z = torch.randn(h, generator=g, device=dev, dtype=torch.float64)
    sizes = z * z / torch.sum(z * z)
    genre = torch.multinomial(sizes, n, replacement=True, generator=g)
    basis = torch.randn(5, dim, generator=g, device=dev)
    centers = torch.randn(h, 5, generator=g, device=dev) * 2
    points = torch.randn(n, dim, generator=g, device=dev).mul_(1.2)
    points.add_(centers[genre] @ basis)
    counts = torch.bincount(genre, minlength=h).cpu().numpy()
    caps = np.maximum(1, counts / counts.sum() * SONGS_RANK).astype(np.int32)
    cats = genre.to(torch.int32).cpu().numpy()[:, None]
    spec = MatroidSpec("partition", num_categories=h, gamma=1)
    return points, cats, caps, spec
