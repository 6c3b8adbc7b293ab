"""Distance primitives for the DMMC framework.

Reference: ``repro/core/geometry.py``. All pairwise work is phrased as
``||x||^2 + ||y||^2 - 2 x.y``; these torch forms run on whatever device
their inputs live on (the tiled kernel is ``kernels/pdist``).

Supported metrics
-----------------
``sqeuclidean``  squared Euclidean (NOT a metric; internal use only).
``euclidean``    L2 distance.
``cosine``       the *metric* version of cosine distance used by the paper:
                 L2-normalize inputs once and use the Euclidean distance on
                 the sphere, which induces the same ordering as angular
                 distance.
"""
from __future__ import annotations

from typing import Literal

import torch

Metric = Literal["euclidean", "cosine", "sqeuclidean"]

_EPS = 1e-12


def normalize_for_metric(x: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Preprocess points so downstream code can use plain L2 geometry."""
    if metric == "cosine":
        n = torch.sqrt(
            torch.clamp_min(torch.sum(x * x, dim=-1, keepdim=True), _EPS)
        )
        return x / n
    return x


def sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances. x: (n, d), y: (m, d) -> (n, m)."""
    xn = torch.sum(x * x, dim=-1)
    yn = torch.sum(y * y, dim=-1)
    d2 = xn[:, None] + yn[None, :] - 2.0 * (x @ y.T)
    return torch.clamp_min(d2, 0.0)


def dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distances (n, m)."""
    return torch.sqrt(sq_dists(x, y))


def point_dists(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Distances of every row of x (n, d) to a single point z (d,) -> (n,)."""
    diff = x - z[None, :]
    return torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0))


def pairwise_matrix(x: torch.Tensor) -> torch.Tensor:
    """Full symmetric distance matrix of a point set (k, d) -> (k, k)."""
    d = dists(x, x)
    # exact zeros on the diagonal despite float error
    eye = torch.eye(x.shape[0], dtype=d.dtype, device=d.device)
    return d * (1.0 - eye)


def diameter_lower_bound(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """2-approximate diameter: delta = max_j d(x_0, x_j) in [Delta/2, Delta].

    This is the paper's ``delta = d(z1, z2)`` quantity (Alg. 1): the distance
    from an arbitrary anchor to the farthest point.
    """
    d0 = point_dists(x, x[0])
    d0 = torch.where(valid, d0, torch.tensor(-torch.inf, dtype=x.dtype,
                                             device=x.device))
    return torch.max(d0)
