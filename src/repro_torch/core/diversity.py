"""Diversity objectives of Table 1 and their combinatorics.

Reference: ``repro/core/diversity.py``: ``f_of_k``,
``farness_lower_bound``, the TSP and bipartition helpers, ``diversity``
(:197) and ``diversity_of_points``, numpy versions that are the
solver-facing oracles (exact for small k, with clearly-flagged heuristics
for NP-hard evaluations beyond exact thresholds); and the torch twins of
the jnp objectives ``sum_div``, ``star_div``, ``tree_div`` (:57-86) and
``jnp_diversity`` (:92, here ``torch_diversity``), which the batched
greedy engine evaluates on the device.
"""
from __future__ import annotations

import itertools
from typing import Literal

import numpy as np
import torch

from ..device import CUDA, DeviceLike, resolve_device

Variant = Literal["sum", "star", "tree", "cycle", "bipartition"]
VARIANTS: tuple[Variant, ...] = ("sum", "star", "tree", "cycle", "bipartition")

EXACT_CYCLE_MAX_K = 12  # Held-Karp 2^k * k^2
EXACT_BIPARTITION_MAX_K = 16  # C(16, 8) = 12870 subsets


def f_of_k(variant: Variant, k: int) -> int:
    """Number of pairwise distances contributing to div (paper §3)."""
    if variant == "sum":
        return k * (k - 1) // 2
    if variant in ("star", "tree"):
        return k - 1
    if variant == "cycle":
        return k
    if variant == "bipartition":
        return (k // 2) * ((k + 1) // 2)
    raise ValueError(variant)


def farness_lower_bound(delta: float, k: int, variant: Variant) -> float:
    """Lemma 1: rho_{S,k} >= c(variant) * Delta_S."""
    if variant == "sum":
        return delta / (2 * k)
    if variant == "star":
        return delta / (4 * (k - 1))
    if variant == "tree":
        return delta / (2 * (k - 1))
    if variant == "cycle":
        return delta / k
    if variant == "bipartition":
        return delta / (2 * (k + 1))
    raise ValueError(variant)


# --------------------------------------------------------------------------
# torch objectives on a distance matrix D: (..., k, k), batched over the
# leading dims. Sums accumulate in float64 and round once to D's dtype,
# so the result rarely depends on the reduction order the device or the
# batch shape picks (the float64 sum is exact while the f32 terms span
# fewer than about 29 - log2(terms) binary orders of magnitude).
# --------------------------------------------------------------------------


def sum_div(D: torch.Tensor) -> torch.Tensor:
    return (D.sum((-2, -1), dtype=torch.float64) / 2.0).to(D.dtype)


def star_div(D: torch.Tensor) -> torch.Tensor:
    return D.sum(-1, dtype=torch.float64).min(-1).values.to(D.dtype)


def tree_div(D: torch.Tensor) -> torch.Tensor:
    """MST weight via Prim's algorithm, O(k^2): k - 1 fixed steps, each
    adding the cheapest vertex outside the tree (first index on ties)."""
    k = D.shape[-1]
    in_tree = torch.zeros(D.shape[:-1], dtype=torch.bool, device=D.device)
    in_tree[..., 0] = True
    best = D[..., 0, :]
    total = torch.zeros(D.shape[:-2], dtype=torch.float64, device=D.device)
    for _ in range(k - 1):
        masked = torch.where(in_tree, torch.inf, best)
        j = masked.argmin(-1, keepdim=True)
        total = total + masked.gather(-1, j)[..., 0]
        in_tree = in_tree.scatter(-1, j, True)
        row = D.gather(-2, j[..., None].expand(*j.shape[:-1], 1, k))
        best = torch.minimum(best, row[..., 0, :])
    return total.to(D.dtype)


_TORCH_OBJECTIVES = {"sum": sum_div, "star": star_div, "tree": tree_div}


def torch_diversity(D: torch.Tensor, variant: Variant) -> torch.Tensor:
    """Twin of the reference's ``jnp_diversity``."""
    if variant not in _TORCH_OBJECTIVES:
        raise ValueError(
            f"{variant} is NP-hard to evaluate; use host diversity() instead"
        )
    return _TORCH_OBJECTIVES[variant](D)


# --------------------------------------------------------------------------
# Host objectives (exact small-k; flagged heuristics beyond)
# --------------------------------------------------------------------------


def _tsp_held_karp(D: np.ndarray) -> float:
    k = D.shape[0]
    if k == 1:
        return 0.0
    if k == 2:
        return float(2.0 * D[0, 1])
    full = 1 << (k - 1)  # subsets of {1..k-1}; city 0 is the anchor
    dp = np.full((full, k - 1), np.inf)
    for j in range(k - 1):
        dp[1 << j, j] = D[0, j + 1]
    for mask in range(1, full):
        for j in range(k - 1):
            cur = dp[mask, j]
            if not np.isfinite(cur) or not (mask >> j) & 1:
                continue
            rest = ~mask & (full - 1)
            m = rest
            while m:
                nxt = (m & -m).bit_length() - 1
                nm = mask | (1 << nxt)
                val = cur + D[j + 1, nxt + 1]
                if val < dp[nm, nxt]:
                    dp[nm, nxt] = val
                m &= m - 1
    best = np.inf
    for j in range(k - 1):
        best = min(best, dp[full - 1, j] + D[j + 1, 0])
    return float(best)


def _tsp_heuristic(D: np.ndarray) -> float:
    """Nearest-neighbour + 2-opt. Flagged approximate (used only for k > 12)."""
    k = D.shape[0]
    tour = [0]
    unvisited = set(range(1, k))
    while unvisited:
        last = tour[-1]
        nxt = min(unvisited, key=lambda j: D[last, j])
        tour.append(nxt)
        unvisited.remove(nxt)
    improved = True
    while improved:
        improved = False
        for i in range(1, k - 1):
            for j in range(i + 1, k):
                a, b = tour[i - 1], tour[i]
                c, d = tour[j], tour[(j + 1) % k]
                if D[a, c] + D[b, d] < D[a, b] + D[c, d] - 1e-12:
                    tour[i : j + 1] = tour[i : j + 1][::-1]
                    improved = True
    return float(sum(D[tour[i], tour[(i + 1) % k]] for i in range(k)))


def _bipartition_exact(D: np.ndarray) -> float:
    k = D.shape[0]
    half = k // 2
    idx = list(range(k))
    best = np.inf
    # fix element 0 in Q's complement to halve the enumeration when k even
    for q in itertools.combinations(idx[1:] if k % 2 == 0 else idx, half):
        q = list(q)
        mask = np.zeros(k, bool)
        mask[q] = True
        cut = float(D[mask][:, ~mask].sum())
        best = min(best, cut)
    return best


def _bipartition_heuristic(D: np.ndarray) -> float:
    """Greedy + single-swap descent (Kernighan-Lin style), flagged approx."""
    k = D.shape[0]
    half = k // 2
    rng = np.random.default_rng(0)
    best = np.inf
    for _ in range(8):
        mask = np.zeros(k, bool)
        mask[rng.choice(k, half, replace=False)] = True
        improved = True
        while improved:
            improved = False
            cut = float(D[mask][:, ~mask].sum())
            for i in np.flatnonzero(mask):
                for j in np.flatnonzero(~mask):
                    m2 = mask.copy()
                    m2[i], m2[j] = False, True
                    c2 = float(D[m2][:, ~m2].sum())
                    if c2 < cut - 1e-12:
                        mask, cut, improved = m2, c2, True
        best = min(best, cut)
    return best


def diversity(D: np.ndarray, variant: Variant) -> float:
    """Host-side objective value for point set with distance matrix D."""
    D = np.asarray(D, np.float64)
    k = D.shape[0]
    if k <= 1:
        return 0.0
    if variant == "sum":
        return float(np.sum(D) / 2.0)
    if variant == "star":
        return float(np.min(np.sum(D, axis=1)))
    if variant == "tree":
        # Prim
        in_tree = np.zeros(k, bool)
        in_tree[0] = True
        best = D[0].copy()
        total = 0.0
        for _ in range(k - 1):
            best_m = np.where(in_tree, np.inf, best)
            j = int(np.argmin(best_m))
            total += best_m[j]
            in_tree[j] = True
            best = np.minimum(best, D[j])
        return float(total)
    if variant == "cycle":
        if k <= EXACT_CYCLE_MAX_K:
            return _tsp_held_karp(D)
        return _tsp_heuristic(D)
    if variant == "bipartition":
        if k <= EXACT_BIPARTITION_MAX_K:
            return _bipartition_exact(D)
        return _bipartition_heuristic(D)
    raise ValueError(variant)


def diversity_of_points(points, variant: Variant, *,
                        device: DeviceLike = CUDA) -> float:
    from .geometry import pairwise_matrix

    pts = torch.as_tensor(points, device=resolve_device(device))
    D = pairwise_matrix(pts).cpu().numpy()
    return diversity(D, variant)
