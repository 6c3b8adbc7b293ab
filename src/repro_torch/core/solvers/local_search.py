"""AMT local search for sum-DMMC (Abbassi-Mirrokni-Thakur, KDD'13).

Reference: ``repro/core/solvers/local_search.py``, copied: it is numpy only.

The paper's final-stage solver for the sum variant: start from an arbitrary
(here: greedy) independent set of size k, repeatedly swap a solution point u
for an outside point v whenever X - u + v is independent and improves the sum
diversity by a factor >= (1 + gamma); gamma=0 keeps swapping while there is
any strict improvement (what the paper uses on coresets, footnote 5).

Runs on host over a precomputed distance matrix — the whole point of the
paper is that this expensive step touches only the coreset, never S.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..matroid import Matroid


def greedy_init(
    D: np.ndarray, matroid: Matroid, k: int, idxs: Sequence[int]
) -> list[int]:
    """Greedy independent set maximizing marginal sum-of-distances."""
    chosen: list[int] = []
    cand = list(idxs)
    # seed with the point of max eccentricity to its farthest feasible mate
    while len(chosen) < k:
        best, best_gain = None, -1.0
        for v in cand:
            if v in chosen or not matroid.can_extend(chosen, v):
                continue
            gain = float(D[v, chosen].sum()) if chosen else float(D[v].sum())
            if gain > best_gain:
                best, best_gain = v, gain
        if best is None:
            break
        chosen.append(best)
    return chosen


def local_search_sum(
    D: np.ndarray,
    matroid: Matroid,
    k: int,
    idxs: Sequence[int],
    *,
    gamma: float = 0.0,
    max_sweeps: int = 64,
    init: Optional[Sequence[int]] = None,
) -> tuple[list[int], float, int]:
    """Returns (solution indices, sum diversity, #swaps performed).

    D is the full distance matrix over the ground set; idxs restricts the
    search to a subset (e.g. the coreset's members).
    """
    idxs = [int(i) for i in idxs]
    X = list(init) if init is not None else greedy_init(D, matroid, k, idxs)
    if len(X) < k:
        return X, float(D[np.ix_(X, X)].sum() / 2.0), 0

    inside = set(X)
    div = float(D[np.ix_(X, X)].sum() / 2.0)
    swaps = 0
    for _ in range(max_sweeps):
        improved = False
        # row sums of D restricted to X, for O(1) swap deltas
        row = {u: float(D[u, X].sum()) for u in X}
        for v in idxs:
            if v in inside:
                continue
            dv = float(D[v, X].sum())
            for u in list(X):
                # div(X - u + v) = div - row[u] + dv - d(u, v)
                new_div = div - row[u] + dv - float(D[u, v])
                if new_div <= div * (1.0 + gamma) or new_div <= div:
                    continue
                Xm = [w for w in X if w != u] + [v]
                if not matroid.is_independent(Xm):
                    continue
                X = Xm
                inside.discard(u)
                inside.add(v)
                div = new_div
                swaps += 1
                row = {w: float(D[w, X].sum()) for w in X}
                improved = True
                break
        if not improved:
            break
    return X, div, swaps
