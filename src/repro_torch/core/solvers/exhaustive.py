"""Exhaustive DMMC solver (paper §4.4): exact best independent k-subset.

Reference: ``repro/core/solvers/exhaustive.py``, copied: it is numpy only.

For the star/tree/cycle/bipartition variants no polynomial constant-factor
approximation is known, so the paper runs exhaustive search *on the coreset*
(|T| independent of n) — we do the same. DFS over independent sets with
matroid pruning (hereditary property: any extension of a dependent set is
dependent, so subtrees are cut early).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..diversity import Variant, diversity
from ..matroid import Matroid


def exhaustive_best(
    D: np.ndarray,
    matroid: Matroid,
    k: int,
    idxs: Sequence[int],
    variant: Variant,
    *,
    max_nodes: int = 2_000_000,
) -> tuple[list[int], float, bool]:
    """Returns (best subset, best diversity, completed flag).

    completed=False means the node budget was hit (result is best-so-far).
    """
    idxs = [int(i) for i in idxs]
    m = len(idxs)
    best_set: list[int] = []
    best_val = -1.0
    nodes = 0
    complete = True

    cur: list[int] = []

    def rec(start: int) -> None:
        nonlocal best_set, best_val, nodes, complete
        if nodes >= max_nodes:
            complete = False
            return
        nodes += 1
        if len(cur) == k:
            val = diversity(D[np.ix_(cur, cur)], variant)
            if val > best_val:
                best_val = val
                best_set = list(cur)
            return
        # not enough points left to reach k
        if m - start < k - len(cur):
            return
        for pos in range(start, m):
            v = idxs[pos]
            if matroid.can_extend(cur, v):
                cur.append(v)
                rec(pos + 1)
                cur.pop()
                if nodes >= max_nodes:
                    return

    rec(0)
    return best_set, max(best_val, 0.0), complete
