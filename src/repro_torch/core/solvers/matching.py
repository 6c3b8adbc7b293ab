"""Bipartite matching helpers for transversal matroids (host, numpy).

Reference: ``repro/core/solvers/matching.py``: ``cats_onehot`` (:32) and
``greedy_matching_slots`` (:49), the greedy witness of the streaming
shrink step. The witness is a sequential loop over delegate slots, so it
runs on the host copy of one center's labels (SLOT x gamma int32) that the
streaming scan keeps. The exact augmenting-path primitives of the batched
solvers (``reach_matrix``, ``feasible_all``, ``swap_feasible``,
``augment``) come with the batched engines (ROADMAP step 6).
"""
from __future__ import annotations

import numpy as np


def cats_onehot(cats: np.ndarray, num_categories: int) -> np.ndarray:
    """(m, gamma) -1-padded label matrix -> bool[m, h] incidence."""
    cats = np.asarray(cats, np.int64)
    if cats.ndim == 1:
        cats = cats[:, None]
    m = cats.shape[0]
    oh = np.zeros((m, num_categories), bool)
    rows, cols = np.nonzero(cats >= 0)
    oh[rows, cats[rows, cols]] = True
    return oh


def greedy_matching_slots(
    cats: np.ndarray,  # (SLOT, gamma) int32, -1 padded
    valid: np.ndarray,  # (SLOT,) bool
    num_categories: int,
) -> tuple[np.ndarray, np.ndarray]:
    """First-free-category greedy matching over slot order.

    Returns (used: bool[h] categories consumed, matched: bool[SLOT] slots
    that found a category). A label >= h reads ``used[h - 1]`` and marks
    nothing, as the reference's clamped gather and dropped scatter do.
    """
    cats = np.asarray(cats)
    used = np.zeros(num_categories, bool)
    matched = np.zeros(cats.shape[0], bool)
    for s in np.flatnonzero(valid):
        row = cats[s]
        free = (row >= 0) & ~used[np.clip(row, 0, num_categories - 1)]
        if free.any():
            cat = int(row[int(np.argmax(free))])
            if cat < num_categories:
                used[cat] = True
            matched[s] = True
    return used, matched
