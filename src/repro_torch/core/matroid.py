"""Matroid representations and host oracles.

Reference: the host half of ``repro/core/matroid.py``: ``MatroidSpec``
(:40), the exact numpy oracles ``Matroid``, ``UniformMatroid``,
``PartitionMatroid``, ``TransversalMatroid`` (Kuhn's augmenting-path
matching, ``_kuhn_try``) and ``GeneralMatroid`` (:55-241), and
``make_host_matroid`` (:331). They run on coreset-sized inputs for the
final-stage solvers and on the EXTRACT step of Algorithm 1. The device
masks of the jit EXTRACT, ``rank_in_group`` and ``partition_extract_mask``
(:248-292), run in torch on the points' device (``core.coreset.
seq_coreset``); ``transversal_extract_mask`` and ``partition_counts_ok``
wait for ROADMAP.md step 11.

Array conventions
-----------------
``cats``: int32[n, gamma] — category ids per point, right-padded with -1.
          Partition/uniform matroids use gamma == 1.
``caps``: int32[h] — per-category budget (partition matroid only; a
          transversal matroid implicitly has cap 1 *per matching*, not per
          category membership).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

# --------------------------------------------------------------------------
# Static spec (hashable)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MatroidSpec:
    kind: str  # 'uniform' | 'partition' | 'transversal' | 'general'
    num_categories: int = 0  # h
    gamma: int = 1  # max categories per point

    def __post_init__(self):
        if self.kind not in ("uniform", "partition", "transversal", "general"):
            raise ValueError(f"unknown matroid kind: {self.kind}")


# --------------------------------------------------------------------------
# Host-side exact oracles (numpy) — used on coreset-sized inputs
# --------------------------------------------------------------------------


class Matroid:
    """Abstract host-side matroid over ground set {0..n-1}."""

    spec: MatroidSpec

    def is_independent(self, idxs: Sequence[int]) -> bool:
        raise NotImplementedError

    def can_extend(self, idxs: Sequence[int], x: int) -> bool:
        """Whether idxs + [x] is independent (idxs assumed independent)."""
        return self.is_independent(list(idxs) + [x])

    def rank_of(self, idxs: Sequence[int]) -> int:
        """Size of a largest independent subset of idxs (matroid greedy)."""
        cur: list[int] = []
        for x in idxs:
            if self.can_extend(cur, x):
                cur.append(x)
        return len(cur)

    def greedy_independent(self, idxs: Sequence[int], k: int) -> list[int]:
        """A largest independent subset of idxs of size <= k (exact for all
        matroids by the greedy property, provided can_extend is exact)."""
        cur: list[int] = []
        for x in idxs:
            if len(cur) >= k:
                break
            if self.can_extend(cur, x):
                cur.append(x)
        return cur

    # subclasses may override with something faster


class UniformMatroid(Matroid):
    def __init__(self, n: int, rank: int):
        self.n = n
        self.rank = rank
        self.spec = MatroidSpec("uniform")

    def is_independent(self, idxs):
        return len(set(idxs)) == len(idxs) and len(idxs) <= self.rank


class PartitionMatroid(Matroid):
    def __init__(self, cats: np.ndarray, caps: np.ndarray):
        cats = np.asarray(cats, np.int32)
        if cats.ndim == 2:
            # extra columns may only carry -1 padding: a partition matroid
            # assigns each element exactly one class — multi-label ground
            # sets are transversal-matroid territory, and truncating the
            # extra labels would silently change the constraint
            if cats.shape[1] > 1 and np.any(cats[:, 1:] >= 0):
                raise ValueError(
                    "partition matroid got multi-label categories "
                    "(a point carries >1 label); use a transversal spec"
                )
            cats = cats[:, 0]
        self.cats = cats
        self.caps = np.asarray(caps, np.int64)
        self.spec = MatroidSpec("partition", num_categories=len(self.caps), gamma=1)

    @property
    def rank(self) -> int:
        counts = np.bincount(self.cats, minlength=len(self.caps))
        return int(np.minimum(counts, self.caps).sum())

    def is_independent(self, idxs):
        idxs = list(idxs)
        if len(set(idxs)) != len(idxs):
            return False
        counts = np.bincount(self.cats[idxs], minlength=len(self.caps))
        return bool(np.all(counts <= self.caps))

    def can_extend(self, idxs, x):
        if x in idxs:
            return False
        c = self.cats[x]
        return int(np.sum(self.cats[list(idxs)] == c)) < int(self.caps[c])


def _kuhn_try(adj: list[list[int]], u: int, match_cat: np.ndarray,
              seen: np.ndarray) -> bool:
    """Augmenting path from point u (iterative DFS, Kuhn's algorithm)."""
    stack = [(u, iter(adj[u]))]
    path: list[tuple[int, int]] = []  # (point, cat) tentative assignments
    while stack:
        node, it = stack[-1]
        advanced = False
        for c in it:
            if seen[c]:
                continue
            seen[c] = True
            w = match_cat[c]
            if w < 0:
                # free category: commit the whole path
                match_cat[c] = node
                for (pu, pc) in reversed(path):
                    match_cat[pc] = pu
                return True
            path.append((node, c))
            stack.append((w, iter(adj[w])))
            advanced = True
            break
        if not advanced:
            stack.pop()
            if path and stack:
                path.pop()
    return False


class TransversalMatroid(Matroid):
    """Transversal matroid from multi-label categories (exact via matching)."""

    def __init__(self, cats: np.ndarray, num_categories: int):
        cats = np.asarray(cats, np.int32)
        if cats.ndim == 1:
            cats = cats[:, None]
        self.cats = cats  # (n, gamma), -1 padded
        self.h = int(num_categories)
        self.spec = MatroidSpec(
            "transversal", num_categories=self.h, gamma=cats.shape[1]
        )

    def _adj(self, idxs) -> list[list[int]]:
        return [[int(c) for c in self.cats[i] if c >= 0] for i in idxs]

    def max_matching(self, idxs: Sequence[int]) -> int:
        adj = self._adj(idxs)
        match_cat = np.full(self.h, -1, np.int64)
        size = 0
        for u in range(len(adj)):
            seen = np.zeros(self.h, bool)
            if _kuhn_try(adj, u, match_cat, seen):
                size += 1
        return size

    def is_independent(self, idxs):
        idxs = list(idxs)
        if len(set(idxs)) != len(idxs):
            return False
        return self.max_matching(idxs) == len(idxs)

    def can_extend(self, idxs, x):
        if x in idxs:
            return False
        return self.is_independent(list(idxs) + [x])

    @property
    def rank(self) -> int:
        return self.max_matching(range(self.cats.shape[0]))

    def greedy_independent(self, idxs, k):
        """Largest <=k independent subset — incremental Kuhn (exact)."""
        idxs = list(idxs)
        adj_all = self._adj(idxs)
        match_cat = np.full(self.h, -1, np.int64)
        chosen: list[int] = []
        adj: list[list[int]] = []
        for local, x in enumerate(idxs):
            if len(chosen) >= k:
                break
            adj.append(adj_all[local])
            seen = np.zeros(self.h, bool)
            if _kuhn_try(adj, len(adj) - 1, match_cat, seen):
                chosen.append(x)
            else:
                # rejected point is always the last entry, so indices stored
                # in match_cat (positions of *accepted* points) stay aligned
                adj.pop()
        return chosen


class GeneralMatroid(Matroid):
    """Wraps a user oracle is_independent(list[int]) -> bool."""

    def __init__(self, n: int, oracle: Callable[[Sequence[int]], bool]):
        self.n = n
        self.oracle = oracle
        self.spec = MatroidSpec("general")

    def is_independent(self, idxs):
        idxs = list(idxs)
        if len(set(idxs)) != len(idxs):
            return False
        return bool(self.oracle(idxs))


# --------------------------------------------------------------------------
# Device masks (static shapes, no host round trip)
# --------------------------------------------------------------------------


def rank_in_group(group_ids: torch.Tensor, valid: torch.Tensor,
                  num_groups: int) -> torch.Tensor:
    """Stream-order rank of every element within its group.

    group_ids: int[m] in [0, num_groups); valid: bool[m]. Returns int32[m];
    invalid entries get rank 2**30. Stable in index order, the paper's
    "first come" extraction semantics.
    """
    m = group_ids.shape[0]
    dev = group_ids.device
    key = torch.where(valid, group_ids.to(torch.int64),
                      num_groups)  # park invalid in the last group
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    idx = torch.arange(m, dtype=torch.int64, device=dev)
    is_start = torch.ones((m,), dtype=torch.bool, device=dev)
    is_start[1:] = sorted_key[1:] != sorted_key[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    ranks = torch.empty((m,), dtype=torch.int64, device=dev)
    ranks[order] = idx - seg_start
    return torch.where(valid, ranks, 2**30).to(torch.int32)


def partition_extract_mask(
    assign: torch.Tensor,  # int[n] cluster id per point
    cats: torch.Tensor,  # int[n, 1]
    caps: torch.Tensor,  # int[h]
    valid: torch.Tensor,  # bool[n]
    k: int,
    tau: int,
    num_categories: int,
) -> torch.Tensor:
    """Exact Thm-1 EXTRACT for partition matroids, all clusters at once:
    the first min(caps[c], k) points of every (cluster, category), then the
    first k survivors of every cluster, in index order."""
    c = cats[:, 0].to(torch.int64)
    gc = assign.to(torch.int64) * num_categories + c
    r_cc = rank_in_group(gc, valid, tau * num_categories)
    stage1 = (r_cc < torch.clamp_max(caps.to(torch.int64)[c], k)) & valid
    r_cl = rank_in_group(assign, stage1, tau)
    return stage1 & (r_cl < k)


# --------------------------------------------------------------------------
# Builders
# --------------------------------------------------------------------------


def make_host_matroid(spec: MatroidSpec, cats: Optional[np.ndarray],
                      caps: Optional[np.ndarray], n: int,
                      k: int, oracle=None) -> Matroid:
    if spec.kind == "uniform":
        return UniformMatroid(n, k)
    if spec.kind == "partition":
        return PartitionMatroid(np.asarray(cats), np.asarray(caps))
    if spec.kind == "transversal":
        return TransversalMatroid(np.asarray(cats), spec.num_categories)
    if spec.kind == "general":
        if oracle is None:
            raise ValueError("general matroid needs a host oracle")
        return GeneralMatroid(n, oracle)
    raise ValueError(spec.kind)
