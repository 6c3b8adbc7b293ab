"""Bipartite matching helpers for transversal matroids.

Reference: ``repro/core/solvers/matching.py``.

* ``cats_onehot`` (:32) and ``greedy_matching_slots`` (:49), the greedy
  witness of the streaming shrink step, run on the host (numpy): the
  witness is a sequential loop over delegate slots, on the host copy of
  one center's labels (SLOT x gamma int32) that the streaming scan keeps.
* The exact augmenting-path primitives of the batched solvers (Kuhn over
  masks, :90-197) are torch, with a leading query dimension B:
  ``reach_matrix``, ``feasible_all``, ``swap_feasible`` and ``augment``.
  A transversal feasibility check is "does an augmenting path from
  candidate v exist given a complete matching of the current selection"
  — the host oracle's ``can_extend`` truth, independent of which complete
  matching is kept, so the batched solvers make the host's accept/reject
  decisions.

Matching representation: ``ms_pt: int64[B, h]`` maps category -> matched
point id (local row of the coreset matrix), -1 if the category is free.
Category incidence is a dense one-hot ``oh: bool[m, h]`` (points on the
left, categories on the right), shared by the batch. Reachability runs as
0/1 float products, exact under any matmul precision. The reference runs
``iters`` fixpoint or BFS steps; a reachable set over h categories stops
growing after at most h steps, so ``min(iters, h)`` steps give the same
answer with fewer launches.
"""
from __future__ import annotations

import numpy as np
import torch


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


# --------------------------------------------------------------------------
# Exact augmenting-path primitives (Kuhn over masks), batched over queries
# --------------------------------------------------------------------------


def reach_matrix(oh: torch.Tensor, ms_pt: torch.Tensor) -> torch.Tensor:
    """bool[..., h, h] one-step alternating reachability between categories.

    M[c, c'] is True iff category c is matched (to point p = ms_pt[c]) and
    p also holds category c' — i.e. an alternating path entering c can
    continue to c' through p.
    """
    return oh[ms_pt.clamp_min(0)] & (ms_pt >= 0)[..., None]


def feasible_all(
    oh: torch.Tensor,  # (m, h) bool point-category incidence
    ms_pt: torch.Tensor,  # (B, h) int64 matching (point id or -1)
    iters: int,  # >= current matching size (kmax is always safe)
) -> torch.Tensor:
    """bool[B, m]: for every query and point v, does an augmenting path
    from v exist? Equivalently: is (current selection) + {v} independent
    in the transversal matroid — the host ``can_extend`` answer for all m
    candidates at once."""
    M = reach_matrix(oh, ms_pt).float()  # (B, h, h)
    free = (ms_pt < 0)[:, None, :]
    reach = oh.expand(ms_pt.shape[0], *oh.shape)
    for _ in range(min(iters, oh.shape[1])):
        reach = reach | (torch.bmm(reach.float(), M) > 0)
    return (reach & free).any(-1)


def swap_feasible(
    oh: torch.Tensor,  # (m, h) bool
    ms_pt: torch.Tensor,  # (B, h) int64
    sel: torch.Tensor,  # (B, kmax) int64 selected point ids (-1 padded)
    v,  # candidate point id: an int, or (B,) int64
) -> torch.Tensor:
    """bool[B, kmax]: for every selected slot j, is X - sel[j] + v
    independent? Variant j frees sel[j]'s matched category, then asks for
    an augmenting path from v. Rows for invalid slots (sel[j] < 0) are
    garbage; callers mask them with ``slots < nsel``."""
    B, kmax = sel.shape
    h = ms_pt.shape[1]
    u = sel.clamp_min(0)
    ms_var = torch.where(ms_pt[:, None, :] == u[:, :, None], -1,
                         ms_pt[:, None, :])  # (B, kmax, h)
    Ms = reach_matrix(oh, ms_var).float().reshape(B * kmax, h, h)
    free = ms_var < 0
    reach = oh[v].expand(B, kmax, h).reshape(B * kmax, 1, h)
    for _ in range(min(kmax, h)):
        reach = reach | (torch.bmm(reach.float(), Ms) > 0)
    return (reach.reshape(B, kmax, h) & free).any(-1)


def augment(
    oh: torch.Tensor,  # (m, h) bool
    ms_pt: torch.Tensor,  # (B, h) int64
    v,  # point id to insert: an int, or (B,) int64
    iters: int,  # >= matching size (kmax is always safe)
) -> torch.Tensor:
    """Insert point v into each query's matching via one augmenting path
    (BFS + flip). Returns the updated ``ms_pt``; a no-op for a query with
    no path (the callers pre-check feasibility, this keeps the masked
    branch safe). The reference's path walk is a while-loop; here it is
    a fixed number of steps with a per-query ``done`` mask: a category
    found at BFS step L is L + 1 steps from v."""
    B, h = ms_pt.shape
    # an int v stays a host scalar: no copy to the device a call
    ohv = oh[v].expand(B, h)
    M = reach_matrix(oh, ms_pt)  # (B, h, h)
    # from_cat[c]: BFS parent category of c (-1: reached directly from v,
    # -2: unvisited)
    from_cat = torch.where(ohv, -1, -2)
    frontier = ohv
    steps = min(iters, h)
    for _ in range(steps):
        cand = frontier[:, :, None] & M  # (B, h, h): edge c -> c'
        new = cand.any(1) & (from_cat == -2)
        parent = cand.to(torch.uint8).argmax(1)  # first parent category
        from_cat = torch.where(new, parent, from_cat)
        frontier = new
    endpoint = (from_cat > -2) & (ms_pt < 0)  # visited AND free
    done = ~endpoint.any(1)
    c = endpoint.to(torch.uint8).argmax(1)
    # walk back from the free endpoint, shifting each matched point one
    # category forward; the category adjacent to v gets v
    ms = ms_pt
    for _ in range(steps + 1):
        cp = from_cat.gather(1, c[:, None])[:, 0]
        moved = torch.where(
            cp < 0, v, ms.gather(1, cp.clamp_min(0)[:, None])[:, 0])
        ms = torch.where(done[:, None], ms,
                         ms.scatter(1, c[:, None], moved[:, None]))
        c = cp.clamp_min(0)
        done = done | (cp < 0)
    return ms
