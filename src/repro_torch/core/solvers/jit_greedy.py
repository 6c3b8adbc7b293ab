"""Batched greedy engine for the star/tree variants.

Reference: ``repro/core/solvers/jit_greedy.py``. For star/tree the exact
reference is exhaustive search (``host_exhaustive``) — no polynomial
exact algorithm is known, which is why the paper runs it on the coreset
only. That is still the serving bottleneck for large query bursts, so
this engine offers a *fast approximate* alternative: a batched
objective-greedy — at each step add the feasible candidate maximizing the
resulting set's objective, evaluated with the torch objectives of
``core.diversity`` (``star_div``/``tree_div``) on a masked submatrix.

Because greedy is a heuristic, this engine declares ``exact_parity =
False``: ``engine="auto"`` never picks it. Queries opt in explicitly with
``engine="jit_greedy"`` (or a query's engine hint), keeping the host
exact answer one flag away.

The reference vmaps the objective over the m candidates; here that is one
gather of every candidate's submatrix, (B, m, kmax, kmax) — 21 MB in f32
at B = 16, m = 327, kmax = 32. Feasibility reuses the sum engine's
machinery: counts<caps for uniform/partition, exact masked augmenting
paths for transversal.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..diversity import Variant, star_div, tree_div
from .base import EngineSolution, SolveContext, SolveSpec, SolverEngine
from .jit_sum import (
    _Counts,
    _Matching,
    bucket_pow2,
    engine_device,
    engine_solutions,
    jit_cell_eligible,
    pad_query_arrays,
    partition_arrays,
)
from .matching import cats_onehot


def _masked_star(Dsub: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """star_div over the valid slots only: invalid rows are pushed to +inf
    (never the min), invalid columns contribute 0 to valid rows' sums."""
    vv = valid[..., :, None] & valid[..., None, :]
    D1 = (torch.where(vv, Dsub, 0.0)
          + torch.where(valid, 0.0, torch.inf)[..., :, None])
    return star_div(D1)


def _masked_tree(Dsub: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """tree_div over the valid slots only: invalid slots attach to slot 0
    by a zero-weight edge (adding 0 to the MST) and are unreachable
    otherwise, so Prim's fixed-length loop still spans every slot."""
    vv = valid[..., :, None] & valid[..., None, :]
    D1 = torch.where(vv, Dsub, torch.inf)
    col0 = torch.where(valid, Dsub[..., :, 0], 0.0)
    D1[..., :, 0] = col0
    D1[..., 0, :] = col0
    return tree_div(D1)


_MASKED = {"star": _masked_star, "tree": _masked_tree}


def _candidate_values(D, sel, nsel, variant: str, kmax: int):
    """(B, m): objective of (current selection + candidate v) for every v,
    the candidate sitting in slot ``nsel`` of the padded submatrix."""
    B = sel.shape[0]
    m = D.shape[0]
    slots = torch.arange(kmax, device=D.device)
    at = (slots == nsel[:, None])[:, None, :]  # (B, 1, kmax)
    v = torch.arange(m, device=D.device)[None, :, None]
    idx2 = torch.where(at, v, sel.clamp_min(0)[:, None, :])  # (B, m, kmax)
    Ds = D[idx2[..., :, None], idx2[..., None, :]]  # (B, m, kmax, kmax)
    valid = (slots <= nsel[:, None])[:, None, :].expand(B, m, kmax)
    return _MASKED[variant](Ds, valid)


def _greedy(D, feas, allow, ks, variant: str, kmax: int):
    """Shared greedy loop; ``feas`` supplies the matroid feasibility
    (counts-based or matching-based)."""
    B, m = allow.shape
    rowsum_all = D.sum(1, dtype=torch.float64).to(D.dtype)  # step 0
    ks = ks.long()
    slots = torch.arange(kmax, device=D.device)
    cols = torch.arange(m, device=D.device)
    sel = torch.full((B, kmax), -1, dtype=torch.long, device=D.device)
    selmask = torch.zeros((B, m), dtype=torch.bool, device=D.device)
    nsel = torch.zeros((B,), dtype=torch.long, device=D.device)
    for i in range(kmax):
        can = allow & ~selmask & feas.can()
        vals = _candidate_values(D, sel, nsel, variant, kmax)
        gains = torch.where((nsel == 0)[:, None], rowsum_all, vals)
        v = torch.where(can, gains, -torch.inf).argmax(1)
        take = (i < ks) & can.any(1)
        sel = torch.where(take[:, None] & (slots == nsel[:, None]),
                          v[:, None], sel)
        selmask = selmask | (take[:, None] & (cols == v[:, None]))
        feas.add(v, take)
        nsel = nsel + take.long()
    return sel, nsel


def solve_greedy_batch(
    D: torch.Tensor,  # (m, m)
    cats: torch.Tensor,  # (m,) int single-label (zeros: uniform)
    caps: torch.Tensor,  # (B, h)
    allow: torch.Tensor,  # (B, m)
    ks: torch.Tensor,  # (B,)
    *,
    variant: str,
    kmax: int,
):
    """Batched star/tree greedy under uniform/partition matroids.
    Returns (sel (B, kmax) -1-padded, nsel (B,))."""
    return _greedy(D, _Counts(cats, caps), allow, ks, variant, kmax)


def solve_greedy_batch_transversal(
    D: torch.Tensor,  # (m, m)
    oh: torch.Tensor,  # (m, h) bool
    allow: torch.Tensor,  # (B, m)
    ks: torch.Tensor,  # (B,)
    *,
    variant: str,
    kmax: int,
):
    """Batched star/tree greedy under ONE transversal matroid."""
    feas = _Matching(oh, allow.shape[0], kmax)
    return _greedy(D, feas, allow, ks, variant, kmax)


class JitGreedyBatchEngine(SolverEngine):
    """Registry face of the batched greedy star/tree solvers."""

    name = "jit_greedy"
    priority = 20
    exact_parity = False  # greedy heuristic; host exhaustive is exact

    def supports(self, variant: Variant, matroid_kind: str) -> bool:
        return variant in ("star", "tree") and matroid_kind in (
            "uniform", "partition", "transversal"
        )

    def eligible(self, ctx: SolveContext, spec: SolveSpec) -> bool:
        return jit_cell_eligible(self, ctx, spec)

    def solve_batch(
        self, ctx: SolveContext, specs: Sequence[SolveSpec]
    ) -> list[EngineSolution]:
        dev = engine_device(ctx)

        def put(a):
            return torch.as_tensor(a, device=dev)

        # one batched call per variant present in the group
        by_variant: dict[str, list[int]] = {}
        for i, s in enumerate(specs):
            by_variant.setdefault(s.variant, []).append(i)
        out: list[EngineSolution] = [None] * len(specs)  # type: ignore
        for variant, idxs in by_variant.items():
            group = [specs[i] for i in idxs]
            Bb = bucket_pow2(len(group))
            kmax = bucket_pow2(max(s.k for s in group))
            allow_b, ks, _gammas = pad_query_arrays(ctx, group, Bb)
            if ctx.spec.kind == "transversal":
                oh = cats_onehot(ctx.cats, ctx.spec.num_categories)
                sel, nsel = solve_greedy_batch_transversal(
                    put(ctx.D), put(oh), put(allow_b), put(ks),
                    variant=variant, kmax=kmax,
                )
            else:
                cats1, caps_b = partition_arrays(ctx, group, Bb)
                sel, nsel = solve_greedy_batch(
                    put(ctx.D), put(cats1), put(caps_b), put(allow_b),
                    put(ks), variant=variant, kmax=kmax,
                )
            sols = engine_solutions(ctx, group, sel, nsel, self.name)
            for i, sol in zip(idxs, sols):
                out[i] = sol
        return out
