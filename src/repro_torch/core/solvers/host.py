"""Host (numpy) reference engines — the paper's final-stage solvers.

Reference: ``repro/core/solvers/host.py``, copied: it is numpy only.

These are the parity anchors of the registry: every other engine's
``exact_parity`` claim is "same selections as the host engine on the same
matrix". They need a host matroid oracle (``ctx.matroid_fn``), so they
cover *every* matroid kind, including general oracles no jit engine can.

* ``host_local_search`` — AMT local search (footnote 5), sum variant,
  any matroid.
* ``host_exhaustive`` — exact DFS with matroid pruning (§4.4), the
  star/tree/cycle/bipartition variants, any matroid.

``engine="host"`` (the pre-registry spelling) resolves to whichever of
the two covers the requested variant — i.e. exactly the historical
``final_solve`` dispatch.
"""
from __future__ import annotations

import numpy as np

from ..diversity import Variant
from .base import (
    EngineSolution,
    SolveContext,
    SolveSpec,
    SolverEngine,
    selection_value,
)
from .exhaustive import exhaustive_best
from .local_search import local_search_sum


def _require_matroid(ctx: SolveContext, engine: str):
    if ctx.matroid_fn is None:
        raise ValueError(
            f"engine {engine!r} needs a host matroid oracle "
            f"(SolveContext.matroid_fn)"
        )
    return ctx.matroid_fn


class HostLocalSearchEngine(SolverEngine):
    """AMT local search on the precomputed coreset matrix (sum only)."""

    name = "host_local_search"
    priority = 90
    exact_parity = True  # it IS the reference

    def supports(self, variant: Variant, matroid_kind: str) -> bool:
        return variant == "sum"

    def eligible(self, ctx: SolveContext, spec: SolveSpec) -> bool:
        return (
            self.supports(spec.variant, ctx.spec.kind)
            and ctx.matroid_fn is not None
        )

    def solve_one(self, ctx: SolveContext, spec: SolveSpec) -> EngineSolution:
        matroid = _require_matroid(ctx, self.name)(spec)
        idxs = spec.candidate_idxs(ctx.size)
        X, _val, _swaps = local_search_sum(
            ctx.D, matroid, spec.k, idxs, gamma=spec.gamma
        )
        return EngineSolution(
            local_indices=np.asarray(X, np.int64),
            value=selection_value(ctx.D, X, spec.variant),
            engine=self.name,
        )


class HostExhaustiveEngine(SolverEngine):
    """Exact DFS over independent sets (non-sum variants)."""

    name = "host_exhaustive"
    priority = 95
    exact_parity = True

    def supports(self, variant: Variant, matroid_kind: str) -> bool:
        return variant != "sum"

    def eligible(self, ctx: SolveContext, spec: SolveSpec) -> bool:
        return (
            self.supports(spec.variant, ctx.spec.kind)
            and ctx.matroid_fn is not None
        )

    def solve_one(self, ctx: SolveContext, spec: SolveSpec) -> EngineSolution:
        matroid = _require_matroid(ctx, self.name)(spec)
        idxs = spec.candidate_idxs(ctx.size)
        X, _val, _complete = exhaustive_best(
            ctx.D, matroid, spec.k, idxs, spec.variant
        )
        return EngineSolution(
            local_indices=np.asarray(X, np.int64),
            value=selection_value(ctx.D, X, spec.variant),
            engine=self.name,
        )
