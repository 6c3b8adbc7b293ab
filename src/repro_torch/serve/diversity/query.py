"""Query/result types for the diversity service.

Reference: ``repro/serve/diversity/query.py`` (numpy only; the port keeps
its own copy). A query can nudge engine selection with ``engine_hint`` (e.g. ``"jit_greedy"`` to trade the exact
star/tree answer for the fast batched greedy); hints that don't apply
fall back to the auto policy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ...core.diversity import Variant


@dataclasses.dataclass(frozen=True)
class DiversityQuery:
    """One diversity request against the current coreset.

    caps         per-query partition caps override (defaults to the tenant's)
    allowed_cats restrict candidates to points carrying one of these categories
    gamma        local-search improvement threshold (sum variant only)
    engine_hint  prefer this registry engine for this query (soft: ignored
                 when ineligible; engines without the host-parity guarantee,
                 like "jit_greedy", are only ever used via a hint or an
                 explicit engine= argument)
    """

    k: int
    variant: Variant = "sum"
    caps: Optional[tuple[int, ...]] = None
    allowed_cats: Optional[frozenset[int]] = None
    gamma: float = 0.0
    engine_hint: Optional[str] = None


@dataclasses.dataclass
class QueryResult:
    indices: np.ndarray  # selected global stream ids (solver order)
    local_indices: np.ndarray  # rows of the cached coreset matrix
    diversity: float
    variant: str
    engine: str  # registry engine name ("jit_sum", "host_exhaustive", ...)
    coreset_size: int
    from_cache: bool
    # the published EpochSnapshot that answered (-1: none) and the tenant
    # whose cache entry served it
    epoch: int = -1
    tenant: Optional[str] = None
    # deadline-aware admission (query_batch(deadline_s=...)): degraded --
    # answered by a faster non-parity engine (jit_greedy) because the exact
    # engine's predicted latency missed the deadline; shed -- not solved
    # (indices empty, engine="shed"): no engine was predicted in time
    degraded: bool = False
    shed: bool = False


def candidate_mask(
    cats: np.ndarray, allowed: Optional[frozenset[int]]
) -> np.ndarray:
    """bool[m] mask of coreset rows passing the query's category filter."""
    m, _ = cats.shape
    if allowed is None:
        return np.ones((m,), bool)
    hit = np.isin(cats, np.fromiter(allowed, np.int32, len(allowed)))
    return np.any(hit & (cats >= 0), axis=1)
