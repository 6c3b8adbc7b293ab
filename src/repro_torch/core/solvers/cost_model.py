"""Calibrated engine cost model: what will this solve_batch call cost?

Reference: ``repro/core/solvers/cost_model.py``, copied: it is
framework-free. Its seeds are the reference's CPU priors, unchanged, so
the port routes as the reference does; calibrating them for the card
comes with the serving frontend, which feeds ``observe``. Until then
they route the wrong way on the card: at B = 1, m = 327, kmax = 32 they
price ``jit_sum`` at ~0.009 s and the host engine at ~0.6 s, where one
H100 measured ~0.96 s and ~0.03 s (``PERF.md`` §7).

``engine="auto"`` used to mean "the fastest eligible parity engine" with
*fastest* hard-coded as a priority integer on each engine class. That
ordering encodes one machine's folklore: jit engines amortize one device
dispatch over the whole vmapped batch, host engines pay pure-python cost
per query but no dispatch — so the truth is a crossover, not a ranking.
Which side of the crossover a request lands on depends on the batch size
``B``, the (bucketed) ``kmax`` and the coreset size ``m``, and on what
the hardware actually measures — exactly the solver-selection tradeoff
Cevallos et al. frame for the convex/local-search engines.

``CostModel.estimate(engine, B, kmax, m)`` predicts the wall seconds of
one ``solve_batch`` call:

* **static seeds** — per-engine parametric models
  ``dispatch + B * per_query(kmax, m)`` whose constants are calibrated
  offline against the committed ``BENCH_serve.json`` per-engine QPS
  numbers (CPU host). They reproduce the historical priority ordering at
  bench scale and put the host/jit crossover where dispatch genuinely
  dominates (tiny ``B`` x small ``m``);
* **online refinement** — every measured solve feeds
  ``observe(engine, B, kmax, m, seconds)`` (the serving frontend calls
  it with the same wall it records into its latency histograms); an
  EMA per pow-2-bucketed ``(engine, B, kmax, m)`` cell overrides the
  seed, and near-miss cells extrapolate from the nearest measured ``B``
  bucket along the seed model's shape. The crossover is *measured*, not
  asserted — ``crossover()`` reports where it currently sits.

Routing decisions made from these estimates are recorded in a bounded
ring (``decisions()``) with the per-engine estimates that drove them, so
``engine="auto"`` is auditable after the fact.

Thread-safe; one instance per ``QueryFrontend`` (a process-global
``default_cost_model()`` exists for registry-level callers).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import math
import threading
from typing import Optional, Sequence

_log = logging.getLogger(__name__)

# EMA weight of one new observation against the cell's running estimate
_ALPHA = 0.25
# decision audit ring size
_DECISIONS = 256


def _bucket_pow2(n: int) -> int:
    """Next power of two >= n (>= 1) — the same shape bucketing the jit
    solvers use, so cost cells and compile-cache keys line up."""
    return 1 << max(0, int(n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class EngineSeed:
    """Static parametric prior for one engine:
    ``t(B) = dispatch_s + B * (per_query_s + coef_s * m**m_exp * min(kmax, k_cap))``.

    ``m_exp``/``k_cap`` express how the engine's per-query marginal cost
    scales: the local-search engines sweep the (m, m) matrix per swap
    (quadratic in m, linear in k), exhaustive DFS explodes with k so its
    exponent is k itself, capped to keep the prior finite — past the cap
    the estimate is "always lose", which is the right routing answer.
    """

    dispatch_s: float
    per_query_s: float
    coef_s: float
    m_exp: float = 2.0
    k_cap: int = 64
    k_is_exponent: bool = False

    def per_query(self, kmax: int, m: int) -> float:
        k = min(int(kmax), self.k_cap)
        if self.k_is_exponent:
            return self.per_query_s + self.coef_s * float(m) ** k
        return self.per_query_s + self.coef_s * float(m) ** self.m_exp * k

    def estimate(self, B: int, kmax: int, m: int) -> float:
        return self.dispatch_s + B * self.per_query(kmax, m)


# CPU priors, not the card's: the reference's seeds, calibrated against
# the committed BENCH_serve.json quick-config per-engine QPS of the JAX
# package (m ~= 43, kmax <= 8, on a CPU host). PERF.md has the port's
# per-engine times on the H100.
#   jit_sum   4530 qps @ B=32 -> ~7 ms/batch, dispatch-dominated
#   host_ls    363 qps @ B=32 -> ~2.8 ms/query, no meaningful dispatch
#   jit_greedy 2481 qps @ B=8 -> ~3.2 ms/batch
#   host_exh   2.8 qps @ B=8, k=3 -> ~0.36 s/query (C(m,k) DFS)
_SEEDS: dict[str, EngineSeed] = {
    "jit_sum": EngineSeed(
        dispatch_s=2.0e-3, per_query_s=5.0e-5, coef_s=2.0e-9
    ),
    "jit_greedy": EngineSeed(
        dispatch_s=2.0e-3, per_query_s=5.0e-5, coef_s=1.0e-9
    ),
    "host_local_search": EngineSeed(
        dispatch_s=1.0e-4, per_query_s=4.0e-4, coef_s=1.7e-7
    ),
    "host_exhaustive": EngineSeed(
        dispatch_s=1.0e-4, per_query_s=5.0e-4, coef_s=4.0e-6,
        k_cap=4, k_is_exponent=True,
    ),
}
# an engine the seeds don't know (custom registrations): flat per-query
# prior that neither dominates nor vanishes — one observation fixes it
_FALLBACK = EngineSeed(dispatch_s=1.0e-3, per_query_s=1.0e-3, coef_s=0.0)


class CostModel:
    """Seeded + online-refined ``solve_batch`` latency model."""

    def __init__(self, seeds: Optional[dict[str, EngineSeed]] = None):
        self._seeds = dict(_SEEDS if seeds is None else seeds)
        self._mu = threading.Lock()
        # (engine, Bb, kb, mb) -> [ema_seconds, n_observations]
        self._cells: dict[tuple[str, int, int, int], list] = {}
        self._decisions: collections.deque = collections.deque(
            maxlen=_DECISIONS
        )
        self.observations = 0

    # ------------------------------------------------------------------
    # estimation
    # ------------------------------------------------------------------

    def seed(self, engine: str) -> EngineSeed:
        return self._seeds.get(engine, _FALLBACK)

    def _static(self, engine: str, B: int, kmax: int, m: int) -> float:
        return self.seed(engine).estimate(max(1, B), max(1, kmax), max(1, m))

    def estimate(self, engine: str, B: int = 1, kmax: int = 1,
                 m: int = 1) -> float:
        """Predicted wall seconds of one ``solve_batch`` of ``B`` queries
        on ``engine`` (kmax = max selection size in the batch, m =
        coreset rows). Measured cell if one exists; else the nearest
        measured ``B`` bucket extrapolated along the seed shape; else the
        static seed."""
        Bb, kb, mb = _bucket_pow2(B), _bucket_pow2(kmax), _bucket_pow2(m)
        with self._mu:
            cell = self._cells.get((engine, Bb, kb, mb))
            if cell is not None:
                return cell[0]
            # nearest measured B bucket for the same (engine, kmax, m):
            # scale its EMA by the seed model's B-dependence so a B=1
            # measurement still informs a B=16 estimate (and vice versa)
            near = None
            for (e, b2, k2, m2), c in self._cells.items():
                if e == engine and k2 == kb and m2 == mb:
                    d = abs(math.log2(b2) - math.log2(Bb))
                    if near is None or d < near[0]:
                        near = (d, b2, c[0])
        if near is not None:
            _d, b2, ema = near
            base = self._static(engine, b2, kb, mb)
            return ema * (self._static(engine, Bb, kb, mb) / base)
        return self._static(engine, B, kmax, m)

    def estimate_stacked(
        self, engine: str, parts: Sequence[tuple[int, int]], m: int
    ) -> float:
        """Predicted wall seconds of ONE cross-tenant stacked
        ``solve_batch_stacked`` call: ``parts`` is one ``(B, kmax)``
        pair per stacked entry. Rows are vmapped independently and the
        pdist matrix is the only per-entry leaf, so the device sees one
        batch whose effective size is the SUM of rows across entries at
        the max k — pricing it as a single-tenant B would undercount
        the launch by the number of tenants stacked."""
        B = sum(max(1, int(b)) for b, _k in parts)
        kmax = max((max(1, int(k)) for _b, k in parts), default=1)
        return self.estimate(engine, B=B, kmax=kmax, m=m)

    def calibrated(self, engine: str, B: int = 1, kmax: int = 1,
                   m: int = 1) -> bool:
        """True iff ``estimate`` for this request would be backed by at
        least one online observation (any B bucket of the same cell)."""
        kb, mb = _bucket_pow2(kmax), _bucket_pow2(m)
        with self._mu:
            return any(
                e == engine and k2 == kb and m2 == mb
                for (e, _b2, k2, m2) in self._cells
            )

    # ------------------------------------------------------------------
    # online calibration
    # ------------------------------------------------------------------

    def observe(self, engine: str, B: int, kmax: int, m: int,
                seconds: float) -> None:
        """Fold one measured ``solve_batch`` wall into the model."""
        if not (seconds >= 0.0) or B <= 0:  # NaN/negative: refuse quietly
            return
        key = (engine, _bucket_pow2(B), _bucket_pow2(kmax), _bucket_pow2(m))
        with self._mu:
            cell = self._cells.get(key)
            if cell is None:
                self._cells[key] = [float(seconds), 1]
            else:
                cell[0] += _ALPHA * (float(seconds) - cell[0])
                cell[1] += 1
            self.observations += 1

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def choose(self, engines: Sequence[str], B: int, kmax: int,
               m: int) -> tuple[str, dict[str, float]]:
        """argmin-estimate engine for a group of ``B`` requests; ties
        keep the callers' order (which callers pass priority-sorted, so a
        tie preserves the historical policy). Returns the winner and the
        estimates that drove the decision."""
        ests = {e: self.estimate(e, B, kmax, m) for e in engines}
        winner = min(engines, key=lambda e: ests[e])
        return winner, ests

    def record_decision(self, *, engine: str, candidates: dict[str, float],
                        B: int, kmax: int, m: int,
                        stacked: bool = False) -> None:
        d = dict(engine=engine, B=int(B), kmax=int(kmax), m=int(m),
                 stacked=bool(stacked),
                 estimates={k: float(v) for k, v in candidates.items()})
        with self._mu:
            self._decisions.append(d)
        if _log.isEnabledFor(logging.DEBUG):
            _log.debug(
                "cost-model route: %s for B=%d kmax=%d m=%d (%s)",
                engine, B, kmax, m,
                ", ".join(f"{k}={v:.2e}s" for k, v in candidates.items()),
            )

    def decisions(self) -> list[dict]:
        """Most recent ``engine="auto"`` routing decisions (newest last),
        each with the per-candidate estimates that drove it."""
        with self._mu:
            return list(self._decisions)

    def crossover(self, a: str, b: str, *, kmax: int, m: int,
                  max_batch: int = 4096) -> Optional[int]:
        """Smallest pow-2 batch size at which ``a`` is estimated no
        slower than ``b`` (None: ``b`` wins everywhere up to
        ``max_batch``). The operator-facing "where does the jit engine
        start winning" probe the README documents."""
        B = 1
        while B <= max_batch:
            if self.estimate(a, B, kmax, m) <= self.estimate(b, B, kmax, m):
                return B
            B *= 2
        return None

    def snapshot(self) -> dict:
        """Inspection view: observation counts per measured cell plus the
        decision tail (for ``QueryFrontend.stats()``)."""
        with self._mu:
            cells = {
                f"{e}[B={b} kmax={k} m={m}]": {
                    "ema_s": c[0], "n": c[1],
                }
                for (e, b, k, m), c in sorted(self._cells.items())
            }
            return {
                "observations": self.observations,
                "cells": cells,
                "decisions": list(self._decisions)[-8:],
            }


_default: Optional[CostModel] = None
_default_mu = threading.Lock()


def default_cost_model() -> CostModel:
    global _default
    if _default is None:
        with _default_mu:
            if _default is None:
                _default = CostModel()
    return _default
