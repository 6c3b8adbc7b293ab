"""Solver-engine protocol + registry for the final-stage DMMC solve.

Reference: ``repro/core/solvers/base.py``. ``SolveContext`` carries one
field more, ``device``: where the batched engines put D and the query
tensors (CUDA by default, like every entry point of the port).
``selection_value`` stays the host float64 evaluator.

The paper's split (§4.4) makes the final solver a small, swappable
component: it only ever sees the coreset distance matrix. This module is
the seam — every final-stage solver (host local search, host exhaustive
search, the jit batched engines) is a registered ``SolverEngine`` and both
the offline driver (``solve_dmmc`` -> ``final_solve``) and the online
service (``DiversityService.query/query_batch``) dispatch through the
registry instead of hand-rolled if-chains.

An engine declares

* ``supports(variant, matroid_kind)`` — its static cell coverage of the
  (diversity variant x matroid kind) grid;
* ``eligible(ctx, spec)`` — data-dependent refinement (e.g. the jit
  partition path needs single-label categories);
* ``exact_parity`` — whether its selections provably match the host
  reference engine on every supported cell. Only parity engines are
  candidates for ``engine="auto"``; non-parity engines (the greedy
  star/tree batch engine) must be requested explicitly via ``engine=`` or
  a query's ``engine_hint``.
* ``solve_one`` / ``solve_batch`` — the solve itself. Batched engines
  amortize one jit dispatch over the whole group; host engines loop.

All engines report the objective through one canonical evaluator
(``selection_value``: float64, selection sorted before evaluation), so two
engines that pick the same set report the *same float* — that is what
lets the cross-engine parity tests assert exact value equality.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from ... import obs
from ...device import CUDA, DeviceLike
from ..diversity import VARIANTS, Variant, diversity
from ..matroid import Matroid, MatroidSpec

MATROID_KINDS: tuple[str, ...] = (
    "uniform", "partition", "transversal", "general"
)


@dataclasses.dataclass(frozen=True)
class SolveSpec:
    """One final-stage solve request, resolved against a coreset context.

    ``caps`` is a per-request partition-caps override (None = the
    context's default caps); ``allow`` is the resolved bool[m] candidate
    mask (None = all m rows are candidates). ``idxs`` optionally pins an
    explicit candidate *order* (with duplicates preserved) — the host
    solvers' tie-breaks are visit-order dependent, so ``final_solve``
    threads its caller's sequence through unchanged; the jit engines scan
    ascending and refuse order-sensitive requests (``eligible`` returns
    False for a non-ascending ``idxs``). Without ``idxs``, candidates are
    visited in ascending row order.
    """

    k: int
    variant: Variant = "sum"
    gamma: float = 0.0
    caps: Optional[tuple[int, ...]] = None
    allow: Optional[np.ndarray] = None
    idxs: Optional[tuple[int, ...]] = None

    def allow_mask(self, m: int) -> np.ndarray:
        if self.idxs is not None:
            mask = np.zeros((m,), bool)
            mask[np.asarray(self.idxs, np.int64)] = True
            return mask
        if self.allow is None:
            return np.ones((m,), bool)
        return np.asarray(self.allow, bool)

    def candidate_idxs(self, m: int) -> list[int]:
        """Candidates in visit order (host solvers' scan order)."""
        if self.idxs is not None:
            return [int(i) for i in self.idxs]
        return np.flatnonzero(self.allow_mask(m)).tolist()

    def ascending_candidates(self, m: int) -> bool:
        """True unless ``idxs`` pins a custom (non-ascending) order."""
        if self.idxs is None:
            return True
        arr = np.asarray(self.idxs, np.int64)
        return bool(np.all(arr[1:] > arr[:-1]))


@dataclasses.dataclass
class SolveContext:
    """Everything engines may need about the coreset being solved on.

    ``matroid_fn`` builds the host oracle for a request (applying
    per-request caps); batched engines instead read ``cats``/``caps``
    directly, on ``device``. ``cats`` may be None when the caller only
    has a host oracle (then only host engines are eligible).
    """

    D: np.ndarray  # (m, m) distances
    spec: MatroidSpec
    cats: Optional[np.ndarray] = None  # (m, gamma) int32, -1 padded
    caps: Optional[np.ndarray] = None  # default partition caps
    matroid_fn: Optional[Callable[[SolveSpec], Matroid]] = None
    device: DeviceLike = CUDA  # where the batched engines run

    def __post_init__(self):
        if self.cats is not None:
            cats = np.asarray(self.cats, np.int32)
            if cats.ndim == 1:  # single-label shorthand -> (m, 1)
                cats = cats[:, None]
            self.cats = cats

    @property
    def size(self) -> int:
        return int(self.D.shape[0])

    def partition_multilabel(self) -> bool:
        """True iff some row carries a second real (non-padding) label —
        the case the partition matroid cannot represent."""
        return (
            self.cats is not None
            and self.cats.ndim == 2
            and self.cats.shape[1] > 1
            and bool(np.any(self.cats[:, 1:] >= 0))
        )


@dataclasses.dataclass
class EngineSolution:
    local_indices: np.ndarray  # rows of ctx.D, solver order
    value: float  # canonical objective (selection_value)
    engine: str  # name of the engine that produced it


def selection_value(D: np.ndarray, sel: Sequence[int], variant: Variant) -> float:
    """Canonical objective of a selection: float64, rows sorted first.

    Sorting makes the float result a function of the selected *set* only,
    so engines that agree on the set report bitwise-equal values
    regardless of the order their search visited it in.
    """
    loc = np.sort(np.asarray(list(sel), np.int64))
    if loc.size <= 1:
        return 0.0
    sub = np.asarray(D, np.float64)[np.ix_(loc, loc)]
    return float(diversity(sub, variant))


class SolverEngine:
    """Base class: subclass, set the class attributes, register."""

    name: str = "?"
    priority: int = 100  # lower = preferred among eligible parity engines
    exact_parity: bool = False  # selections match the host reference

    def supports(self, variant: Variant, matroid_kind: str) -> bool:
        raise NotImplementedError

    def eligible(self, ctx: SolveContext, spec: SolveSpec) -> bool:
        return self.supports(spec.variant, ctx.spec.kind)

    def solve_one(self, ctx: SolveContext, spec: SolveSpec) -> EngineSolution:
        return self.solve_batch(ctx, [spec])[0]

    def solve_batch(
        self, ctx: SolveContext, specs: Sequence[SolveSpec]
    ) -> list[EngineSolution]:
        return [self.solve_one(ctx, s) for s in specs]

    # -- cross-tenant stacking (see stacked.py) ------------------------
    # A stack-capable engine answers several single-tenant spec groups
    # ("lanes" of (ctx, specs), differing only in their pdist leaf and
    # matroid view) in ONE device dispatch. Default: not capable.

    def stack_eligible(self, ctx: SolveContext, spec: SolveSpec) -> bool:
        return False

    def solve_batch_stacked(
        self, lanes: Sequence[tuple[SolveContext, Sequence[SolveSpec]]]
    ) -> list[list[EngineSolution]]:
        raise NotImplementedError(
            f"engine {self.name!r} has no stacked solve path"
        )

    def __repr__(self):
        return f"<SolverEngine {self.name!r}>"


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, SolverEngine] = {}

# back-compat spellings from the pre-registry service API
_ALIASES = {"vmap": "jit_sum"}


def register_engine(engine: SolverEngine, *, overwrite: bool = False) -> SolverEngine:
    """Register an engine instance under ``engine.name``. Third parties
    use this to plug in custom engines (see README "Solver engines")."""
    if engine.name in _REGISTRY and not overwrite:
        raise ValueError(f"engine {engine.name!r} already registered")
    _REGISTRY[engine.name] = engine
    return engine


def registered_engines() -> list[SolverEngine]:
    """All engines, best (lowest priority value) first."""
    return sorted(_REGISTRY.values(), key=lambda e: (e.priority, e.name))


def get_engine(name: str) -> SolverEngine:
    name = _ALIASES.get(name, name)
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown solver engine {name!r}; registered: "
            f"{sorted(_REGISTRY)} (+ aliases {sorted(_ALIASES)}, 'host', 'auto')"
        )
    return _REGISTRY[name]


def resolve_engine(
    name: str, ctx: SolveContext, spec: SolveSpec
) -> SolverEngine:
    """Resolve an explicit engine request (not "auto") for one request.

    ``"host"`` resolves to whichever host reference engine covers the
    variant (local search for sum, exhaustive otherwise). An explicitly
    named engine that is not eligible for the request raises.
    """
    if name == "host":
        for e in registered_engines():
            if e.name.startswith("host") and e.eligible(ctx, spec):
                return e
        raise ValueError(
            f"no host engine for variant={spec.variant!r} under "
            f"{ctx.spec.kind!r}"
        )
    e = get_engine(name)
    if not e.eligible(ctx, spec):
        raise ValueError(
            f"engine {e.name!r} does not support variant={spec.variant!r} "
            f"under matroid kind {ctx.spec.kind!r} for this coreset"
        )
    return e


def _auto_candidates(
    ctx: SolveContext, spec: SolveSpec, *, hint: Optional[str] = None
) -> tuple[SolverEngine, ...]:
    """Candidate engines for one ``engine="auto"`` request, best-first.

    A query ``hint`` names a specific engine (e.g. the non-parity
    ``jit_greedy``) and pins the candidate set to it; a hint naming a
    *registered* engine that is not eligible for this request falls back
    to the auto policy rather than failing the query, but an unknown
    engine name raises — silently downgrading a typo'd hint to a slower
    engine would hide the caller's bug. Without an applicable hint the
    candidates are every eligible engine with the host-parity guarantee
    (priority order) — any of them returns the same answer, which is what
    makes cost-based picking among them a pure latency decision.
    """
    if hint == "host":
        return (resolve_engine("host", ctx, spec),)
    if hint is not None:
        e = get_engine(hint)  # unknown name -> ValueError
        if e.eligible(ctx, spec):
            return (e,)
        # soft hint: eligible nowhere here, fall through to the auto policy
    cands = tuple(
        e for e in registered_engines()
        if e.exact_parity and e.eligible(ctx, spec)
    )
    if not cands:
        raise ValueError(
            f"no registered engine covers variant={spec.variant!r} under "
            f"matroid kind {ctx.spec.kind!r}"
        )
    return cands


def select_engine(
    ctx: SolveContext,
    spec: SolveSpec,
    *,
    hint: Optional[str] = None,
    cost_model=None,
    batch_size: int = 1,
) -> SolverEngine:
    """The ``engine="auto"`` policy for a single request.

    Without a ``cost_model`` this is the historical static policy: the
    highest-priority eligible engine with the host-parity guarantee — so
    an auto answer always equals the host answer on the same coreset.
    With a ``cost_model`` (``core.solvers.cost_model.CostModel``), the
    parity constraint still bounds the candidate set, but the pick within
    it is argmin of ``estimate(engine, batch_size, kmax, m)`` — host
    engines win tiny batches where dispatch dominates, jit engines win at
    scale, and the crossover is measured rather than asserted.

    On the card ``auto`` is slower than ``"host"`` until a sweep is
    captured as a CUDA graph or made a kernel: on the songs-sim coreset
    (m = 327, k = 22, one H100) ``jit_sum`` took 0.92–0.96 s for one query
    against ~0.03 s for the host engine, and 0.82–1.22 s for 32 queries
    against the host's 0.89–1.02 s (``PERF.md`` §5). The cost model's
    seeds are the reference's CPU priors, not calibrated for the card,
    and route the same wrong way (at B = 1 they price ``jit_sum`` below
    the host engine).
    """
    cands = _auto_candidates(ctx, spec, hint=hint)
    if cost_model is None or len(cands) == 1:
        return cands[0]
    winner, ests = cost_model.choose(
        [e.name for e in cands], B=batch_size, kmax=spec.k, m=ctx.size
    )
    cost_model.record_decision(
        engine=winner, candidates=ests,
        B=batch_size, kmax=spec.k, m=ctx.size,
    )
    return get_engine(winner)


def partition_by_engine(
    ctx: SolveContext,
    specs: Sequence[SolveSpec],
    *,
    engine: str = "auto",
    hints: Optional[Sequence[Optional[str]]] = None,
    cost_model=None,
    batch_size: Optional[int] = None,
    stacked: bool = False,
) -> dict[str, list[int]]:
    """Split a batch into per-engine groups (engine name -> spec indices).

    ``engine="auto"`` applies the auto policy per request (honoring
    per-request hints); any other name forces every request through that
    engine (raising if one is ineligible).

    With a ``cost_model``, auto requests are first grouped by their
    *candidate set* (hint-pinned requests bypass this), and each group is
    routed as a unit: the model sees the group's true batch size ``B``
    and its max ``k``, so ten concurrent B=1 callers coalesced into one
    group route like one B=10 batch — per-request argmin would always see
    B=1 and never cross over to the amortizing batched engines.
    ``batch_size`` overrides the B the model sees (a micro-batch
    coalescer partitions per caller for admission but routes with the
    merged group's size); ``stacked=True`` marks the decision as priced
    for a cross-tenant stacked launch in the audit ring. Decisions are
    recorded in the model's audit ring and counted under
    ``solve.dispatch.cost_routed``. ``cost_model=None`` (the default, and
    what the offline ``solve_dmmc``/``final_solve`` entry points use) keeps
    the static priority policy. On the card, see ``select_engine``: both
    the static policy and the uncalibrated seeds favour ``jit_sum`` where
    the host engine is faster.
    """
    groups: dict[str, list[int]] = {}
    undecided: dict[tuple[str, ...], list[int]] = {}
    for i, s in enumerate(specs):
        if engine == "auto":
            h = hints[i] if hints is not None else None
            cands = _auto_candidates(ctx, s, hint=h)
            if cost_model is None or len(cands) == 1:
                groups.setdefault(cands[0].name, []).append(i)
            else:
                key = tuple(e.name for e in cands)
                undecided.setdefault(key, []).append(i)
        else:
            e = resolve_engine(engine, ctx, s)
            groups.setdefault(e.name, []).append(i)
    reg = obs.default_registry()
    for names, idxs in undecided.items():
        kmax = max(specs[i].k for i in idxs)
        B = len(idxs) if batch_size is None else max(batch_size, len(idxs))
        winner, ests = cost_model.choose(names, B=B, kmax=kmax, m=ctx.size)
        cost_model.record_decision(
            engine=winner, candidates=ests, B=B, kmax=kmax, m=ctx.size,
            stacked=stacked,
        )
        reg.counter("solve.dispatch.cost_routed", engine=winner).inc(
            len(idxs)
        )
        groups.setdefault(winner, []).extend(idxs)
    for idxs in groups.values():
        idxs.sort()
    for name, idxs in groups.items():
        reg.counter(
            "solve.dispatch.requests", engine=name, requested=engine
        ).inc(len(idxs))
    return groups


def coverage_matrix() -> dict[tuple[str, str], list[str]]:
    """(variant, matroid_kind) -> engine names statically covering the
    cell, best-first. The README's coverage table is generated from this."""
    out: dict[tuple[str, str], list[str]] = {}
    for v in VARIANTS:
        for kind in MATROID_KINDS:
            out[(v, kind)] = [
                e.name for e in registered_engines() if e.supports(v, kind)
            ]
    return out
