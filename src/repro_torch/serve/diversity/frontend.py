"""QueryFrontend: the read half of the diversity serving runtime.

Reference: ``repro/serve/diversity/frontend.py``. A frontend answers
queries against the published epochs of one ``StreamRuntime``, never the
live device state:

  epoch    every query resolves the newest published ``EpochSnapshot``
           (``runtime.acquire``); ``flush()`` barriers all submitted
           batches into a new epoch, and ``query(..., min_epoch=e)`` waits
           for it;
  tenants  a ``TenantRegistry`` maps names to ``(spec, tau, metric, caps,
           oracle)`` over the one stream; each tenant's matrix lives under
           its own cache key and is rebuilt (one K1 launch) exactly when a
           changed epoch is published;
  solve    ``engine="auto"`` partitions a batch across eligible
           host-parity engines by the frontend's ``CostModel`` (every
           measured solve refines it, unless a compile event fell in the
           solve: an nvcc or Triton build or a dynamo frame reported
           through ``obs.torchprof.RecompileWatch``); hints opt into
           non-parity engines; the matrix is fetched, and maybe built,
           once a batch; ``deadline_s`` degrades or sheds;
  coalesce under concurrency, ``query_batch`` calls from any threads and
           tenants merge through an adaptive micro-batch window
           (``coalesce.Coalescer``, on by default as in the reference)
           into shared batched solves, stacked across tenants into one
           call where the engine can (``core/solvers/stacked.py``). A
           coalesced answer equals the caller's direct-path answer: a
           different dispatch, not an approximation. A solo caller
           bypasses the window. ``drain_pending``/``adopt_pending`` move
           parked calls to a promoted replica on failover.

Several threads launch kernels: the runtime's worker (K3), the
coalescer's dispatchers and query callers (K1 on a cold entry, the
batched engines). All use the default CUDA stream, so a query's K1
queues behind the worker's scan.

Thread-safe: any number of threads may query while the worker ingests.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ... import obs
from ...core import geometry
from ...core.final_solve import SubsetMatroidView
from ...core.matroid import MatroidSpec, make_host_matroid
from ...core.solvers import (
    CostModel,
    SolveContext,
    SolveSpec,
    bucket_pow2,
    get_engine,
    partition_by_engine,
)
from ...obs.torchprof import RecompileWatch
from .cache import CoresetEntry, DistanceCache
from .coalesce import CoalesceConfig, Coalescer, PendingCall
from .query import DiversityQuery, QueryResult, candidate_mask
from .runtime import EpochSnapshot, StreamRuntime
from .tenants import DEFAULT_TENANT, Tenant, TenantRegistry


class QueryFrontend:
    """Serves diversity queries from published epochs of one runtime."""

    def __init__(
        self,
        runtime: StreamRuntime,
        *,
        cache: Optional[DistanceCache] = None,
        default_tenant: str = DEFAULT_TENANT,
        registry: Optional[obs.MetricsRegistry] = None,
        cost_model: Optional[CostModel] = None,
        coalesce: Optional[CoalesceConfig] = None,
    ):
        self.runtime = runtime
        self.device = runtime.device
        # default to the runtime's registry: one serving stack counts in
        # one place (tests pass explicit registries to count in isolation)
        self.registry = registry if registry is not None else runtime.registry
        self.cache = cache if cache is not None else DistanceCache(
            registry=self.registry, device=self.device
        )
        self.tenants = TenantRegistry()
        self.default_tenant = self.register_tenant(default_tenant)
        self._m_epoch_wait_s = self.registry.histogram(
            "serve.query.epoch_wait_s")
        # each frontend owns its model (pass one in to share or calibrate)
        self.cost_model = cost_model if cost_model is not None else CostModel()
        # a solve whose wall time includes a compile must not train the
        # model: that cost is paid once, not per request
        self._compiles = RecompileWatch()
        self._active = 0
        self._active_mu = threading.Lock()
        self._traffic_t0 = time.perf_counter()
        self._traffic_prev: dict[str, tuple[float, int]] = {}
        cfg = CoalesceConfig() if coalesce is None else coalesce
        self.coalescer = Coalescer(self, cfg) if cfg.enabled else None
        self._closed = False

    # ------------------------------------------------------------------
    # tenants
    # ------------------------------------------------------------------

    def register_tenant(
        self,
        name: str,
        *,
        spec: Optional[MatroidSpec] = None,
        tau: Optional[int] = None,
        metric: Optional[geometry.Metric] = None,
        caps: Optional[np.ndarray] = None,
        oracle=None,
    ) -> Tenant:
        """Register one logical serving configuration over the shared
        stream. Unspecified fields inherit the runtime's (a partition
        tenant without caps inherits the runtime's caps)."""
        rt = self.runtime
        spec = rt.spec if spec is None else spec
        metric = rt.metric if metric is None else metric
        if str(metric) != str(rt.metric) and str(rt.metric) == "cosine":
            # the raw geometry is not recoverable from cosine-normalized
            # rows (the reverse is exact: cosine normalization is
            # idempotent)
            raise ValueError(
                f"tenant {name!r} wants metric {str(metric)!r} over a "
                f"cosine-normalized stream; that geometry is not "
                f"derivable from the stored rows -- run a separate "
                f"{str(metric)}-metric StreamRuntime instead"
            )
        if caps is None and spec.kind == "partition":
            caps = rt.caps
        return self.tenants.register(
            name,
            spec=spec,
            tau=rt.tau if tau is None else tau,
            metric=metric,
            caps=caps,
            oracle=rt.oracle if oracle is None else oracle,
        )

    def _resolve_tenant(self, tenant) -> Tenant:
        if tenant is None:
            return self.default_tenant
        if isinstance(tenant, Tenant):
            return tenant
        return self.tenants.get(tenant)

    # ------------------------------------------------------------------
    # per-tenant cache entries
    # ------------------------------------------------------------------

    def _entry(
        self, tenant: Tenant, snap: EpochSnapshot
    ) -> tuple[CoresetEntry, bool]:
        """The tenant's cache entry for one epoch (K1 builds the matrix
        only if this epoch's fingerprint has no entry under the key)."""
        e = self.cache.lookup(tenant.key, snap.fingerprint)
        if e is not None:
            return e, True
        pts = snap.points
        if tenant.metric != str(self.runtime.metric):
            # the epoch holds stream-metric rows; a tenant on another
            # metric re-normalizes its copy, on the card
            pts = geometry.normalize_for_metric(
                torch.as_tensor(pts, device=self.cache.device),
                tenant.metric)
        e = self.cache.build(
            tenant.key, pts, snap.cats, snap.src_idx, snap.fingerprint
        )
        return e, False

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _host_matroid(
        self, tenant: Tenant, snap: EpochSnapshot, entry: CoresetEntry,
        spec: SolveSpec,
    ):
        m = entry.size
        if tenant.spec.kind == "general":
            base = make_host_matroid(
                tenant.spec, None, None, snap.n_offered, spec.k,
                tenant.oracle,
            )
            return SubsetMatroidView(base, entry.src_idx)
        caps = (
            tenant.caps
            if spec.caps is None
            else np.asarray(spec.caps, np.int32)
        )
        return make_host_matroid(tenant.spec, entry.cats, caps, m, spec.k)

    def _solve_context(
        self, tenant: Tenant, snap: EpochSnapshot, entry: CoresetEntry
    ) -> SolveContext:
        """Registry view of one cache entry (what every engine solves on):
        the host engines read ``D_host``, the batched engines take it to
        the runtime's device."""
        return SolveContext(
            D=entry.D_host,
            spec=tenant.spec,
            cats=entry.cats,
            caps=tenant.caps,
            matroid_fn=lambda spec: self._host_matroid(
                tenant, snap, entry, spec
            ),
            device=self.device,
        )

    def _solve_spec(
        self, entry: CoresetEntry, q: DiversityQuery
    ) -> SolveSpec:
        return SolveSpec(
            k=q.k,
            variant=q.variant,
            gamma=q.gamma,
            caps=q.caps,
            allow=candidate_mask(entry.cats, q.allowed_cats),
        )

    # ------------------------------------------------------------------
    # deadline-aware admission
    # ------------------------------------------------------------------

    def _predict_s(
        self, tenant: str, engine: str, *,
        B: int = 1, kmax: int = 1, m: int = 1,
    ) -> float:
        """Predicted wall time of one ``solve_batch`` on ``engine`` for
        this tenant: the p95 of its measured latency histogram once it has
        history, else the cost model's estimate for the (B, kmax, m)
        shape."""
        h = self.registry.histogram(
            "serve.solve.latency_s", tenant=tenant, engine=engine
        )
        if h.count:
            return h.quantile(0.95)
        return self.cost_model.estimate(engine, B=B, kmax=kmax, m=m)

    def _admit(
        self,
        ctx: SolveContext,
        specs: Sequence[SolveSpec],
        groups: dict,
        tenant: str,
        remaining_s: float,
    ) -> tuple[dict, set, set]:
        """Fit the engine plan into the remaining deadline budget: first
        move exact star/tree queries from ``host_exhaustive`` to
        ``jit_greedy`` where eligible (``degraded``), then shed what still
        does not fit, the most expensive predicted group first (``shed``).
        Sum queries have no faster approximate engine, so they shed."""
        degraded: set = set()
        shed: set = set()
        groups = {n: list(ix) for n, ix in groups.items() if ix}
        if remaining_s <= 0:
            for ix in groups.values():
                shed.update(ix)
            return {}, degraded, shed

        def pred(name: str) -> float:
            ix = groups[name]
            return self._predict_s(
                tenant, name, B=len(ix),
                kmax=max(specs[i].k for i in ix), m=ctx.size,
            )

        total = sum(pred(n) for n in groups)
        if total > remaining_s and "host_exhaustive" in groups:
            greedy = get_engine("jit_greedy")
            moved = [
                i for i in groups["host_exhaustive"]
                if greedy.eligible(ctx, specs[i])
            ]
            if moved:
                kept = [
                    i for i in groups["host_exhaustive"] if i not in moved
                ]
                if kept:
                    groups["host_exhaustive"] = kept
                else:
                    del groups["host_exhaustive"]
                groups.setdefault("jit_greedy", []).extend(moved)
                degraded.update(moved)
                total = sum(pred(n) for n in groups)
        if total > remaining_s:
            preds = {n: pred(n) for n in groups}
            for name in sorted(preds, key=preds.get, reverse=True):
                if total <= remaining_s:
                    break
                total -= preds[name]
                ix = groups.pop(name)
                shed.update(ix)
                degraded.difference_update(ix)
        return groups, degraded, shed

    def _shed_result(
        self, q: DiversityQuery, entry, cached: bool, epoch: int,
        tenant: str,
    ) -> QueryResult:
        return QueryResult(
            indices=np.empty((0,), np.int64),
            local_indices=np.empty((0,), np.int64),
            diversity=0.0,
            variant=q.variant,
            engine="shed",
            coreset_size=0 if entry is None else entry.size,
            from_cache=cached,
            epoch=epoch,
            tenant=tenant,
            shed=True,
        )

    def query(
        self,
        q: DiversityQuery,
        *,
        tenant=None,
        engine: str = "auto",
        min_epoch: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> QueryResult:
        """Answer one query on the tenant's cached matrix over the newest
        published epoch (see ``query_batch``)."""
        return self.query_batch(
            [q], tenant=tenant, engine=engine, min_epoch=min_epoch,
            deadline_s=deadline_s,
        )[0]

    def active_calls(self) -> int:
        """``query_batch`` calls currently inside the frontend (counted
        before the coalesce-or-direct choice; coalesced callers stay
        counted while parked in the window)."""
        return self._active

    def query_batch(
        self,
        queries: Sequence[DiversityQuery],
        *,
        tenant=None,
        engine: str = "auto",
        min_epoch: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> list[QueryResult]:
        """Answer a batch of heterogeneous queries against ONE epoch and
        ONE tenant cache entry.

        ``engine="auto"`` partitions the batch across registry engines
        with the host-parity guarantee, picked by the frontend's
        ``CostModel`` (decisions in ``cost_model.decisions()``), honoring
        per-query ``engine_hint``s; any other name forces every query
        through that engine ("vmap" is an alias of "jit_sum").
        ``min_epoch`` waits for an epoch >= it (use ``flush()``'s);
        without it the newest published epoch answers at once.
        ``deadline_s`` arms deadline-aware admission (``degraded`` /
        ``shed`` results; ``serve.query.degraded`` / ``.shed`` /
        ``.deadline_miss`` per tenant); in the coalescer a deadline also
        bounds the time spent waiting in the window.

        Under concurrency, calls coalesce through the micro-batch window
        (``coalesce.py``) into merged solves; the answers are the direct
        path's. A solo caller bypasses the window and runs the direct
        path inline.
        """
        queries = list(queries)
        if not queries:
            return []
        t = self._resolve_tenant(tenant)
        reg = self.registry
        reg.counter("serve.query.requests", tenant=t.name).inc()
        reg.counter("serve.query.queries", tenant=t.name).inc(len(queries))
        in_flight = reg.gauge("serve.query.in_flight", tenant=t.name)
        with self._active_mu:
            self._active += 1
        in_flight.inc()
        try:
            co = self.coalescer
            if co is not None and (self._active > 1 or co.backlog > 0):
                return co.submit(
                    t, queries, engine=engine, min_epoch=min_epoch,
                    deadline_s=deadline_s,
                )
            if co is not None:
                reg.counter("serve.coalesce.solo").inc()
            return self._query_batch_direct(
                queries, tenant=t, engine=engine, min_epoch=min_epoch,
                deadline_s=deadline_s,
            )
        finally:
            in_flight.inc(-1.0)
            with self._active_mu:
                self._active -= 1

    def _query_batch_direct(
        self,
        queries: list[DiversityQuery],
        *,
        tenant=None,
        engine: str = "auto",
        min_epoch: Optional[int] = None,
        deadline_s: Optional[float] = None,
    ) -> list[QueryResult]:
        """The direct solve path (one caller, one tenant, one epoch); the
        coalescer's answers are defined against it."""
        reg = self.registry
        t_batch = time.perf_counter()
        deadline = None if deadline_s is None else t_batch + deadline_s
        with obs.trace(), obs.span(
            "query_batch", cat="query", n=len(queries), engine=engine
        ):
            with obs.span("resolve_tenant", cat="query"):
                t = self._resolve_tenant(tenant)
            t0 = time.perf_counter()

            def _shed_all(entry=None, cached=False, epoch=-1):
                reg.counter(
                    "serve.query.shed", tenant=t.name
                ).inc(len(queries))
                return [
                    self._shed_result(q, entry, cached, epoch, t.name)
                    for q in queries
                ]

            with obs.span(
                "acquire_epoch", cat="query", min_epoch=min_epoch
            ):
                try:
                    snap = self.runtime.acquire(
                        min_epoch,
                        **(
                            {}
                            if deadline is None
                            else {"timeout": max(
                                0.0, deadline - time.perf_counter()
                            )}
                        ),
                    )
                except TimeoutError:
                    # the epoch cannot publish inside the budget: shed
                    return _shed_all()
            if min_epoch is not None:
                self._m_epoch_wait_s.observe(time.perf_counter() - t0)
            with obs.span(
                "cache_entry", cat="query", tenant=t.name,
                epoch=snap.epoch,
            ):
                entry, cached = self._entry(t, snap)
            reg.counter(
                "serve.query.cache_hits" if cached
                else "serve.query.cache_misses",
                tenant=t.name,
            ).inc()
            ctx = self._solve_context(t, snap, entry)
            specs = [self._solve_spec(entry, q) for q in queries]
            with obs.span("partition_by_engine", cat="query"):
                groups = partition_by_engine(
                    ctx,
                    specs,
                    engine=engine,
                    hints=[q.engine_hint for q in queries],
                    cost_model=self.cost_model,
                )
            degraded_ix: set = set()
            shed_ix: set = set()
            if deadline is not None:
                with obs.span("admit", cat="query"):
                    groups, degraded_ix, shed_ix = self._admit(
                        ctx, specs, groups, t.name,
                        deadline - time.perf_counter(),
                    )
                if degraded_ix:
                    reg.counter(
                        "serve.query.degraded", tenant=t.name
                    ).inc(len(degraded_ix))
                if shed_ix:
                    reg.counter(
                        "serve.query.shed", tenant=t.name
                    ).inc(len(shed_ix))
            results: list[Optional[QueryResult]] = [None] * len(queries)
            for i in shed_ix:
                results[i] = self._shed_result(
                    queries[i], entry, cached, snap.epoch, t.name
                )
            for name, idxs in groups.items():
                eng = get_engine(name)
                self._note_window_cost(
                    self.cost_model.estimate(
                        name, B=len(idxs),
                        kmax=max(specs[i].k for i in idxs), m=ctx.size,
                    )
                )
                t1 = time.perf_counter()
                c0 = self._compiles.total()
                with obs.span(
                    "solve", cat="query", engine=name, n=len(idxs)
                ):
                    sols = eng.solve_batch(
                        ctx, [specs[i] for i in idxs]
                    )
                # the engines return host arrays; the copy from the
                # device is inside solve_batch, this span assembles
                with obs.span("device_sync", cat="query", engine=name):
                    for i, sol in zip(idxs, sols):
                        loc = np.asarray(sol.local_indices, np.int64)
                        results[i] = QueryResult(
                            indices=entry.src_idx[loc],
                            local_indices=loc,
                            diversity=sol.value,
                            variant=queries[i].variant,
                            engine=sol.engine,
                            coreset_size=entry.size,
                            from_cache=cached,
                            epoch=snap.epoch,
                            tenant=t.name,
                            degraded=i in degraded_ix,
                        )
                dt = time.perf_counter() - t1
                reg.histogram(
                    "serve.solve.latency_s", tenant=t.name, engine=name
                ).observe(dt)
                reg.histogram(
                    "serve.solve.batch_size", engine=name
                ).observe(len(idxs))
                if self._compiles.total() == c0:
                    self.cost_model.observe(
                        name, len(idxs),
                        max(specs[i].k for i in idxs), ctx.size, dt,
                    )
            reg.histogram(
                "serve.query.latency_s", tenant=t.name
            ).observe(time.perf_counter() - t_batch)
            reg.histogram(
                "serve.query.batch_size", tenant=t.name
            ).observe(len(queries))
            if (
                deadline is not None
                and time.perf_counter() > deadline
            ):
                # admitted work still overran: the predictor was wrong
                reg.counter(
                    "serve.query.deadline_miss", tenant=t.name
                ).inc()
        return results  # type: ignore[return-value]

    # ------------------------------------------------------------------
    # coalesced execution (dispatcher thread)
    # ------------------------------------------------------------------

    def _solve_coalesced(self, calls: "list[PendingCall]") -> None:
        """Execute one coalesced group (calls agreeing on tenant, engine,
        and ``min_epoch``; see ``coalesce.Coalescer``).

        Semantics per caller are exactly the direct path's: per-caller
        engine partition (hints honored) and per-caller deadline
        admission happen *before* merging; only then do admitted specs
        merge into pow-2-``k``-bucketed ``(engine, bucket)`` batched
        solves shared across callers. Cost-model routing sees the merged
        batch size, so a swarm of B=1 callers routes like the one big
        batch it actually is. The answers equal the direct path's because
        auto/hinted routing only merges host-parity engines and a batched
        engine's rows do not depend on the batch's other rows.
        """
        t: Tenant = calls[0].tenant
        engine = calls[0].engine
        min_epoch = calls[0].min_epoch
        reg = self.registry
        n_total = sum(len(c.queries) for c in calls)
        with obs.trace(), obs.span(
            "coalesce_group", cat="query", calls=len(calls), n=n_total,
            engine=engine,
        ):

            def _shed_call(c, entry=None, cached=False, epoch=-1):
                reg.counter(
                    "serve.query.shed", tenant=t.name
                ).inc(len(c.queries))
                c.results = [
                    self._shed_result(q, entry, cached, epoch, t.name)
                    for q in c.queries
                ]

            # the group's epoch wait is bounded by its most patient
            # caller; any deadline-free caller restores the default wait
            kw = {}
            if all(c.deadline is not None for c in calls):
                kw["timeout"] = max(
                    0.0,
                    max(c.deadline for c in calls) - time.perf_counter(),
                )
            with obs.span(
                "acquire_epoch", cat="query", min_epoch=min_epoch
            ):
                try:
                    snap = self.runtime.acquire(min_epoch, **kw)
                except TimeoutError:
                    for c in calls:
                        _shed_call(c)
                    return
            if min_epoch is not None:
                now = time.perf_counter()
                for c in calls:
                    self._m_epoch_wait_s.observe(now - c.enq_t)
            with obs.span(
                "cache_entry", cat="query", tenant=t.name,
                epoch=snap.epoch,
            ):
                entry, cached = self._entry(t, snap)
            ctx = self._solve_context(t, snap, entry)
            # per-caller plan: partition + admission before any merging
            merged: dict[tuple[str, int], list] = {}
            first = True
            for c in calls:
                c.from_cache = cached or not first
                first = False
                reg.counter(
                    "serve.query.cache_hits" if c.from_cache
                    else "serve.query.cache_misses",
                    tenant=t.name,
                ).inc()
                c.results = [None] * len(c.queries)
                c.specs = [self._solve_spec(entry, q) for q in c.queries]
                groups = partition_by_engine(
                    ctx,
                    c.specs,
                    engine=c.engine,
                    hints=[q.engine_hint for q in c.queries],
                    cost_model=self.cost_model,
                    batch_size=n_total,
                )
                c.degraded = set()
                shed_ix: set = set()
                if c.deadline is not None:
                    with obs.span("admit", cat="query"):
                        groups, c.degraded, shed_ix = self._admit(
                            ctx, c.specs, groups, t.name,
                            c.deadline - time.perf_counter(),
                        )
                    if c.degraded:
                        reg.counter(
                            "serve.query.degraded", tenant=t.name
                        ).inc(len(c.degraded))
                    if shed_ix:
                        reg.counter(
                            "serve.query.shed", tenant=t.name
                        ).inc(len(shed_ix))
                for i in shed_ix:
                    c.results[i] = self._shed_result(
                        c.queries[i], entry, c.from_cache, snap.epoch,
                        t.name,
                    )
                for name, idxs in groups.items():
                    for i in idxs:
                        kb = bucket_pow2(max(1, c.specs[i].k))
                        merged.setdefault((name, kb), []).append((c, i))
            # merged solves: one launch per (engine, k-bucket)
            for (name, kb) in sorted(merged):
                items = merged[(name, kb)]
                eng = get_engine(name)
                mspecs = [c.specs[i] for c, i in items]
                self._note_window_cost(
                    self.cost_model.estimate(
                        name, B=len(items),
                        kmax=max(s.k for s in mspecs), m=ctx.size,
                    )
                )
                t1 = time.perf_counter()
                c0 = self._compiles.total()
                with obs.span(
                    "solve", cat="query", engine=name, n=len(items),
                    k_bucket=kb, coalesced_calls=len({
                        id(c) for c, _ in items
                    }),
                ):
                    sols = eng.solve_batch(ctx, mspecs)
                with obs.span("device_sync", cat="query", engine=name):
                    for (c, i), sol in zip(items, sols):
                        loc = np.asarray(sol.local_indices, np.int64)
                        c.results[i] = QueryResult(
                            indices=entry.src_idx[loc],
                            local_indices=loc,
                            diversity=sol.value,
                            variant=c.queries[i].variant,
                            engine=sol.engine,
                            coreset_size=entry.size,
                            from_cache=c.from_cache,
                            epoch=snap.epoch,
                            tenant=t.name,
                            degraded=i in c.degraded,
                        )
                dt = time.perf_counter() - t1
                reg.histogram(
                    "serve.solve.latency_s", tenant=t.name, engine=name
                ).observe(dt)
                reg.histogram(
                    "serve.solve.batch_size", engine=name
                ).observe(len(items))
                if self._compiles.total() == c0:
                    self.cost_model.observe(
                        name, len(items), max(s.k for s in mspecs),
                        ctx.size, dt,
                    )
            now = time.perf_counter()
            for c in calls:
                reg.histogram(
                    "serve.query.latency_s", tenant=t.name
                ).observe(now - c.enq_t)
                reg.histogram(
                    "serve.query.batch_size", tenant=t.name
                ).observe(len(c.queries))
                if c.deadline is not None and now > c.deadline:
                    reg.counter(
                        "serve.query.deadline_miss", tenant=t.name
                    ).inc()

    def _note_window_cost(self, est_s: float) -> None:
        """Feed one merged launch's cost-model estimate to the adaptive
        window controller (the S in its Little's-law target)."""
        co = self.coalescer
        if co is not None:
            co.window.observe_solve(est_s)

    def _solve_coalesced_stacked(
        self, subs: "list[list[PendingCall]]"
    ) -> None:
        """Execute one cross-tenant wave: several single-tenant coalesced
        sub-groups (each a ``_solve_coalesced``-shaped call list)
        agreeing on ``(engine, min_epoch)``, solved together.

        Per-caller semantics are the single-tenant path's -- engine
        partition with hints, deadline admission, shed/degrade -- applied
        per tenant lane before any merging. The merge then goes one step
        further than ``_solve_coalesced``: admitted specs landing in the
        same ``(engine, k-bucket)`` across *different tenants* stack
        into ONE call (``core/solvers/stacked.py``) when the engine
        supports it, because entries for different tenants over the same
        stream differ only in their pdist matrix. Lanes the engine
        cannot stack (transversal/general matroids, mismatched coreset
        size or dtype, engines without the path) fall back to per-lane
        solves inside the same wave. A lane whose cache-entry build
        fails takes down only its own callers.
        """
        engine = subs[0][0].engine
        min_epoch = subs[0][0].min_epoch
        reg = self.registry
        all_calls = [c for sub in subs for c in sub]
        n_total = sum(len(c.queries) for c in all_calls)
        with obs.trace(), obs.span(
            "coalesce_stacked_group", cat="query", calls=len(all_calls),
            n=n_total, tenants=len(subs), engine=engine,
        ):

            def _shed_call(c, entry=None, cached=False, epoch=-1):
                reg.counter(
                    "serve.query.shed", tenant=c.tenant.name
                ).inc(len(c.queries))
                c.results = [
                    self._shed_result(
                        q, entry, cached, epoch, c.tenant.name
                    )
                    for q in c.queries
                ]

            # the wave's epoch wait is bounded by its most patient
            # caller; any deadline-free caller restores the default wait
            kw = {}
            if all(c.deadline is not None for c in all_calls):
                kw["timeout"] = max(
                    0.0,
                    max(c.deadline for c in all_calls)
                    - time.perf_counter(),
                )
            with obs.span(
                "acquire_epoch", cat="query", min_epoch=min_epoch
            ):
                try:
                    snap = self.runtime.acquire(min_epoch, **kw)
                except TimeoutError:
                    for c in all_calls:
                        _shed_call(c)
                    return
            if min_epoch is not None:
                now = time.perf_counter()
                for c in all_calls:
                    self._m_epoch_wait_s.observe(now - c.enq_t)
            # per-tenant lane prep: cache entry + per-caller plan
            lanes: list = []  # (tenant, ctx, entry, calls)
            merged: dict[tuple[str, int], list] = {}
            for sub in subs:
                t: Tenant = sub[0].tenant
                try:
                    with obs.span(
                        "cache_entry", cat="query", tenant=t.name,
                        epoch=snap.epoch,
                    ):
                        entry, cached = self._entry(t, snap)
                    ctx = self._solve_context(t, snap, entry)
                except BaseException as e:  # noqa: BLE001 -- isolate the
                    # failed lane; the rest of the wave proceeds
                    for c in sub:
                        c.error = e
                    continue
                lane_i = len(lanes)
                lanes.append((t, ctx, entry, sub))
                first = True
                for c in sub:
                    c.from_cache = cached or not first
                    first = False
                    reg.counter(
                        "serve.query.cache_hits" if c.from_cache
                        else "serve.query.cache_misses",
                        tenant=t.name,
                    ).inc()
                    c.results = [None] * len(c.queries)
                    c.specs = [
                        self._solve_spec(entry, q) for q in c.queries
                    ]
                    groups = partition_by_engine(
                        ctx,
                        c.specs,
                        engine=c.engine,
                        hints=[q.engine_hint for q in c.queries],
                        cost_model=self.cost_model,
                        batch_size=n_total,
                        stacked=True,
                    )
                    c.degraded = set()
                    shed_ix: set = set()
                    if c.deadline is not None:
                        with obs.span("admit", cat="query"):
                            groups, c.degraded, shed_ix = self._admit(
                                ctx, c.specs, groups, t.name,
                                c.deadline - time.perf_counter(),
                            )
                        if c.degraded:
                            reg.counter(
                                "serve.query.degraded", tenant=t.name
                            ).inc(len(c.degraded))
                        if shed_ix:
                            reg.counter(
                                "serve.query.shed", tenant=t.name
                            ).inc(len(shed_ix))
                    for i in shed_ix:
                        c.results[i] = self._shed_result(
                            c.queries[i], entry, c.from_cache,
                            snap.epoch, t.name,
                        )
                    for name, idxs in groups.items():
                        for i in idxs:
                            kb = bucket_pow2(max(1, c.specs[i].k))
                            merged.setdefault((name, kb), []).append(
                                (lane_i, c, i)
                            )

            def _fan(lane_i, li, sols):
                lt, _ctx, lentry, _sub = lanes[lane_i]
                for (c, i), sol in zip(li, sols):
                    loc = np.asarray(sol.local_indices, np.int64)
                    c.results[i] = QueryResult(
                        indices=lentry.src_idx[loc],
                        local_indices=loc,
                        diversity=sol.value,
                        variant=c.queries[i].variant,
                        engine=sol.engine,
                        coreset_size=lentry.size,
                        from_cache=c.from_cache,
                        epoch=snap.epoch,
                        tenant=lt.name,
                        degraded=i in c.degraded,
                    )

            # merged launches: per (engine, k-bucket), stack the lanes
            # the engine can take together; solve the rest per lane
            for (name, kb) in sorted(merged):
                items = merged[(name, kb)]
                eng = get_engine(name)
                per_lane: dict[int, list] = {}
                for lane_i, c, i in items:
                    per_lane.setdefault(lane_i, []).append((c, i))
                stacks: dict[tuple, list[int]] = {}
                solo: list[int] = []
                for lane_i, li in per_lane.items():
                    ctx = lanes[lane_i][1]
                    if all(
                        eng.stack_eligible(ctx, c.specs[i])
                        for c, i in li
                    ):
                        sig = (ctx.size, str(ctx.D.dtype))
                        stacks.setdefault(sig, []).append(lane_i)
                    else:
                        solo.append(lane_i)
                # a lone stackable lane has nothing to amortize with
                for sig in list(stacks):
                    if len(stacks[sig]) < 2:
                        solo.extend(stacks.pop(sig))
                for sig, lis in stacks.items():
                    lane_args = []
                    parts = []
                    for lane_i in lis:
                        ctx = lanes[lane_i][1]
                        li = per_lane[lane_i]
                        lspecs = [c.specs[i] for c, i in li]
                        lane_args.append((ctx, lspecs))
                        parts.append(
                            (len(lspecs), max(s.k for s in lspecs))
                        )
                    m = sig[0]
                    rows = sum(b for b, _k in parts)
                    self._note_window_cost(
                        self.cost_model.estimate_stacked(name, parts, m)
                    )
                    t1 = time.perf_counter()
                    c0 = self._compiles.total()
                    with obs.span(
                        "solve", cat="query", engine=name, n=rows,
                        k_bucket=kb, stacked_tenants=len(lis),
                        coalesced_calls=len({
                            id(c)
                            for lane_i in lis
                            for c, _ in per_lane[lane_i]
                        }),
                    ):
                        lane_sols = eng.solve_batch_stacked(lane_args)
                    with obs.span(
                        "device_sync", cat="query", engine=name
                    ):
                        for lane_i, sols in zip(lis, lane_sols):
                            _fan(lane_i, per_lane[lane_i], sols)
                    dt = time.perf_counter() - t1
                    reg.counter("serve.coalesce.stacked_solves").inc()
                    reg.counter(
                        "serve.coalesce.stacked_rows"
                    ).inc(rows)
                    reg.histogram(
                        "serve.coalesce.stacked_tenants"
                    ).observe(len(lis))
                    for lane_i in lis:
                        reg.histogram(
                            "serve.solve.latency_s",
                            tenant=lanes[lane_i][0].name, engine=name,
                        ).observe(dt)
                    reg.histogram(
                        "serve.solve.batch_size", engine=name
                    ).observe(rows)
                    if self._compiles.total() == c0:
                        self.cost_model.observe(
                            name, rows, max(k for _b, k in parts), m, dt
                        )
                for lane_i in solo:
                    lt, ctx, _e, _sub = lanes[lane_i]
                    li = per_lane[lane_i]
                    lspecs = [c.specs[i] for c, i in li]
                    self._note_window_cost(
                        self.cost_model.estimate(
                            name, B=len(li),
                            kmax=max(s.k for s in lspecs), m=ctx.size,
                        )
                    )
                    t1 = time.perf_counter()
                    c0 = self._compiles.total()
                    with obs.span(
                        "solve", cat="query", engine=name, n=len(li),
                        k_bucket=kb,
                        coalesced_calls=len({id(c) for c, _ in li}),
                    ):
                        sols = eng.solve_batch(ctx, lspecs)
                    with obs.span(
                        "device_sync", cat="query", engine=name
                    ):
                        _fan(lane_i, li, sols)
                    dt = time.perf_counter() - t1
                    reg.histogram(
                        "serve.solve.latency_s", tenant=lt.name,
                        engine=name,
                    ).observe(dt)
                    reg.histogram(
                        "serve.solve.batch_size", engine=name
                    ).observe(len(li))
                    if self._compiles.total() == c0:
                        self.cost_model.observe(
                            name, len(li), max(s.k for s in lspecs),
                            ctx.size, dt,
                        )
            now = time.perf_counter()
            for lt, _ctx, _e, sub in lanes:
                for c in sub:
                    reg.histogram(
                        "serve.query.latency_s", tenant=lt.name
                    ).observe(now - c.enq_t)
                    reg.histogram(
                        "serve.query.batch_size", tenant=lt.name
                    ).observe(len(c.queries))
                    if c.deadline is not None and now > c.deadline:
                        reg.counter(
                            "serve.query.deadline_miss", tenant=lt.name
                        ).inc()

    # ------------------------------------------------------------------
    # freshness + observability
    # ------------------------------------------------------------------

    def flush(self, *, timeout: Optional[float] = 120.0) -> int:
        """Barrier every submitted batch into a published epoch and return
        its number (pass as ``min_epoch`` to read your own writes)."""
        return self.runtime.flush(timeout=timeout)

    def tenant_traffic(self) -> dict:
        """Per-tenant traffic from the ``serve.query.*`` series: cumulative
        requests and queries, the in-flight gauge, and the QPS since the
        previous ``stats()`` / ``tenant_traffic()`` call."""
        reg = self.registry
        now = time.perf_counter()
        out = {}
        for name in self.tenants.names():
            requests = reg.counter(
                "serve.query.requests", tenant=name
            ).value
            queries = reg.counter("serve.query.queries", tenant=name).value
            prev_t, prev_q = self._traffic_prev.get(
                name, (self._traffic_t0, 0)
            )
            dt = now - prev_t
            self._traffic_prev[name] = (now, queries)
            out[name] = {
                "requests": requests,
                "queries": queries,
                "in_flight": reg.gauge(
                    "serve.query.in_flight", tenant=name
                ).value,
                "qps": (queries - prev_q) / dt if dt > 0 else 0.0,
            }
        return out

    def stats(self) -> dict:
        """One observability snapshot: the runtime's epoch counters, the
        cache's ``CacheStats``, per-tenant traffic, the coalescer's window
        and queue accounting and the cost model's state."""
        lat = self.runtime.latest()
        return {
            "epoch": 0 if lat is None else lat.epoch,
            "epoch_fingerprint": None if lat is None else lat.fingerprint,
            "coreset_size": 0 if lat is None else lat.size,
            "n_offered": self.runtime.n_offered,
            "pending": self.runtime.pending,
            "epochs_published": self.runtime.epochs_published,
            "snapshot_materializations": (
                self.runtime.snapshot_materializations
            ),
            "tenants": self.tenants.names(),
            "cache_entries": len(self.cache),
            "cache": self.cache.stats.snapshot(),
            "active_calls": self.active_calls(),
            "tenant_traffic": self.tenant_traffic(),
            "coalesce": (
                None if self.coalescer is None else self.coalescer.stats()
            ),
            "cost_model": self.cost_model.snapshot(),
        }

    def drain_pending(self) -> list:
        """Failover support: stop this frontend's coalescer and return
        every in-window ``PendingCall`` *un-failed* -- the callers stay
        blocked on their events. The drainer (``ReplicaSet.failover``)
        re-dispatches them on the promoted frontend via
        ``adopt_pending``. Idempotent with ``close()``: after draining,
        this frontend is closed."""
        self._closed = True
        self._compiles.close()
        if self.coalescer is None:
            return []
        return self.coalescer.drain()

    def adopt_pending(self, calls: list) -> int:
        """Re-dispatch ``PendingCall``s drained from a failed peer
        frontend on THIS frontend: remap each call's tenant to the local
        registry (replica frontends register the same tenant names),
        solve, and release the still-blocked caller. Calls drained from
        ALL of the peer's dispatcher shards arrive here; they regroup by
        ``(engine, min_epoch)`` and a multi-tenant group re-dispatches
        as one stacked wave, exactly as the pool would have run it.
        Returns the number of calls released."""
        released = 0
        waves: dict[tuple, dict[str, list]] = {}
        for c in calls:
            try:
                c.tenant = self._resolve_tenant(c.tenant.name)
            except BaseException as e:  # noqa: BLE001 -- fan the failure
                # back to the blocked caller; adoption must release all
                c.error = e
                c.done.set()
                released += 1
                continue
            waves.setdefault(
                (c.engine, c.min_epoch), {}
            ).setdefault(c.tenant.name, []).append(c)
        for by_tenant in waves.values():
            subs = list(by_tenant.values())
            grp = [c for sub in subs for c in sub]
            try:
                if len(subs) == 1:
                    self._solve_coalesced(subs[0])
                else:
                    self._solve_coalesced_stacked(subs)
            except BaseException as e:  # noqa: BLE001
                for c in grp:
                    c.error = e
            finally:
                for c in grp:
                    c.done.set()
                    released += 1
        return released

    def close(self) -> None:
        """Shut down the coalescer's dispatcher thread (idempotent). The
        runtime is owned by the caller and is not touched."""
        if self._closed:
            return
        self._closed = True
        self._compiles.close()
        if self.coalescer is not None:
            self.coalescer.close()
