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
           once a batch; ``deadline_s`` degrades or sheds.

Every call takes the direct path, which the reference defines as
byte-for-byte the answers of its coalescing path. The micro-batch
coalescer (``coalesce.py``, ``drain_pending``/``adopt_pending``) comes with
ROADMAP step 10: ``coalesce=`` with ``enabled`` true raises
``NotImplementedError``.

Two threads now launch kernels: the runtime's worker (K3) and query
callers (K1 on a cold entry). Both use the default CUDA stream, so a
query's K1 queues behind the worker's scan.

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
    get_engine,
    partition_by_engine,
)
from ...obs.torchprof import RecompileWatch
from .cache import CoresetEntry, DistanceCache
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
        coalesce=None,
    ):
        if coalesce is not None and getattr(coalesce, "enabled", True):
            raise NotImplementedError(
                "query coalescing comes with ROADMAP step 10 (coalesce.py); "
                "every call takes the direct path, the same answers")
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
        self.coalescer = None
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
        """``query_batch`` calls currently inside the frontend."""
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
        ``.deadline_miss`` per tenant).
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
        """The direct solve path (one caller, one tenant, one epoch)."""
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
        cache's ``CacheStats``, per-tenant traffic and the cost model's
        state (``coalesce`` is None: no coalescer yet)."""
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
            "coalesce": None,
            "cost_model": self.cost_model.snapshot(),
        }

    def close(self) -> None:
        """Stop counting compile events (idempotent). The runtime is owned
        by the caller and is not touched."""
        if self._closed:
            return
        self._closed = True
        self._compiles.close()
