"""Stateful online diversity service: a thin facade over the serving
runtime (``StreamRuntime`` + ``QueryFrontend``).

Reference: ``repro/serve/diversity/service.py``. The serving state is
what the paper says to keep (§4.4, §5.2): the resumable streaming-scan
state and the small coreset it induces, both on the card. The layers
split along the write/read seam:

  StreamRuntime   owns the scan state across the placement drives
                  (``vmap``, ``pipeline``), resumes the blocked Alg.-2 scan
                  per batch (K3 once a block), fingerprints the coreset on
                  the card and publishes immutable epoch snapshots;
  QueryFrontend   answers queries from published epochs only: per-tenant
                  ``DistanceCache`` entries (K1 once per changed epoch and
                  key), ``core.solvers`` registry dispatch, the
                  ``min_epoch``/``flush()`` freshness contract.

``DiversityService`` wires one runtime to one frontend with one default
tenant and keeps the reference's single-tenant API:

    svc = DiversityService(spec, k=10, tau=64, caps=caps, device="cuda")
    svc.warmup(d=5000)                      # build K3 and K1 ahead
    svc.ingest(batch, cats)                 # host numpy batches
    svc.runtime.submit(batch, cats)         # non-blocking ingestion
    svc.frontend.register_tenant("u", spec=MatroidSpec("uniform"))
    res = svc.query(DiversityQuery(k=10))

``durability=DurabilityConfig(dir)`` (or a path) gives the runtime a
write-ahead log and checkpoints; ``DiversityService.restore(dir,
device=...)`` rebuilds the service from them, bit for bit. The frontend
coalesces concurrent ``query_batch`` calls by default (``coalesce=``).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from ... import obs
from ...core import geometry
from ...core.matroid import MatroidSpec
from ...device import CUDA, DeviceLike
from .cache import DistanceCache
from .frontend import QueryFrontend
from .query import DiversityQuery, QueryResult
from .runtime import EpochSnapshot, IngestReport, StreamRuntime

__all__ = [
    "DiversityService", "IngestReport", "EpochSnapshot",
]

# the CUDA sources the serving path launches: K3 (precheck.cu, every
# ingest block) and K1 (pdist.cu, every cache build)
SERVE_KERNELS = ("precheck", "pdist")


class DiversityService:
    """Online DMMC: incremental coreset ingestion + cached batched queries
    (single-tenant facade over ``StreamRuntime`` + ``QueryFrontend``)."""

    def __init__(
        self,
        spec: MatroidSpec,
        k: int,
        *,
        tau: int,
        metric: geometry.Metric = "euclidean",
        caps: Optional[np.ndarray] = None,
        slot_cap: Optional[int] = None,
        variant: str = "radius",
        eps: float = 0.5,
        c_const: int = 32,
        oracle=None,
        cache: Optional[DistanceCache] = None,
        num_shards: int = 1,
        block_size: int = 128,
        placement: str = "auto",
        registry=None,
        durability=None,
        fault_policy=None,
        faults=None,
        cost_model=None,
        coalesce=None,
        device: DeviceLike = CUDA,
    ):
        self._wire(
            StreamRuntime(
                spec, k,
                tau=tau, metric=metric, caps=caps, slot_cap=slot_cap,
                variant=variant, eps=eps, c_const=c_const, oracle=oracle,
                num_shards=num_shards, block_size=block_size,
                placement=placement, registry=registry,
                durability=durability, fault_policy=fault_policy,
                faults=faults, device=device,
            ),
            cache=cache,
            registry=registry,
            cost_model=cost_model,
            coalesce=coalesce,
        )

    def _wire(self, runtime: StreamRuntime, *, cache=None, registry=None,
              cost_model=None, coalesce=None):
        self.runtime = runtime
        self.frontend = QueryFrontend(
            runtime, cache=cache, registry=registry,
            cost_model=cost_model, coalesce=coalesce,
        )
        self.cache = self.frontend.cache
        self.cache_key = self.frontend.default_tenant.key
        self.device = runtime.device
        self.spec = runtime.spec
        self.k = runtime.k
        self.tau = runtime.tau
        self.metric = runtime.metric
        self.caps = runtime.caps
        self.slot_cap = runtime.slot_cap
        self.stream_variant = runtime.stream_variant
        self.eps = runtime.eps
        self.c_const = runtime.c_const
        self.oracle = runtime.oracle
        self.num_shards = runtime.num_shards
        self.block_size = runtime.block_size
        self.placement = runtime.placement
        return self

    @classmethod
    def from_runtime(
        cls, runtime: StreamRuntime, *, cache=None, registry=None,
        cost_model=None, coalesce=None,
    ) -> "DiversityService":
        """Wrap an existing runtime in the single-tenant facade without
        constructing a new stream."""
        svc = cls.__new__(cls)
        return svc._wire(
            runtime, cache=cache, registry=registry,
            cost_model=cost_model, coalesce=coalesce,
        )

    @classmethod
    def restore(
        cls,
        durability,
        *,
        oracle=None,
        cache=None,
        registry=None,
        fault_policy=None,
        faults=None,
        device: DeviceLike = CUDA,
        **overrides,
    ) -> "DiversityService":
        """Rebuild a service on ``device`` from its durability dir: the
        newest checkpoint + WAL-tail replay, bit-identical to the stream
        that died (see ``StreamRuntime.restore``; the report is at
        ``svc.runtime.restore_report``)."""
        rt = StreamRuntime.restore(
            durability, oracle=oracle, registry=registry,
            fault_policy=fault_policy, faults=faults, device=device,
            **overrides,
        )
        return cls.from_runtime(rt, cache=cache, registry=registry)

    # ------------------------------------------------------------------
    # ingestion (the runtime's synchronous path)
    # ------------------------------------------------------------------

    @property
    def state(self):
        """The live scan state (updated in place by the next ``ingest``;
        see ``StreamRuntime.state``)."""
        return self.runtime.state

    @property
    def n_offered(self) -> int:
        return self.runtime.n_offered

    @property
    def _fingerprint(self) -> Optional[int]:
        return self.runtime.fingerprint

    def ingest(
        self,
        points: np.ndarray,
        cats: Optional[np.ndarray] = None,
        *,
        pad_to: Optional[int] = None,
    ) -> IngestReport:
        """Feed one batch of the stream synchronously (see
        ``StreamRuntime.ingest``); ``svc.runtime.submit`` is the
        non-blocking path to the same stream."""
        return self.runtime.ingest(points, cats, pad_to=pad_to)

    def ingest_sharded(
        self,
        points: np.ndarray,
        cats: Optional[np.ndarray] = None,
        *,
        pad_to: Optional[int] = None,
    ) -> IngestReport:
        """Row-granular sharded deal (``vmap`` drive); see
        ``StreamRuntime.ingest_sharded``."""
        return self.runtime.ingest_sharded(points, cats, pad_to=pad_to)

    def ingest_pipeline(
        self,
        points: np.ndarray,
        cats: Optional[np.ndarray] = None,
        *,
        pad_to: Optional[int] = None,
    ) -> IngestReport:
        """Batch-granular round-robin deal (``pipeline`` placement); see
        ``StreamRuntime.ingest_pipeline``."""
        return self.runtime.ingest_pipeline(points, cats, pad_to=pad_to)

    def warmup(
        self,
        d: Optional[int] = None,
        *,
        ingest_sizes: Sequence[int] = (),
        ks: Sequence[int] = (),
        query_batch_sizes: Sequence[int] = (1,),
        variants: Sequence[str] = ("sum",),
    ) -> dict:
        """Build ahead what the first real ingest and query would
        otherwise build inside their latency.

        On the card: the K3 and K1 libraries (``kernels._build.library``,
        an nvcc build each unless already on disk, reported as compile
        events under ``warmup[kernels]``). Then, on any device, an
        all-invalid batch of each padded size in ``ingest_sizes`` (and
        ``block_size``) through the real ingest path: a no-op for the
        scan. Then one discarded query batch per (variant, k, batch size),
        which also builds the default tenant's matrix; skipped, with a
        ``"queries": "skipped (...)"`` note, until something was ingested.
        Needs the point dimension: ``d`` before the first ingest.

        Returns ``{label: seconds}`` per warmed item.
        """
        report: dict = {}
        if d is None:
            d = self.runtime.point_dim()
            if d is None:
                raise ValueError(
                    "warmup() before the first ingest needs the point "
                    "dimension: warmup(d=...)"
                )
        if self.device.type == "cuda":
            from ...kernels._build import library

            t0 = time.perf_counter()
            with obs.compile_region("warmup[kernels]"):
                for name in SERVE_KERNELS:
                    library(name)
            report["kernels"] = time.perf_counter() - t0
        self.runtime.ensure_state(d)
        for size in dict.fromkeys(
            int(s) for s in (*ingest_sizes, self.block_size)
        ):
            t0 = time.perf_counter()
            self.ingest(np.zeros((0, d), np.float32), pad_to=size)
            report[f"ingest[{size}]"] = time.perf_counter() - t0
        if self._fingerprint is None or self.snapshot()[0].shape[0] == 0:
            report["queries"] = "skipped (ingest something first)"
            return report
        for variant in variants:
            for k in dict.fromkeys(int(x) for x in (*ks, self.k)):
                for bs in query_batch_sizes:
                    qs = [
                        DiversityQuery(k=k, variant=variant)
                        for _ in range(int(bs))
                    ]
                    t0 = time.perf_counter()
                    self.query_batch(qs)
                    report[f"query[{variant} k={k} b={bs}]"] = (
                        time.perf_counter() - t0
                    )
        return report

    def snapshot(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Compacted current coreset (points, cats, src_idx) on the host,
        buffer order (the shard-major union when sharded). Reads the
        published epoch (publishing a pending synchronous ingest first):
        repeated calls on an unchanged stream return the same arrays."""
        snap = self.runtime.refresh()
        return snap.points, snap.cats, snap.src_idx

    # ------------------------------------------------------------------
    # queries (the frontend's default tenant)
    # ------------------------------------------------------------------

    def query(
        self,
        q: DiversityQuery,
        *,
        engine: str = "auto",
        deadline_s: Optional[float] = None,
    ) -> QueryResult:
        """Answer one query on the cached coreset matrix. ``engine="auto"``
        picks an engine with the host-parity guarantee (the selection
        equals the host engine's); ``"host"`` forces the reference solver;
        any registered name forces that engine."""
        return self.frontend.query(q, engine=engine, deadline_s=deadline_s)

    def query_batch(
        self,
        queries: Sequence[DiversityQuery],
        *,
        engine: str = "auto",
        deadline_s: Optional[float] = None,
    ) -> list[QueryResult]:
        """Answer a batch of queries against ONE cache entry (see
        ``QueryFrontend.query_batch``)."""
        return self.frontend.query_batch(
            queries, engine=engine, deadline_s=deadline_s
        )

    def close(self) -> None:
        """Stop the frontend's coalescer and the runtime's async worker,
        if they were started."""
        self.frontend.close()
        self.runtime.close()
