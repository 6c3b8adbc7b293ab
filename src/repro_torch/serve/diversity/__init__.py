"""Online diversity serving stack of the port (the paper's web-search and
recommendation workload, §1): keep a small coreset as the serving state,
ingest the stream incrementally, answer many heterogeneous queries against
cached coreset distance matrices.

Reference: ``repro/serve/diversity/__init__.py``. Layered runtime:

    rt = StreamRuntime(spec, k=10, tau=64, caps=caps)     # one stream
    fe = QueryFrontend(rt)                                # reads epochs
    rt.submit(batch, cats)                # async: background ingest loop
    fe.register_tenant("cosine", metric="cosine")         # cache fan-out
    res = fe.query(DiversityQuery(k=10), tenant="cosine")
    e = fe.flush()                        # freshness barrier -> epoch
    fe.query(DiversityQuery(k=10), min_epoch=e)   # read your own writes

Single-tenant facade:

    svc = DiversityService(spec, k=10, tau=64, caps=caps, metric="cosine")
    svc.ingest(batch, cats=batch_cats)
    res = svc.query(DiversityQuery(k=10))

Everything runs on the card unless ``device="cpu"`` is passed: the scan
(K3), the cache's matrices (K1) and the batched engines. Ported so far
(ROADMAP steps 7 and 9): queries, the cache, tenants, the fault plan and
policy of the supervised worker, the runtime, the frontend and the
service. ROADMAP step 10 brings the write-ahead log, checkpoints and
restore, query coalescing, health, replication and audit.
"""
from .cache import (
    CacheKey,
    CacheStats,
    CoresetEntry,
    DistanceCache,
    coreset_fingerprint,
)
from .faults import (
    FaultPlan,
    FaultPolicy,
    FaultRule,
    InjectedCrash,
    InjectedFault,
)
from .frontend import QueryFrontend
from .query import DiversityQuery, QueryResult, candidate_mask
from .runtime import (
    EpochSnapshot,
    IngestReport,
    PoisonedBatch,
    StreamRuntime,
)
from .service import DiversityService
from .tenants import DEFAULT_TENANT, Tenant, TenantRegistry

__all__ = [
    "CacheKey", "CacheStats", "CoresetEntry", "DistanceCache",
    "coreset_fingerprint", "DiversityQuery", "QueryResult",
    "candidate_mask", "DiversityService", "IngestReport", "EpochSnapshot",
    "StreamRuntime", "QueryFrontend", "Tenant", "TenantRegistry",
    "DEFAULT_TENANT", "FaultPlan", "FaultPolicy", "FaultRule",
    "InjectedCrash", "InjectedFault", "PoisonedBatch",
]
