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
(K3), the cache's matrices (K1) and the batched engines.

Fault tolerance (README, port section): ``durability=`` adds a
write-ahead log and periodic checkpoints (``StreamRuntime.restore`` /
``DiversityService.restore`` rebuild a bit-identical stream, from the
port's directory or the reference's: the formats are the same),
``fault_policy=FaultPolicy(...)`` supervises the ingest worker,
``query_batch(deadline_s=...)`` degrades or sheds, and
``faults=FaultPlan(...)`` arms the seeded fault-injection harness.
Concurrent ``query_batch`` calls coalesce (``CoalesceConfig``).

Replication: ``ReplicaSet`` ships the primary's WAL records to hot
standbys that replay them through their own supervised ingest, verifies
parity by fingerprint exchange (divergent standbys fence and re-seed),
serves stale-but-consistent reads from standbys under saturation, and
promotes the most caught-up standby when the primary dies, with no
acknowledged batch lost. ``HealthMonitor`` drives the heartbeat, lag and
parity probes; ``IntegrityAuditor`` spot-checks the published coreset's
invariants off the hot path and quarantines failing standbys.
"""
from .audit import AuditConfig, AuditReport, IntegrityAuditor
from .cache import (
    CacheKey,
    CacheStats,
    CoresetEntry,
    DistanceCache,
    coreset_fingerprint,
)
from .checkpoint import (
    DurabilityConfig,
    checkpoint_watermark,
    latest_checkpoint,
    list_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
from .coalesce import CoalesceConfig, Coalescer
from .faults import (
    FaultPlan,
    FaultPolicy,
    FaultRule,
    InjectedCrash,
    InjectedFault,
)
from .frontend import QueryFrontend
from .health import HealthConfig, HealthMonitor
from .query import DiversityQuery, QueryResult, candidate_mask
from .replication import (
    Replica,
    ReplicaSet,
    ReplicationConfig,
    ReplicationGap,
    Standby,
)
from .runtime import (
    EpochSnapshot,
    IngestReport,
    PoisonedBatch,
    StreamRuntime,
)
from .service import DiversityService
from .tenants import DEFAULT_TENANT, Tenant, TenantRegistry
from .wal import WalError, WalRecord, WriteAheadLog

__all__ = [
    "CacheKey", "CacheStats", "CoresetEntry", "DistanceCache",
    "coreset_fingerprint", "DiversityQuery", "QueryResult",
    "candidate_mask", "DiversityService", "IngestReport", "EpochSnapshot",
    "StreamRuntime", "QueryFrontend", "CoalesceConfig", "Coalescer",
    "Tenant", "TenantRegistry", "DEFAULT_TENANT",
    "DurabilityConfig", "checkpoint_watermark", "latest_checkpoint",
    "list_checkpoints", "load_checkpoint", "save_checkpoint",
    "FaultPlan", "FaultPolicy", "FaultRule",
    "InjectedCrash", "InjectedFault", "PoisonedBatch",
    "WalError", "WalRecord", "WriteAheadLog",
    "Replica", "ReplicaSet", "ReplicationConfig", "ReplicationGap",
    "Standby", "HealthConfig", "HealthMonitor",
    "AuditConfig", "AuditReport", "IntegrityAuditor",
]
