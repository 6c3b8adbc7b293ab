"""Replicated serving: WAL-shipped hot standbys + fingerprint-verified
failover.

Reference: ``repro/serve/diversity/replication.py``. On one card every
replica's state lives on that card: each replica is a full runtime on its
``device`` (K3 in its own scan, K1 in its own cache), and a re-seed copies
the primary's checkpoint onto the standby's device.

The paper's composability argument (§3: the coreset scan is a pure fold
over the batch sequence) is exactly the property that makes state-machine
replication cheap. A ``ReplicaSet`` runs one *primary* ``StreamRuntime``
and one or more *standby* runtimes; every batch accepted by
``ReplicaSet.submit`` is

  1. appended to the primary's write-ahead log (``submit`` is
     log-then-enqueue, so once it returns the batch is durable),
  2. shipped -- same seq, same bytes -- into each standby's apply queue,
  3. acked to the submitter.

Each standby replays shipped records through its own supervised ingest
path (``StreamRuntime.submit``: worker thread, retry/quarantine policy,
its own WAL carrying the *same* seq numbers) and publishes its own
``EpochSnapshot``s -- so a standby is a complete, query-able serving stack
at all times, not a cold spare.

Divergence detection is O(1) host sync: both replicas see the identical
batch sequence, so the ``n_offered`` watermark after each ingest is a
shared coordinate, and ``StreamRuntime.fingerprint_at(n)`` compares the
coreset content hashes recorded at that watermark. A standby whose
fingerprint disagrees with the primary's at any common watermark
*self-fences* (excluded from reads and from promotion) and is re-seeded
from the primary's latest checkpoint instead of ever serving a wrong
answer.

Failover promotes the most-caught-up healthy standby: its apply queue is
drained, the old primary's durable WAL tail (records the standby never
saw -- acked batches survive there by construction) is replayed on top,
and only then does it start taking new submissions. In-window coalesced
query calls parked on the dead primary's frontend are drained un-failed
(``QueryFrontend.drain_pending``) and re-dispatched on the promoted
frontend (``adopt_pending``), so blocked callers get answers, not
"frontend closed" errors.

Chaos sites (see ``faults.py``): ``replication.ship`` (drop a shipped
record on the wire -- the standby heals from the primary's WAL, or
re-seeds if compaction already folded the record into a checkpoint) and
``replica.crash`` (kill a standby's apply thread).

Metrics: ``serve.replication.shipped`` / ``ship_errors`` / ``applied`` /
``lag_batches`` (gauge per replica + histogram) / ``divergence`` /
``reseeds`` / ``failovers`` / ``failover_s`` / ``stale_reads``.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import os
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from ... import obs
from ...core.matroid import MatroidSpec
from .checkpoint import DurabilityConfig, latest_checkpoint, load_checkpoint
from .faults import FaultPlan, FaultPolicy, InjectedCrash, InjectedFault
from .frontend import QueryFrontend
from .runtime import StreamRuntime
from .wal import WalError, WalRecord

_log = logging.getLogger("repro_torch.serve.diversity.replication")


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Knobs for a ``ReplicaSet``.

    apply_poll_s              standby apply-thread wakeup cadence while idle;
    promote_timeout_s         bound on the promoted standby's queue-drain +
                              WAL-tail replay + flush during failover;
    saturation_active_calls   route deadline-free reads to a standby when
                              the primary frontend has at least this many
                              calls in flight (stale-but-consistent reads);
    fence_on_divergence       a fingerprint mismatch fences the standby;
    reseed_on_divergence      a fenced standby is automatically re-seeded
                              from the primary's latest checkpoint on the
                              next ``verify_standbys``/``repair`` pass;
    max_read_lag_batches      a standby more than this many acked batches
                              behind is skipped for stale reads.
    """

    apply_poll_s: float = 0.05
    promote_timeout_s: float = 30.0
    saturation_active_calls: int = 4
    fence_on_divergence: bool = True
    reseed_on_divergence: bool = True
    max_read_lag_batches: int = 64


@dataclasses.dataclass
class Replica:
    """One serving stack (runtime + frontend) inside a ``ReplicaSet``."""

    name: str
    runtime: StreamRuntime
    frontend: QueryFrontend


class ReplicationGap(RuntimeError):
    """Shipped records were lost AND already compacted out of the
    primary's WAL -- the standby cannot catch up by tail replay and must
    re-seed from a checkpoint."""


class Standby:
    """A hot standby: wraps a full serving stack plus the apply thread
    that replays shipped WAL records through it in seq order.

    The standby's runtime should be *durable* (its own WAL/checkpoint
    dir): applied records land in its log under the primary's seq
    numbers, which is what makes it promotable with full durability.
    """

    def __init__(
        self,
        name: str,
        runtime: StreamRuntime,
        frontend: QueryFrontend,
        *,
        config: Optional[ReplicationConfig] = None,
        fetch_tail: Optional[Callable[[int, int], "list[WalRecord]"]] = None,
        ckpt_floor: Optional[Callable[[], int]] = None,
        faults: Optional[FaultPlan] = None,
    ):
        self.name = name
        self.runtime = runtime
        self.frontend = frontend
        self.config = config if config is not None else ReplicationConfig()
        self.faults = faults if faults is not None else runtime.faults
        self._fetch_tail = fetch_tail
        self._ckpt_floor = ckpt_floor
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self.dead = False  # apply thread crashed (replica.crash)
        self.fenced = False
        self.fence_reason: Optional[str] = None
        self.quarantined = False  # set by the integrity auditor
        self.needs_reseed = False
        self.applied_upto = -1  # newest seq fed into the supervised path
        self.shipped_upto = -1  # newest seq enqueued by ship()
        self.verified_at = -1  # newest watermark with confirmed parity
        reg = runtime.registry
        self._m_applied = reg.counter(
            "serve.replication.applied", replica=name
        )
        self._m_gap_heals = reg.counter(
            "serve.replication.gap_heals", replica=name
        )
        self._m_crashes = reg.counter(
            "serve.replication.apply_crashes", replica=name
        )
        self._thread: Optional[threading.Thread] = threading.Thread(
            target=self._apply_loop, name=f"standby-{name}", daemon=True
        )
        self._thread.start()

    # -- shipping side -------------------------------------------------

    def ship(self, rec: WalRecord) -> None:
        """Enqueue one primary WAL record for apply (never blocks)."""
        with self._cv:
            self._q.append(rec)
            self.shipped_upto = max(self.shipped_upto, rec.seq)
            self._cv.notify_all()

    @property
    def lag_batches(self) -> int:
        """Shipped-but-unapplied record count (the queue view of lag;
        the ``ReplicaSet`` computes acked-vs-applied lag on top)."""
        with self._cv:
            return len(self._q)

    @property
    def promotable(self) -> bool:
        return not (self.dead or self.fenced or self.quarantined)

    # -- apply side ----------------------------------------------------

    def _apply_loop(self) -> None:
        try:
            while True:
                with self._cv:
                    while (not self._q or self.fenced) and not self._closed:
                        self._cv.wait(self.config.apply_poll_s)
                    if self._closed:
                        return
                    if self.fenced:
                        continue
                    rec = self._q.popleft()
                try:
                    self._apply_record(rec)
                except InjectedFault as e:
                    # transient apply failure: the record stays
                    # unapplied -- the next shipped record's gap fetch
                    # recovers it from the primary's WAL
                    _log.warning(
                        "standby %s apply of seq %d failed "
                        "(injected, will gap-heal): %s",
                        self.name, rec.seq, e,
                    )
        except InjectedCrash:
            self.dead = True
            self._m_crashes.inc()
            _log.warning("standby %s apply thread killed (injected)",
                         self.name)
        except Exception as e:  # noqa: BLE001 -- a dead standby is a
            # health condition, not a crash of the whole set
            self.dead = True
            self._m_crashes.inc()
            _log.warning("standby %s apply thread died: %s: %s",
                         self.name, type(e).__name__, e)

    def _apply_record(self, rec: WalRecord) -> None:
        if self.faults is not None:
            # "crash" kills the apply thread (caught in _apply_loop);
            # "error" is a transient apply failure -> the record stays
            # unapplied and the gap heals from the primary's WAL later
            self.faults.check("replica.crash")
        if rec.seq <= self.applied_upto:
            return  # already covered (reseed raced a queued record)
        expect = self.applied_upto + 1
        if rec.seq > expect and self._fetch_tail is not None:
            # ship gap (a dropped record): recover the missing span from
            # the primary's durable log. Seqs absent from the log that a
            # checkpoint may cover force a re-seed; seqs absent and NOT
            # checkpoint-covered were burned (append failed, never
            # acked) and are safely skipped.
            recs = self._fetch_tail(self.applied_upto, rec.seq - 1)
            got = {r.seq for r in recs}
            missing = [s for s in range(expect, rec.seq) if s not in got]
            floor = self._ckpt_floor() if self._ckpt_floor else -1
            if any(s <= floor for s in missing):
                self._fence(
                    f"wal gap: seqs {missing} already compacted into a "
                    f"checkpoint (floor={floor})"
                )
                self.needs_reseed = True
                return
            for r in recs:
                self._apply_one(r)
                self._m_gap_heals.inc()
        self._apply_one(rec)

    def _apply_one(self, rec: WalRecord) -> None:
        rt = self.runtime
        with rt._cv:
            # force the standby's own WAL to carry the primary's seq: the
            # two logs stay record-for-record identical
            rt._next_seq = rec.seq
        rt.submit(rec.points, rec.cats)
        self.applied_upto = rec.seq
        self._m_applied.inc()

    # -- divergence ----------------------------------------------------

    def verify(self, primary_rt: StreamRuntime) -> Optional[bool]:
        """O(1) parity check: compare this standby's newest recorded
        ``(n_offered, fingerprint)`` against the primary's fingerprint at
        the same watermark. Returns ``True`` (parity), ``False``
        (divergence -- the standby fences itself), or ``None`` when no
        common watermark exists yet."""
        rt = self.runtime
        with rt._cv:
            hist_s = list(rt._fp_history)
        if not hist_s:
            return None
        with primary_rt._cv:
            hist_p = dict(primary_rt._fp_history)
            n_p = primary_rt.n_offered
            min_p = min(hist_p, default=0)
        # newest standby watermark the primary can judge. The primary
        # records EVERY ingest boundary, so within [min_p, n_p] its
        # history coverage is contiguous -- a standby watermark in that
        # range that the primary never recorded means the standby folded
        # a batch boundary the primary never had (itself divergence).
        for ns, fps in reversed(hist_s):
            if ns > n_p:
                continue  # primary hasn't reached this watermark yet
            if ns < min_p:
                return None  # aged out of the primary's bounded history
            fpp = hist_p.get(ns)
            if fpp == fps:
                self.verified_at = max(self.verified_at, ns)
                return True
            if self.config.fence_on_divergence:
                if fpp is None:
                    self._fence(
                        f"watermark misalignment at n_offered={ns}: the "
                        f"primary never ingested to that boundary"
                    )
                else:
                    self._fence(
                        f"fingerprint divergence at n_offered={ns}: "
                        f"primary={fpp:#x} standby={fps:#x}"
                    )
                self.needs_reseed = True
            return False
        return None

    def _fence(self, reason: str) -> None:
        with self._cv:
            if not self.fenced:
                self.fenced = True
                self.fence_reason = reason
                self.runtime.registry.counter(
                    "serve.replication.divergence", replica=self.name
                ).inc()
                _log.warning("standby %s fenced: %s", self.name, reason)

    # -- lifecycle -----------------------------------------------------

    def stop(self, *, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the apply thread; with ``drain=True`` any backlog still
        queued is applied inline by the caller (promotion path). Records
        that fail to apply here are recovered by the promoted runtime's
        WAL-tail replay, so a fault mid-drain cannot lose acked data."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)
        self._thread = None
        if not drain:
            return
        while True:
            with self._cv:
                if not self._q:
                    return
                rec = self._q.popleft()
            try:
                self._apply_record(rec)
            except (InjectedCrash, Exception):  # noqa: BLE001 -- see above
                continue

    def close(self) -> None:
        self.stop(drain=False)
        self.frontend.close()
        try:
            self.runtime.close(drain=False)
        except BaseException:  # noqa: BLE001 -- best-effort teardown
            pass


class ReplicaSet:
    """Facade over a primary + standbys: every write is WAL-appended on
    the primary, shipped to all standbys, then acked; reads go to the
    primary unless it is saturated (deadline-free reads may fall back to
    a caught-up standby); primary death promotes the most-caught-up
    standby after replaying its WAL tail. See the module docstring for
    the durability argument.
    """

    def __init__(
        self,
        primary: Replica,
        standbys: Sequence[Standby],
        *,
        config: Optional[ReplicationConfig] = None,
        faults: Optional[FaultPlan] = None,
        registry: Optional[obs.MetricsRegistry] = None,
    ):
        self.config = config if config is not None else ReplicationConfig()
        self.faults = faults if faults is not None else (
            primary.runtime.faults
        )
        self.registry = registry if registry is not None else (
            primary.runtime.registry
        )
        self._mu = threading.RLock()
        self._primary = primary
        self._standbys: list[Standby] = list(standbys)
        for sb in self._standbys:
            if sb._fetch_tail is None:
                sb._fetch_tail = self._tail_records
            if sb._ckpt_floor is None:
                sb._ckpt_floor = self._primary_ckpt_floor
        self._retired: list[Replica] = []
        self._acked_seq = -1
        self._acked_batches = 0
        self._acked_points = 0
        self._closed = False
        self.last_failover: Optional[dict] = None
        reg = self.registry
        self._m_shipped = reg.counter("serve.replication.shipped")
        self._m_ship_errors = reg.counter("serve.replication.ship_errors")
        self._m_acked = reg.counter("serve.replication.acked_batches")
        self._m_failovers = reg.counter("serve.replication.failovers")
        self._m_failover_s = reg.histogram("serve.replication.failover_s")
        self._m_reseeds = reg.counter("serve.replication.reseeds")
        self._m_stale_reads = reg.counter("serve.replication.stale_reads")
        self._m_lag_hist = reg.histogram("serve.replication.lag_batches")

    # -- construction --------------------------------------------------

    @classmethod
    def create(
        cls,
        spec: MatroidSpec,
        k: int,
        *,
        dir: str,
        n_standbys: int = 1,
        caps: Optional[np.ndarray] = None,
        oracle=None,
        registry: Optional[obs.MetricsRegistry] = None,
        config: Optional[ReplicationConfig] = None,
        faults: Optional[FaultPlan] = None,
        standby_faults: Optional[FaultPlan] = None,
        fault_policy: Optional[FaultPolicy] = None,
        durability: Optional[DurabilityConfig] = None,
        coalesce=None,
        **runtime_kw,
    ) -> "ReplicaSet":
        """Build a primary + ``n_standbys`` identically configured
        serving stacks under ``dir`` (each replica gets its own
        WAL/checkpoint subdirectory). ``faults`` instruments the
        primary, ``standby_faults`` the standbys; ``runtime_kw`` is
        forwarded to every ``StreamRuntime`` (``device=`` included: every
        replica runs there, on the card by default)."""
        reg = registry if registry is not None else obs.default_registry()
        cfg = config if config is not None else ReplicationConfig()

        def _dur(sub: str) -> DurabilityConfig:
            base = durability if durability is not None else (
                DurabilityConfig(dir="")
            )
            return dataclasses.replace(base, dir=os.path.join(dir, sub))

        def _stack(name: str, plan) -> tuple[StreamRuntime, QueryFrontend]:
            rt = StreamRuntime(
                spec, k, caps=caps, oracle=oracle, registry=reg,
                durability=_dur(name), faults=plan,
                fault_policy=fault_policy, **runtime_kw,
            )
            fe = QueryFrontend(rt, registry=reg, coalesce=coalesce)
            return rt, fe

        prt, pfe = _stack("primary", faults)
        primary = Replica(name="primary", runtime=prt, frontend=pfe)
        standbys = []
        for i in range(n_standbys):
            srt, sfe = _stack(f"standby-{i}", standby_faults)
            standbys.append(Standby(
                f"standby-{i}", srt, sfe, config=cfg,
                faults=standby_faults,
            ))
        return cls(
            primary, standbys, config=cfg, faults=faults, registry=reg,
        )

    # -- topology ------------------------------------------------------

    @property
    def primary(self) -> Replica:
        return self._primary

    @property
    def standbys(self) -> "list[Standby]":
        return list(self._standbys)

    @property
    def acked_seq(self) -> int:
        return self._acked_seq

    def register_tenant(self, name: str, **kw):
        """Register a tenant on every replica's frontend (so stale reads
        and post-failover serving see the same tenant set). Returns the
        primary's ``Tenant`` handle."""
        with self._mu:
            t = self._primary.frontend.register_tenant(name, **kw)
            for sb in self._standbys:
                sb.frontend.register_tenant(name, **kw)
            return t

    # -- write path ----------------------------------------------------

    def submit(
        self, points: np.ndarray, cats: Optional[np.ndarray] = None
    ) -> int:
        """Durably accept one batch: primary WAL append (log-then-
        enqueue), ship to every standby, then ack. Once this returns,
        the batch survives the death of the primary *process* (its WAL
        row) and of the primary *runtime* (the shipped copies + failover
        tail replay). If the primary is already unhealthy the set fails
        over and the batch is accepted by the promoted primary instead --
        the caller never has to know."""
        if self._closed:
            raise RuntimeError("replica set is closed")
        with self._mu:
            last_err: Optional[BaseException] = None
            for _attempt in range(2):
                p = self._primary
                try:
                    seq = p.runtime.submit(points, cats)
                    break
                except (WalError, ValueError):
                    raise  # durable-append failure / nonfinite: caller's
                except RuntimeError as e:
                    # dead worker / closed runtime: promote and retry once
                    last_err = e
                    self._failover_locked(
                        expect=p, reason=f"submit failed: {e}"
                    )
            else:
                raise RuntimeError(
                    "submit failed on primary and on the promoted standby"
                ) from last_err
            rec = WalRecord(
                seq=seq,
                points=np.asarray(points, np.float32),
                cats=None if cats is None else np.asarray(cats, np.int32),
            )
            for sb in self._standbys:
                self._ship(sb, rec)
            self._acked_seq = max(self._acked_seq, seq)
            self._acked_batches += 1
            self._acked_points += int(rec.points.shape[0])
            self._m_acked.inc()
            return seq

    def _ship(self, sb: Standby, rec: WalRecord) -> None:
        if self.faults is not None:
            try:
                self.faults.check("replication.ship")
            except InjectedFault as e:
                # dropped on the wire: the standby heals from the
                # primary's WAL (gap fetch) or re-seeds
                self._m_ship_errors.inc()
                _log.warning("ship seq %d -> %s dropped: %s",
                             rec.seq, sb.name, e)
                return
        sb.ship(rec)
        self._m_shipped.inc()

    def ingest(
        self, points: np.ndarray, cats: Optional[np.ndarray] = None
    ) -> int:
        """Alias of ``submit`` -- all writes to a replica set go through
        the replicated path (a direct ``runtime.ingest`` would bypass
        shipping and diverge the standbys)."""
        return self.submit(points, cats)

    # -- read path -----------------------------------------------------

    def query_batch(
        self,
        queries,
        *,
        tenant=None,
        engine: str = "auto",
        min_epoch: Optional[int] = None,
        deadline_s: Optional[float] = None,
        allow_stale: bool = True,
    ):
        """Primary read, with two availability escapes: (1) when the
        primary frontend is saturated and the call has no freshness
        requirement (``min_epoch is None``), a caught-up healthy standby
        answers instead -- stale-but-consistent, never torn; (2) a read
        that dies because the primary was being failed over retries once
        on the promoted primary."""
        p = self._primary
        if (
            allow_stale
            and min_epoch is None
            and p.frontend.active_calls()
            >= self.config.saturation_active_calls
        ):
            sb = self._pick_read_standby()
            if sb is not None:
                self._m_stale_reads.inc()
                return sb.frontend.query_batch(
                    queries, tenant=tenant, engine=engine,
                    deadline_s=deadline_s,
                )
        try:
            return p.frontend.query_batch(
                queries, tenant=tenant, engine=engine,
                min_epoch=min_epoch, deadline_s=deadline_s,
            )
        except RuntimeError:
            with self._mu:
                promoted = self._primary is not p
            if not promoted:
                raise
            return self._primary.frontend.query_batch(
                queries, tenant=tenant, engine=engine,
                min_epoch=min_epoch, deadline_s=deadline_s,
            )

    def query(self, q, **kw):
        return self.query_batch([q], **kw)[0]

    def _pick_read_standby(self) -> Optional[Standby]:
        best = None
        for sb in self._standbys:
            if not sb.promotable:
                continue
            if sb.runtime.latest() is None:
                continue
            lag = self._acked_seq - sb.applied_upto
            if lag > self.config.max_read_lag_batches:
                continue
            if best is None or sb.applied_upto > best.applied_upto:
                best = sb
        return best

    # -- fingerprint exchange + repair ---------------------------------

    def verify_standbys(self) -> dict:
        """One fingerprint-exchange round: each standby's newest
        watermark is compared against the primary (O(1) per standby --
        no flush, no coreset shipping). Divergent standbys fence; with
        ``reseed_on_divergence`` they are re-seeded immediately.
        Returns ``{standby name: True | False | None}``."""
        out = {}
        with self._mu:
            prt = self._primary.runtime
            for sb in self._standbys:
                if sb.dead:
                    out[sb.name] = None
                    continue
                out[sb.name] = sb.verify(prt)
            if self.config.reseed_on_divergence:
                self._repair_locked()
        return out

    def repair(self) -> int:
        """Re-seed every fenced standby from the primary's latest
        checkpoint. Returns the number of standbys repaired."""
        with self._mu:
            return self._repair_locked()

    def _repair_locked(self) -> int:
        n = 0
        for sb in self._standbys:
            if sb.fenced and sb.needs_reseed and not sb.dead:
                self._reseed_locked(sb)
                n += 1
        return n

    def _reseed_locked(self, sb: Standby) -> None:
        """Install the primary's latest checkpoint into a fenced standby
        and resume shipping past its watermark -- the replication analogue
        of ``StreamRuntime.restore`` without a process restart. The loaded
        host arrays are copied onto the standby's device."""
        p = self._primary
        path = p.runtime.checkpoint(force=True)
        if path is None:
            path = latest_checkpoint(p.runtime.durability.dir)
        if path is None:
            _log.warning("reseed %s: primary has no checkpoint", sb.name)
            return
        state, meta = load_checkpoint(path)
        rt = sb.runtime
        rt.flush(timeout=self.config.promote_timeout_s)
        with rt._cv:
            rt._install(state, meta)
        rt.refresh(force=True)
        watermark = int(meta["wal_seq"])
        with sb._cv:
            sb.applied_upto = max(sb.applied_upto, watermark)
            sb._q = collections.deque(
                r for r in sb._q if r.seq > watermark
            )
            sb.fenced = False
            sb.fence_reason = None
            sb.needs_reseed = False
            sb._cv.notify_all()
        self._m_reseeds.inc()
        _log.info("standby %s re-seeded from %s (watermark=%d)",
                  sb.name, path, watermark)

    def _tail_records(
        self, after_seq: int, upto_seq: int
    ) -> "list[WalRecord]":
        """Primary WAL records with ``after_seq < seq <= upto_seq`` (the
        standby gap-heal fetch). Deliberately lock-free w.r.t. the set
        mutex: failover joins apply threads while holding it."""
        p = self._primary
        wal = p.runtime._wal
        if wal is None:
            return []
        out = []
        for rec in wal.replay(after_seq=after_seq):
            if rec.seq > upto_seq:
                break
            out.append(rec)
        return out

    def _primary_ckpt_floor(self) -> int:
        return self._primary.runtime._last_ckpt_seq

    # -- failover ------------------------------------------------------

    def check_primary(self) -> Optional[str]:
        """Cheap liveness probe of the primary (no failover): returns
        ``None`` when healthy, else the failure reason. The
        ``health.heartbeat`` chaos site fires here."""
        p = self._primary
        rt = p.runtime
        try:
            if self.faults is not None:
                self.faults.check("health.heartbeat")
            if rt._closed:
                return "primary runtime closed"
            with rt._cv:
                rt._raise_worker_error()
            return None
        except InjectedCrash as e:
            return f"heartbeat crashed: {e}"
        except Exception as e:  # noqa: BLE001 -- any probe failure counts
            return f"{type(e).__name__}: {e}"

    def failover(self, *, reason: str = "manual",
                 expect: Optional[Replica] = None) -> str:
        """Promote the most-caught-up promotable standby. Returns the
        promoted replica's name. Raises when no standby is promotable."""
        with self._mu:
            return self._failover_locked(expect=expect, reason=reason)

    def _failover_locked(
        self, *, expect: Optional[Replica], reason: str
    ) -> str:
        old = self._primary
        if expect is not None and old is not expect:
            return old.name  # somebody already failed over
        t0 = time.perf_counter()
        with obs.span("failover", cat="replication", reason=reason):
            cands = [sb for sb in self._standbys if sb.promotable]
            if not cands:
                raise RuntimeError(
                    f"failover ({reason}): no promotable standby "
                    f"(of {len(self._standbys)})"
                )
            # 1. stop the old intake; park in-window coalesced calls
            try:
                drained = old.frontend.drain_pending()
            except BaseException:  # noqa: BLE001
                drained = []
            # 2. most-caught-up standby wins
            sb = max(cands, key=lambda s: (s.applied_upto, s.shipped_upto))
            # 3. replay its WAL tail: first its own apply queue, then
            #    whatever the old primary's durable log still holds
            #    beyond it -- this is what makes acked == durable across
            #    the failover
            sb.stop(drain=True, timeout=self.config.promote_timeout_s)
            old_wal = old.runtime._wal
            if old_wal is not None:
                try:
                    for rec in old_wal.replay(after_seq=sb.applied_upto):
                        sb._apply_one(rec)
                except Exception as e:  # noqa: BLE001 -- a torn old log
                    # tail ends the replay at the last whole record
                    _log.warning("failover tail replay stopped: %s", e)
            sb.runtime.flush(timeout=self.config.promote_timeout_s)
            # 4. retire the old primary (WAL read is done; close frees it)
            try:
                old.runtime.close(drain=False)
            except BaseException:  # noqa: BLE001 -- it was dying anyway
                pass
            promoted = Replica(
                name=sb.name, runtime=sb.runtime, frontend=sb.frontend
            )
            self._standbys.remove(sb)
            self._retired.append(old)
            self._primary = promoted
            # 5. release callers parked on the dead frontend
            if drained:
                promoted.frontend.adopt_pending(drained)
        dt = time.perf_counter() - t0
        self._m_failovers.inc()
        self._m_failover_s.observe(dt)
        self.last_failover = dict(
            reason=reason,
            promoted=sb.name,
            retired=old.name,
            duration_s=dt,
            acked_seq=self._acked_seq,
            applied_seq=sb.applied_upto,
            drained_calls=len(drained),
            fingerprint=self._primary.runtime.fingerprint,
        )
        _log.warning("failover (%s): promoted %s in %.3fs",
                     reason, sb.name, dt)
        return sb.name

    # -- barriers + stats ----------------------------------------------

    def flush(self, *, timeout: Optional[float] = 120.0) -> int:
        """Primary freshness barrier (see ``StreamRuntime.flush``). A
        primary that died with acked batches still queued fails this
        barrier -- the set promotes (the WAL-tail replay recovers those
        batches) and the flush lands on the new primary."""
        last_err: Optional[BaseException] = None
        for _attempt in range(2):
            p = self._primary
            try:
                return p.runtime.flush(timeout=timeout)
            except RuntimeError as e:
                last_err = e
                with self._mu:
                    self._failover_locked(
                        expect=p, reason=f"flush failed: {e}"
                    )
        raise RuntimeError(
            "flush failed on primary and on the promoted standby"
        ) from last_err

    def sync(self, *, timeout: float = 60.0) -> None:
        """Replication barrier: primary flushed AND every live standby
        has applied everything acked so far."""
        deadline = time.monotonic() + timeout
        self.flush(timeout=timeout)
        acked = self._acked_seq
        for sb in list(self._standbys):
            if not sb.promotable:
                continue
            while sb.applied_upto < acked:
                if sb.dead or time.monotonic() > deadline:
                    raise TimeoutError(
                        f"standby {sb.name} stuck at seq "
                        f"{sb.applied_upto} < acked {acked}"
                    )
                time.sleep(0.002)
            try:
                sb.runtime.flush(
                    timeout=max(0.1, deadline - time.monotonic())
                )
            except RuntimeError as e:
                # a standby whose own worker died is no longer a replica
                sb.dead = True
                _log.warning("standby %s failed sync flush: %s",
                             sb.name, e)

    def observe_lag(self) -> dict:
        """Record per-standby replication lag (acked - applied, in
        batches) into the gauge + histogram; returns the snapshot."""
        out = {}
        acked = self._acked_seq
        for sb in self._standbys:
            lag = max(0, acked - sb.applied_upto)
            out[sb.name] = lag
            self.registry.gauge(
                "serve.replication.lag_batches", replica=sb.name
            ).set(float(lag))
            self._m_lag_hist.observe(float(lag))
        return out

    def stats(self) -> dict:
        return dict(
            primary=self._primary.name,
            acked_seq=self._acked_seq,
            acked_batches=self._acked_batches,
            acked_points=self._acked_points,
            failovers=int(self._m_failovers.value),
            reseeds=int(self._m_reseeds.value),
            lag=self.observe_lag(),
            standbys=[
                dict(
                    name=sb.name,
                    applied_seq=sb.applied_upto,
                    shipped_seq=sb.shipped_upto,
                    verified_at=sb.verified_at,
                    fenced=sb.fenced,
                    fence_reason=sb.fence_reason,
                    dead=sb.dead,
                    quarantined=sb.quarantined,
                )
                for sb in self._standbys
            ],
            last_failover=self.last_failover,
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with self._mu:
            for sb in self._standbys:
                sb.close()
            self._primary.frontend.close()
            try:
                self._primary.runtime.close(drain=True)
            except BaseException:  # noqa: BLE001 -- best-effort teardown
                pass
            for r in self._retired:
                try:
                    r.frontend.close()
                except BaseException:  # noqa: BLE001
                    pass
