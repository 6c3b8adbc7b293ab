"""StreamRuntime: the ingestion half of the diversity serving runtime.

Reference: ``repro/serve/diversity/runtime.py``. One runtime owns ONE
physical stream -- the resumable Alg.-2 scan state(s) under the placement
drive it resolved (one state or a stacked ``vmap``/``shard_map`` state
on ``device``, or the ``pipeline`` placement's list of per-shard states,
dealt round robin over the visible cards) -- and offers two ways to feed
it and one way to read it:

  ingest(points, cats)   synchronous: resume the scan, update the O(1)
                         epoch fingerprint, return an ``IngestReport``;
  submit(points, cats)   asynchronous: enqueue the batch for a background
                         ingest worker and return; the worker runs the
                         same scan and publishes epochs as it drains;
  latest()/acquire()     the newest published ``EpochSnapshot``: the
                         compacted coreset on the host, built once per
                         changed epoch. Queries only read snapshots, so a
                         query concurrent with ingestion answers from a
                         consistent (maybe slightly stale) epoch.

Batches arrive on the host, as a client's would. Each one is padded to a
multiple of ``block_size`` with invalid rows, copied to the card once,
checked there for NaN/Inf (``submit`` checks on the host, so the
submitter gets the error), write-ahead logged on a durable runtime,
normalized on the card (``core.geometry.normalize_for_metric``) and
scanned by ``core.streaming.ingest_batch_donated``, which launches K3
(fused route) once a block. The fingerprint is one device reduction and
one copy of three scalars (``epoch_fingerprint``); a publish gathers the
valid coreset rows on the card before copying them (``compact_coreset``).

Epoch semantics, as in the reference: epochs increase strictly from 1;
a new epoch materializes only when the fingerprint moved (a forced
publish of an unchanged coreset reuses the previous buffers); the worker
publishes when its queue drains and at least every ``publish_every``
batches; ``flush()`` waits for every submitted batch, force-publishes and
returns the epoch, which ``acquire(min_epoch=...)`` can wait for.

Fault tolerance, as in the reference:

* with ``durability=DurabilityConfig(dir)`` every accepted batch is
  appended to a write-ahead log (``wal.py``) *before* it is enqueued or
  applied, and the scan state is checkpointed every ``checkpoint_every``
  applied batches (``checkpoint.py``); ``StreamRuntime.restore(dir,
  device=...)`` rebuilds the stream bit for bit from the newest
  checkpoint plus the log's tail, replayed in submission order (§3: the
  state is a pure fold over the batches). The files are the reference's,
  so either package restores the other's directory. The scan updates the
  state in place, so a checkpoint copies it to the host under the lock;
* ``fault_policy=FaultPolicy(...)`` supervises the worker (retry with
  capped backoff, quarantine to ``poison`` or truncate, respawn after a
  crash);
* ``faults=FaultPlan(...)`` arms the injection sites (``worker.loop``,
  ``worker.ingest``, ``wal.append``, ``wal.compact``,
  ``checkpoint.write``).

With the default policy a worker error truncates the stream and
re-raises on the next ``submit``/``flush``; ``close()`` drains the queue,
stops the worker and, on a durable runtime, saves a parting checkpoint.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import os
import queue
import threading
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from ... import obs
from ...core import geometry
from ...core.compose import compact_coreset, snapshot_at_epoch
from ...core.matroid import MatroidSpec
from ...core.solvers.jit_sum import bucket_pow2 as _bucket_pow2
from ...core.streaming import (
    epoch_fingerprint,
    ingest_batch_donated,
    ingest_batch_sharded_donated,
    ingest_batch_sharded_mapped,
    init_sharded_states,
    init_stream_state,
    resolve_placement,
    visible_devices,
)
from ...device import CUDA, DeviceLike, resolve_device
from .checkpoint import (
    DurabilityConfig,
    checkpoint_path,
    host_copy,
    latest_checkpoint,
    load_checkpoint,
    place_state,
    prune_checkpoints,
    save_checkpoint,
)
from .faults import FaultPlan, FaultPolicy, InjectedCrash
from .wal import WriteAheadLog


@dataclasses.dataclass
class IngestReport:
    n: int  # points in this batch
    total: int  # stream points offered so far
    coreset_size: int
    coreset_changed: bool
    ingest_s: float


@dataclasses.dataclass(frozen=True)
class EpochSnapshot:
    """One published, immutable serving epoch: the compacted union coreset
    at a consistent instant, on the host, plus its content fingerprint.
    Later ingests update the live state in place; a snapshot is a copy and
    any number of reader threads can solve on it."""

    epoch: int  # strictly increasing publication counter (from 1)
    fingerprint: int  # coreset content hash at publication
    points: np.ndarray  # f32[m, d] stream-metric-normalized coreset rows
    cats: np.ndarray  # int32[m, gamma]
    src_idx: np.ndarray  # int64[m] global stream indices
    n_offered: int  # stream points ingested when this epoch was published
    published_at: float  # the runtime clock at publication

    @property
    def size(self) -> int:
        return int(self.src_idx.shape[0])


@dataclasses.dataclass(frozen=True)
class PoisonedBatch:
    """One quarantined batch: it failed every ingest attempt under a
    ``FaultPolicy(on_failure="quarantine")`` runtime. The data is kept so
    the operator can inspect or re-``submit`` it; ``seq`` is its WAL
    ordinal (-1 when the runtime is not durable)."""

    seq: int
    points: np.ndarray
    cats: Optional[np.ndarray]
    attempts: int
    error: BaseException


_STOP = object()  # worker shutdown sentinel

_log = logging.getLogger("repro_torch.serve.diversity")


class StreamRuntime:
    """Ingestion engine + epoch publisher for one physical stream."""

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
        num_shards: int = 1,
        block_size: int = 128,
        placement: str = "auto",
        publish_every: int = 8,
        max_pending: int = 64,
        on_publish: Optional[Callable[[EpochSnapshot], None]] = None,
        registry: Optional[obs.MetricsRegistry] = None,
        durability: Optional[Union[DurabilityConfig, str]] = None,
        fault_policy: Optional[FaultPolicy] = None,
        faults: Optional[FaultPlan] = None,
        device: DeviceLike = CUDA,
    ):
        if spec.kind == "general" and oracle is None:
            raise ValueError("general matroid service needs a host oracle")
        if spec.kind == "partition" and caps is None:
            raise ValueError("partition matroid service needs per-category caps")
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if publish_every < 1:
            raise ValueError(f"publish_every must be >= 1, got {publish_every}")
        self.device = resolve_device(device)
        self.placement = resolve_placement(placement, num_shards,
                                           self.device)
        self.spec = spec
        self.k = int(k)
        self.tau = int(tau)
        self.metric = metric
        self.caps = None if caps is None else np.asarray(caps, np.int32)
        self.slot_cap = slot_cap
        self.stream_variant = variant
        self.eps = float(eps)
        self.c_const = int(c_const)
        self.oracle = oracle
        self.num_shards = int(num_shards)
        self.block_size = int(block_size)
        self.publish_every = int(publish_every)
        self.on_publish = on_publish
        # one state, a stacked state (vmap, shard_map) or a list of states
        # (pipeline)
        self._state = None
        self._gamma_width = max(spec.gamma, 1)
        self.n_offered = 0
        self._fingerprint: Optional[int] = None
        self._coreset_size = 0
        self._rr = 0  # pipeline round-robin cursor (batch granularity)
        # per-shard (fingerprint, size) of the pipeline drive: only the
        # shard an ingest touched is reduced again
        self._fp_cache: Optional[list] = None
        # --- epoch publication state (guarded by _cv's lock) ---
        self._cv = threading.Condition(threading.RLock())
        self._published: Optional[EpochSnapshot] = None
        self._dirty = False  # ingested since last publish
        self._unpublished = 0  # ingests since last publish
        self.epochs_published = 0
        self.snapshot_materializations = 0
        # --- async ingestion (lazy worker) ---
        self._queue: queue.Queue = queue.Queue(maxsize=int(max_pending))
        self._worker: Optional[threading.Thread] = None
        self._worker_err: Optional[BaseException] = None
        self._pending = 0  # submitted batches not yet fully ingested
        self._closed = False
        self._force_stop = False  # close(drain=False): drop, don't ingest
        # --- supervised worker ---
        self.fault_policy = (
            fault_policy if fault_policy is not None else FaultPolicy()
        )
        self.faults = faults
        # epoch stamps and staleness read one clock (an injected skew
        # shifts all of them); wait deadlines stay on the real clock
        self._clock = (
            faults.monotonic if faults is not None else time.monotonic
        )
        if isinstance(durability, str):
            durability = DurabilityConfig(dir=durability)
        self.durability = durability
        self._wal: Optional[WriteAheadLog] = None
        self._next_seq = 0  # next submission ordinal to assign
        self._applied_seq = -1  # newest seq folded into the scan state
        self._last_ckpt_seq = -1  # _applied_seq at the last checkpoint
        self._poisoned_seqs: list[int] = []  # skipped on WAL replay
        self._replaying = False  # restore() replay: don't re-append
        self._inflight = None  # batch a crashed worker must re-apply first
        self._worker_restarts = 0
        self.poison: list[PoisonedBatch] = []
        self.restore_report: Optional[dict] = None
        # --- observability ---
        # submit times of worker-ingested batches awaiting an epoch; the
        # publish drains them into the staleness histogram. Under _cv.
        self._stale_pending: list[float] = []
        self.registry = registry if registry is not None else (
            obs.default_registry()
        )
        reg = self.registry
        self._m_ingest_s = reg.histogram(
            "serve.ingest.latency_s", placement=self.placement
        )
        self._m_ingest_points = reg.counter(
            "serve.ingest.points", placement=self.placement
        )
        self._m_ingest_batches = reg.counter(
            "serve.ingest.batches", placement=self.placement
        )
        self._m_queue_depth = reg.gauge("serve.submit.queue_depth")
        self._m_submitted = reg.counter("serve.submit.batches")
        self._m_publish_s = reg.histogram("serve.epoch.publish_latency_s")
        self._m_staleness_s = reg.histogram("serve.epoch.staleness_s")
        self._m_epochs = reg.counter("serve.epoch.published")
        self._m_materializations = reg.counter(
            "serve.epoch.materializations"
        )
        self._m_worker_errors = reg.counter("serve.worker.errors")
        self._m_callback_errors = reg.counter(
            "serve.publish.callback_errors"
        )
        self._m_worker_retries = reg.counter("serve.worker.retries")
        self._m_worker_poisoned = reg.counter("serve.worker.poisoned")
        self._m_worker_crashes = reg.counter("serve.worker.crashes")
        self._m_worker_restarts = reg.counter("serve.worker.restarts")
        self._m_ckpt_saved = reg.counter("serve.ckpt.saved")
        self._m_ckpt_failures = reg.counter("serve.ckpt.failures")
        self._m_ckpt_last_seq = reg.gauge("serve.ckpt.last_seq")
        self._m_rejected_nonfinite = reg.counter(
            "serve.ingest.rejected", reason="nonfinite"
        )
        # (n_offered, fingerprint) after each ingest: two runtimes fed the
        # same batches agree at every common watermark (replication.py)
        self._fp_history: collections.deque = collections.deque(maxlen=1024)
        if self.durability is not None:
            os.makedirs(self.durability.dir, exist_ok=True)
            self._wal = WriteAheadLog(
                self.durability.wal_path,
                fsync=self.durability.fsync,
                faults=self.faults,
                registry=reg,
            )

    # ------------------------------------------------------------------
    # synchronous ingestion (the scan itself)
    # ------------------------------------------------------------------

    @property
    def state(self):
        """The live scan state: a ``StreamState`` (one shard), a stacked
        one (vmap) or a list (pipeline). Ingests update it in place, so a
        reference taken here changes with the next ``ingest``; published
        ``EpochSnapshot``s are host copies and never change."""
        return self._state

    @property
    def fingerprint(self) -> Optional[int]:
        """Coreset content fingerprint as of the last ingest (``None``
        until something was ingested or ``ensure_state`` ran)."""
        return self._fingerprint

    def fingerprint_at(self, n_offered: int) -> Optional[int]:
        """Fingerprint right after the ingest that brought the stream to
        ``n_offered`` points, or ``None`` if no ingest landed exactly there
        (or it aged out of the bounded history)."""
        with self._cv:
            for n, fp in reversed(self._fp_history):
                if n == n_offered:
                    return fp
                if n < n_offered:
                    break
            return None

    def fingerprint_watermarks(self) -> list[int]:
        """The ``n_offered`` watermarks in the fingerprint history."""
        with self._cv:
            return [n for n, _fp in self._fp_history]

    def _reject_nonfinite(self) -> None:
        self._m_rejected_nonfinite.inc()
        raise ValueError(
            "batch contains non-finite point coordinates (NaN/Inf); "
            "rejected"
        )

    def _check_finite(self, points: np.ndarray) -> None:
        """Reject NaN/Inf points at the door, on the host (``submit``:
        the submitter gets the error)."""
        pts = np.asarray(points)
        if pts.size and not bool(np.isfinite(pts).all()):
            self._reject_nonfinite()

    def _to_device(self, pts: np.ndarray) -> torch.Tensor:
        """One copy of a host batch to the card, checked there for NaN/Inf
        before anything is applied: one reduction on the card in place of
        a host ``np.isfinite`` pass over the batch, which cost more than
        the copy and the scan together (``PERF.md`` §5)."""
        x = torch.as_tensor(pts, device=self.device)
        if x.numel() and not bool(torch.isfinite(x).all()):
            self._reject_nonfinite()
        return x

    def _check_cats(self, n: int, cats: Optional[np.ndarray]) -> np.ndarray:
        if cats is None:
            return np.zeros((n, self._gamma_width), np.int32)
        cats_arr = np.asarray(cats, np.int32).reshape(n, -1)
        if cats_arr.shape[1] != self._gamma_width:
            raise ValueError(
                f"cats width {cats_arr.shape[1]} != spec gamma "
                f"{self._gamma_width}"
            )
        if (
            self.spec.kind == "partition"
            and cats_arr.shape[1] > 1
            and np.any(cats_arr[:, 1:] >= 0)
        ):
            # a partition matroid is single-label by definition
            raise ValueError(
                "partition service got a point with >1 category label; "
                "use a transversal MatroidSpec for multi-label data"
            )
        return cats_arr

    def _devices(self) -> list:
        """The devices the placements deal shard states over (every
        visible card for a CUDA runtime, else the runtime's device)."""
        return visible_devices(self.device)

    def _init_state(self, d: int) -> None:
        kw = dict(slot_cap=self.slot_cap, device=self.device)
        args = (d, self._gamma_width, self.spec, self.k, self.tau)
        if self.num_shards > 1 and self.placement == "pipeline":
            # the reference's _init_pipeline_states: round robin over the
            # devices (on one card every state lives on it)
            devs = self._devices()
            self._state = [
                init_stream_state(*args, slot_cap=self.slot_cap,
                                  device=devs[i % len(devs)])
                for i in range(self.num_shards)]
        elif self.num_shards > 1:
            self._state = init_sharded_states(self.num_shards, *args, **kw)
        else:
            self._state = init_stream_state(*args, **kw)

    def ensure_state(self, d: int) -> None:
        """Initialize the empty scan state for dimension ``d`` if none
        exists yet, and fingerprint it (the warmup entry point)."""
        with self._cv:
            if self._state is not None:
                return
            self._init_state(d)
            self._fingerprint, self._coreset_size = (
                self._fingerprint_and_size()
            )
            self._fp_history.append((self.n_offered, self._fingerprint))
            self._dirty = True  # first refresh publishes the empty epoch

    def point_dim(self) -> Optional[int]:
        if self._state is None:
            return None
        x1 = (
            self._state[0].x1
            if isinstance(self._state, list)
            else self._state.x1
        )
        return int(x1.shape[-1])

    def _padded(self, points, cats, pad_to: Optional[int]):
        """Host batch -> (n, d, normalized points on the device, cats,
        valid), padded with invalid rows to a multiple of ``block_size``.
        Raises before anything is logged or applied on bad cats or NaN/Inf
        points."""
        pts = np.asarray(points, np.float32)
        n, d = pts.shape
        cats_arr = self._check_cats(n, cats)
        total = max(n, pad_to or 0)
        pad = total + (-total % self.block_size) - n
        if pad:
            pts = np.concatenate([pts, np.zeros((pad, d), np.float32)])
            cats_arr = np.concatenate(
                [cats_arr, np.full((pad, self._gamma_width), -1, np.int32)]
            )
        x = self._to_device(pts)
        valid = np.arange(n + pad) < n
        return (n, d, geometry.normalize_for_metric(x, self.metric),
                cats_arr, valid)

    def _scan_kw(self) -> dict:
        return dict(variant=self.stream_variant, eps=self.eps,
                    c_const=self.c_const)

    def ingest(
        self,
        points: np.ndarray,
        cats: Optional[np.ndarray] = None,
        *,
        pad_to: Optional[int] = None,
    ) -> IngestReport:
        """Feed one batch of the stream (any size) into the scan state.

        With ``num_shards > 1`` the batch is dealt across the shards
        (the ``ingest_sharded`` or ``ingest_pipeline`` drive, by
        placement); otherwise it resumes the single blocked scan. Batches
        are padded to a multiple of ``block_size`` with invalid rows, a
        no-op for the scan; ``pad_to`` raises the padded length further
        (``warmup`` drives an empty batch that way).

        Thread-safe (the async worker calls this too); does NOT publish an
        epoch. On a durable runtime this entry point write-ahead logs the
        batch before applying it (``submit`` logs at enqueue time
        instead); calling ``ingest_sharded``/``ingest_pipeline`` directly
        bypasses the log. Raises ``ValueError`` on NaN/Inf coordinates,
        checked on the device after the copy and before the log: the
        batch is neither logged nor applied.
        """
        with self._cv:
            if self.num_shards > 1:
                drive = (self._ingest_pipeline if self.placement == "pipeline"
                         else self._ingest_sharded)
                return drive(points, cats, pad_to, log=True)
            t0 = time.perf_counter()
            n, d, pts_norm, cats_arr, valid = self._padded(points, cats,
                                                           pad_to)
            seq = self._wal_begin(points, cats)
            if self._state is None:
                self._init_state(d)
            with obs.compile_region(f"ingest[single b={valid.shape[0]}]"):
                self._state = ingest_batch_donated(
                    self._state, pts_norm, cats_arr, valid, self.spec,
                    self.caps, self.k, self.tau, base_index=self.n_offered,
                    block_size=self.block_size, **self._scan_kw(),
                )
            self.n_offered += n
            rep = self._report(n, t0)
            self._wal_commit(seq)
            return rep

    def _wal_begin(
        self, points: np.ndarray, cats: Optional[np.ndarray]
    ) -> Optional[int]:
        """Assign a submission ordinal and write-ahead log one externally
        originated synchronous batch (under ``_cv``). Returns ``None`` for
        non-durable runtimes and for internal applications (the async
        worker's, logged at submit time, and restore's replay); raises
        ``WalError`` (batch NOT applied, seq burned) if the append fails.
        """
        if self._wal is None or self._replaying:
            return None
        if (
            self._worker is not None
            and threading.current_thread() is self._worker
        ):
            return None
        pts = np.asarray(points, np.float32)
        if pts.shape[0] == 0:
            return None  # warmup no-op batches don't advance the stream
        if self._pending > 0:
            # a sync ingest between in-flight async batches would apply
            # out of submission order: the WAL could no longer replay to
            # the same stream
            raise RuntimeError(
                "durable runtime: synchronous ingest while async batches "
                "are pending would break WAL replay order; flush() first "
                "or submit() this batch"
            )
        seq = self._next_seq
        self._next_seq += 1
        self._wal.append(seq, pts, cats)
        return seq

    def _wal_commit(self, seq: Optional[int]) -> None:
        """Mark one ``_wal_begin``-logged batch as applied (under
        ``_cv``) and checkpoint if the cadence says so."""
        if seq is None:
            return
        self._applied_seq = seq
        self.checkpoint(force=False)

    def ingest_sharded(
        self,
        points: np.ndarray,
        cats: Optional[np.ndarray] = None,
        *,
        pad_to: Optional[int] = None,
    ) -> IngestReport:
        """Deal one batch round-robin, row by row, across the
        ``num_shards`` states of the stacked drive and ingest every shard
        (``vmap``: the lanes in turn; ``shard_map``: in groups over the
        cards, one group on one card). Each shard sees its own
        sub-stream; by §3 the union of their coresets (the epoch
        snapshot) is a coreset of the whole stream. Rows keep their
        global stream indices. Bypasses the write-ahead log (``ingest``
        logs)."""
        return self._ingest_sharded(points, cats, pad_to, log=False)

    def _ingest_sharded(self, points, cats, pad_to, *, log: bool):
        if self.num_shards < 2:
            raise ValueError("ingest_sharded needs num_shards >= 2")
        if self.placement == "pipeline":
            raise ValueError(
                "ingest_sharded is the row-granular drive; this service "
                "resolved placement='pipeline' (batch-granular) -- use "
                "ingest()/ingest_pipeline, or pass placement='vmap' or "
                "'shard_map'"
            )
        with self._cv:
            t0 = time.perf_counter()
            pts = np.asarray(points, np.float32)
            n, d = pts.shape
            cats_arr = self._check_cats(n, cats)
            S = self.num_shards
            # the whole batch is checked before it is logged, and logged
            # before any shard is applied
            x = self._to_device(pts)
            seq = self._wal_begin(points, cats) if log else None
            if self._state is None:
                self._init_state(d)
            pts_norm = geometry.normalize_for_metric(x, self.metric)
            # per-shard sub-batch length, bucketed like the reference's;
            # the per-shard block never exceeds it
            mm0 = -(-max(n, pad_to or 0) // S)
            sb = min(self.block_size, _bucket_pow2(mm0))
            mm = mm0 + (-mm0 % sb)
            Pb = torch.zeros((S, mm, d), dtype=torch.float32,
                             device=self.device)
            Cb = np.full((S, mm, self._gamma_width), -1, np.int32)
            Vb = np.zeros((S, mm), bool)
            Sb = np.full((S, mm), -1, np.int32)
            for s in range(S):
                rows = np.arange(s, n, S)
                r = rows.shape[0]
                Pb[s, :r] = pts_norm[s::S]
                Cb[s, :r] = cats_arr[rows]
                Vb[s, :r] = True
                Sb[s, :r] = self.n_offered + rows
            ingest = (ingest_batch_sharded_donated
                      if self.placement == "vmap"
                      else functools.partial(ingest_batch_sharded_mapped,
                                             donate=True,
                                             devices=self._devices()))
            with obs.compile_region(
                    f"ingest[{self.placement} s={S} b={mm}]"):
                self._state = ingest(
                    self._state, Pb, Cb, Vb, Sb, self.spec, self.caps,
                    self.k, self.tau, block_size=sb, **self._scan_kw(),
                )
            self.n_offered += n
            rep = self._report(n, t0)
            self._wal_commit(seq)
            return rep

    def ingest_pipeline(
        self,
        points: np.ndarray,
        cats: Optional[np.ndarray] = None,
        *,
        pad_to: Optional[int] = None,
    ) -> IngestReport:
        """Route one whole batch to the next shard (batch-granular
        round-robin) and resume that shard's plain blocked scan: still a
        partition of the stream, so §3 holds; each ingest is the unsharded
        path's scan. Bypasses the write-ahead log (``ingest`` logs)."""
        return self._ingest_pipeline(points, cats, pad_to, log=False)

    def _ingest_pipeline(self, points, cats, pad_to, *, log: bool):
        if self.num_shards < 2:
            raise ValueError("ingest_pipeline needs num_shards >= 2")
        with self._cv:
            t0 = time.perf_counter()
            n, d, pts_norm, cats_arr, valid = self._padded(points, cats,
                                                           pad_to)
            seq = self._wal_begin(points, cats) if log else None
            if self._state is None:
                self._init_state(d)
            i = self._rr % self.num_shards
            if n > 0:  # empty (warmup) batches don't consume a shard slot
                self._rr += 1
            if self._fp_cache is not None:
                self._fp_cache[i] = None  # this shard's pull is now stale
            with obs.compile_region(f"ingest[pipeline b={valid.shape[0]}]"):
                self._state[i] = ingest_batch_donated(
                    self._state[i], pts_norm, cats_arr, valid, self.spec,
                    self.caps, self.k, self.tau, base_index=self.n_offered,
                    block_size=self.block_size, **self._scan_kw(),
                )
            self.n_offered += n
            rep = self._report(n, t0)
            self._wal_commit(seq)
            return rep

    def _report(self, n: int, t0: float) -> IngestReport:
        fp, size = self._fingerprint_and_size()
        changed = fp != self._fingerprint
        self._fingerprint = fp
        self._coreset_size = size
        self._fp_history.append((self.n_offered, fp))
        self._dirty = True
        self._unpublished += 1
        self._m_ingest_s.observe(time.perf_counter() - t0)
        self._m_ingest_points.inc(n)
        self._m_ingest_batches.inc()
        return IngestReport(
            n=n,
            total=self.n_offered,
            coreset_size=size,
            coreset_changed=changed,
            ingest_s=time.perf_counter() - t0,
        )

    def _fingerprint_and_size(self) -> tuple[int, int]:
        """Coreset fingerprint through the device reduction
        (``epoch_fingerprint``: three scalars copied a call). For the
        pipeline drive only the shard the last ingest touched is reduced
        again."""
        if isinstance(self._state, list):
            if self._fp_cache is None:
                self._fp_cache = [None] * len(self._state)
            for j, st in enumerate(self._state):
                if self._fp_cache[j] is None:
                    self._fp_cache[j] = epoch_fingerprint(st)
            # the union is determined by the shard-major sequence of shard
            # coresets: the hash of the per-shard hashes is a content key
            return (
                hash(tuple(fp for fp, _sz in self._fp_cache)),
                int(sum(sz for _fp, sz in self._fp_cache)),
            )
        return epoch_fingerprint(self._state)

    # ------------------------------------------------------------------
    # epoch publication
    # ------------------------------------------------------------------

    @property
    def pending(self) -> int:
        """Submitted batches not yet ingested by the worker."""
        with self._cv:
            return self._pending

    def latest(self) -> Optional[EpochSnapshot]:
        """Newest published epoch (``None`` before the first publish)."""
        return self._published

    def refresh(self, *, force: bool = False) -> EpochSnapshot:
        """Publish the current state as a new epoch if anything was
        ingested since the last publish; otherwise return the published
        epoch unchanged. Materializes the coreset (device -> host) only
        when the fingerprint moved; ``force`` advances the epoch over an
        unchanged coreset, reusing the previous buffers (``flush``)."""
        t0 = time.perf_counter()
        with self._cv:
            if self._state is None:
                raise RuntimeError("ingest at least one batch first")
            pub = self._published
            changed = pub is None or pub.fingerprint != self._fingerprint
            if not self._dirty and not changed:
                return pub
            if not changed and not force:
                return pub
            now = self._clock()
            with obs.span(
                "publish", cat="ingest",
                force=force, materialize=changed,
            ):
                if changed:
                    pts, cats, src = compact_coreset(
                        snapshot_at_epoch(self._state)
                    )
                    self.snapshot_materializations += 1
                    self._m_materializations.inc()
                else:  # forced epoch bump over an unchanged coreset
                    pts, cats, src = pub.points, pub.cats, pub.src_idx
            snap = EpochSnapshot(
                epoch=(pub.epoch if pub else 0) + 1,
                fingerprint=self._fingerprint,
                points=pts,
                cats=cats,
                src_idx=src,
                n_offered=self.n_offered,
                published_at=now,
            )
            self._published = snap
            self._dirty = False
            self._unpublished = 0
            self.epochs_published += 1
            self._m_epochs.inc()
            self._m_publish_s.observe(time.perf_counter() - t0)
            # every worker-ingested batch awaiting an epoch is covered by
            # this publish: staleness = publish time - submit time
            t_pub = self._clock()
            for t_submit in self._stale_pending:
                self._m_staleness_s.observe(t_pub - t_submit)
            self._stale_pending.clear()
            self._cv.notify_all()
        if self.on_publish is not None:
            try:
                self.on_publish(snap)
            except Exception:
                # a subscriber's bug must not kill the ingest worker (or a
                # synchronous refresh caller): count it, log it, move on
                self._m_callback_errors.inc()
                _log.exception(
                    "on_publish callback raised for epoch %d", snap.epoch
                )
        return snap

    def acquire(
        self,
        min_epoch: Optional[int] = None,
        *,
        timeout: Optional[float] = 60.0,
    ) -> EpochSnapshot:
        """Snapshot for a reader: stale-but-consistent while ingestion is
        in flight (lock-free: a query never queues behind the worker's
        scan), freshest-available when idle (publishing pending
        synchronous ingests first). ``min_epoch`` blocks until an epoch
        >= it is published; if nothing in flight can satisfy it, raises
        ``ValueError`` (``TimeoutError`` after ``timeout`` seconds)."""
        self._raise_worker_error()
        snap = self._published  # single-reference read: atomic
        if (
            snap is not None
            and self._pending > 0
            and (min_epoch is None or snap.epoch >= min_epoch)
        ):
            return snap
        with self._cv:
            self._raise_worker_error()
            if self._pending == 0:
                snap = self.refresh()
            else:
                snap = self._published
                if snap is None:
                    # first batches still in flight: wait for epoch 1
                    self._wait_for(1, timeout)
                    snap = self._published
            if min_epoch is not None and snap.epoch < min_epoch:
                self._wait_for(min_epoch, timeout)
                snap = self._published
            return snap

    def _wait_for(self, min_epoch: int, timeout: Optional[float]) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._published is None or self._published.epoch < min_epoch:
            self._raise_worker_error()
            if self._pending == 0:
                # nothing in flight can advance the epoch: force at most
                # one publish, then the request is provably unsatisfiable
                snap = self.refresh(force=True)
                if snap.epoch >= min_epoch:
                    return
                raise ValueError(
                    f"min_epoch {min_epoch} is ahead of the newest epoch "
                    f"{snap.epoch} and no ingestion is in flight"
                )
            remaining = (
                None if deadline is None else deadline - time.monotonic()
            )
            if remaining is not None and remaining <= 0:
                raise TimeoutError(
                    f"epoch {min_epoch} not published within timeout"
                )
            self._cv.wait(remaining)

    # ------------------------------------------------------------------
    # async ingestion
    # ------------------------------------------------------------------

    def submit(
        self, points: np.ndarray, cats: Optional[np.ndarray] = None
    ) -> int:
        """Enqueue one batch for background ingestion and return without
        waiting for the scan. Batches are ingested strictly in submission
        order (one worker), so every published epoch equals the same
        sequence of synchronous ``ingest`` calls. Blocks only when
        ``max_pending`` batches are queued. Worker errors surface on the
        next ``submit``/``flush``.

        On a durable runtime the batch is appended to the write-ahead log
        *before* it is enqueued: once ``submit`` returns, the batch
        survives a process death (``restore`` replays it). A failed
        append raises ``WalError`` here, in the submitter: the batch was
        neither persisted nor enqueued. Non-finite points raise
        ``ValueError`` before the append (checked on the host, so the
        submitter gets the error), so the log never holds poison.

        Returns the WAL seq assigned to the batch (-1 on a non-durable
        runtime); ``ReplicaSet`` ships that seq to standbys.
        """
        pts = np.asarray(points, np.float32)
        self._check_finite(pts)
        with obs.trace() as tid, obs.span(
            "submit", cat="ingest", n=int(pts.shape[0])
        ):
            with self._cv:
                self._raise_worker_error()
                if self._closed:
                    raise RuntimeError("runtime is closed")
                seq = -1
                if self._wal is not None:
                    # log-then-enqueue: a WalError reaches the caller with
                    # the batch not enqueued (the burned seq leaves a
                    # harmless gap in the log)
                    seq = self._next_seq
                    self._next_seq += 1
                    self._wal.append(seq, pts, cats)
                self._ensure_worker()
                self._pending += 1
                self._m_submitted.inc()
            # queue items carry the submit time (the staleness clock) and
            # the submitter's trace ID (the worker resumes it)
            self._queue.put((pts, cats, seq, self._clock(), tid))
            self._m_queue_depth.set(self._queue.qsize())
        return seq

    def _ensure_worker(self) -> None:
        """Start (or respawn) the ingest worker. Caller holds ``_cv``."""
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_main,
                name="stream-runtime-ingest",
                daemon=True,
            )
            self._worker.start()

    def _drop_pending_item(self, reason: str) -> None:
        """Account one submitted batch that will never be ingested
        (``truncated`` or ``close``); drops are not worker errors."""
        self.registry.counter(
            "serve.worker.dropped_batches", reason=reason
        ).inc()
        with self._cv:
            self._pending -= 1
            self._cv.notify_all()

    def _worker_main(self) -> None:
        """Worker thread entry: the ingest loop under a supervisor. A
        loop-fatal error (e.g. ``InjectedCrash``) kills this thread; the
        supervisor starts a replacement (at most
        ``fault_policy.max_worker_restarts``) that first re-applies the
        in-flight batch, so submission order holds."""
        try:
            self._worker_loop()
        except BaseException as e:  # noqa: BLE001 -- supervisor boundary
            self._m_worker_crashes.inc()
            _log.warning(
                "ingest worker crashed (%s: %s)", type(e).__name__, e
            )
            with self._cv:
                policy = self.fault_policy
                if (
                    self._closed
                    or self._worker_restarts >= policy.max_worker_restarts
                ):
                    if self._worker_err is None:
                        self._m_worker_errors.inc()
                        self._worker_err = e
                    self._cv.notify_all()
                    return
                self._worker_restarts += 1
                self._m_worker_restarts.inc()
                self._worker = threading.Thread(
                    target=self._worker_main,
                    name="stream-runtime-ingest",
                    daemon=True,
                )
                self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            if self._inflight is not None:
                # a restarted worker re-applies its predecessor's batch
                item = self._inflight
            else:
                item = self._queue.get()
                if item is _STOP:
                    self._drain_after_stop()
                    return
                self._inflight = item
            pts, cats, seq, t_submit, tid = item
            self._m_queue_depth.set(self._queue.qsize())
            if self._force_stop:
                # forced close: the error is recorded BEFORE the pending
                # count moves, so a racing flush() never sees a clean drain
                # (on a durable runtime the batches are in the WAL and
                # restore replays them)
                with self._cv:
                    if self._worker_err is None:
                        self._worker_err = RuntimeError(
                            "close(drain=False) dropped queued batch(es) "
                            "without ingesting them (see serve.worker."
                            "dropped_batches{reason=close})"
                        )
                self._inflight = None
                self._drop_pending_item("close")
                continue
            if self.faults is not None:
                # loop-fatal injection site: _inflight holds the batch, so
                # the supervised restart replays it in order
                self.faults.check("worker.loop")
            if self._worker_err is not None:
                # after a stream-truncating failure later batches are
                # dropped, not ingested out of order
                self._inflight = None
                self._drop_pending_item("truncated")
                continue
            with obs.resume_trace(tid):
                ok = self._ingest_with_retry(pts, cats, seq)
                self._inflight = None
                if not ok:
                    continue
                with self._cv:
                    self._pending -= 1
                    drained = self._pending == 0
                    overdue = self._unpublished >= self.publish_every
                    self._stale_pending.append(t_submit)
                    self._cv.notify_all()
                if drained or overdue:
                    # the epoch materialization runs here, in the worker,
                    # never in a query thread
                    try:
                        self.refresh(force=drained)
                    except BaseException as e:  # noqa: BLE001
                        with self._cv:
                            if self._worker_err is None:
                                self._m_worker_errors.inc()
                                self._worker_err = e
                            self._cv.notify_all()
                self.checkpoint(force=False)

    def _drain_after_stop(self) -> None:
        """Account batches racing ``close``: they will never be ingested;
        unblock waiters and leave a truthful error."""
        while True:
            try:
                nxt = self._queue.get(timeout=0.1)
            except queue.Empty:
                return
            if nxt is not _STOP:
                with self._cv:
                    if self._worker_err is None:
                        self._worker_err = RuntimeError(
                            "close() dropped queued batch(es) without "
                            "ingesting them (see serve.worker."
                            "dropped_batches{reason=close})"
                        )
                self._drop_pending_item("close")

    def _ingest_with_retry(
        self, pts: np.ndarray, cats: Optional[np.ndarray], seq: int
    ) -> bool:
        """Apply one dequeued batch under the fault policy: retry with
        capped exponential backoff, then truncate the stream (default) or
        quarantine the batch to ``poison`` and go on. Returns True iff the
        batch was ingested; ``serve.worker.errors`` counts each failed
        batch once."""
        policy = self.fault_policy
        attempt = 0
        while True:
            try:
                if self.faults is not None:
                    self.faults.check("worker.ingest")
                with obs.span(
                    "worker_ingest", cat="ingest", n=int(pts.shape[0]),
                    attempt=attempt,
                ):
                    self.ingest(pts, cats)
                if seq >= 0:
                    with self._cv:
                        self._applied_seq = seq
                return True
            except InjectedCrash:
                raise  # loop-fatal by contract: the supervisor's problem
            except Exception as e:  # noqa: BLE001 -- policy boundary
                if attempt < policy.max_retries:
                    self._m_worker_retries.inc()
                    time.sleep(policy.backoff(attempt))
                    attempt += 1
                    continue
                self._m_worker_errors.inc()
                if policy.on_failure == "quarantine":
                    self._m_worker_poisoned.inc()
                    _log.warning(
                        "quarantining batch seq=%d after %d attempt(s): "
                        "%s: %s -- stream continues",
                        seq, attempt + 1, type(e).__name__, e,
                    )
                    with self._cv:
                        self.poison.append(PoisonedBatch(
                            seq=seq, points=pts, cats=cats,
                            attempts=attempt + 1, error=e,
                        ))
                        if seq >= 0:
                            # the seq is consumed: a restored stream must
                            # skip it on replay to match this live one
                            self._poisoned_seqs.append(seq)
                            self._applied_seq = seq
                        self._pending -= 1
                        self._cv.notify_all()
                else:
                    with self._cv:
                        if self._worker_err is None:
                            self._worker_err = e
                        self._pending -= 1
                        self._cv.notify_all()
                return False

    def _raise_worker_error(self) -> None:
        if self._worker_err is not None:
            err = self._worker_err
            raise RuntimeError(
                "async ingest worker failed; no further batches were "
                "ingested"
            ) from err

    def flush(self, *, timeout: Optional[float] = 120.0) -> int:
        """Freshness barrier: wait until every batch submitted so far is
        ingested, force-publish, and return the epoch number, which covers
        all of them (pass it as ``min_epoch`` to read your own writes)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._pending > 0:
                self._raise_worker_error()
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError("flush timed out with batches pending")
                self._cv.wait(remaining)
            self._raise_worker_error()
            return self.refresh(force=True).epoch

    # ------------------------------------------------------------------
    # durability: checkpoint + restore
    # ------------------------------------------------------------------

    def _config_dict(self) -> dict:
        """JSON-serializable constructor config (everything but the host
        oracle, the callbacks and the device, which ``restore`` takes as
        arguments): the reference's keys and values."""
        return dict(
            spec=dict(
                kind=self.spec.kind,
                num_categories=self.spec.num_categories,
                gamma=self.spec.gamma,
            ),
            k=self.k,
            tau=self.tau,
            metric=str(self.metric),
            caps=None if self.caps is None else [int(c) for c in self.caps],
            slot_cap=self.slot_cap,
            variant=self.stream_variant,
            eps=self.eps,
            c_const=self.c_const,
            num_shards=self.num_shards,
            block_size=self.block_size,
            placement=self.placement,
            publish_every=self.publish_every,
            max_pending=int(self._queue.maxsize),
        )

    def _ckpt_meta(self) -> dict:
        return dict(
            version=1,
            kind=(
                "list" if isinstance(self._state, list)
                else "stacked" if self.num_shards > 1
                else "single"
            ),
            wal_seq=self._applied_seq,
            next_seq=self._next_seq,
            n_offered=self.n_offered,
            rr=self._rr,
            epoch=self.epochs_published,
            fingerprint=self._fingerprint,
            poisoned_seqs=list(self._poisoned_seqs),
            config=self._config_dict(),
        )

    def checkpoint(self, *, force: bool = True) -> Optional[str]:
        """Persist the scan state to the durability dir; returns the
        checkpoint path, or ``None`` when skipped (no durability
        configured, nothing ingested yet, or -- with ``force=False``, the
        worker's cadence call -- fewer than ``checkpoint_every`` batches
        applied since the last one).

        The state is copied to the host under the lock (the next ingest
        updates the live tensors in place) and written outside it. A
        failed save (an injected ``checkpoint.write`` fault included) is
        counted in ``serve.ckpt.failures`` and logged; serving continues
        and the previous checkpoint stays intact (write-temp-then-rename).
        After a successful save, checkpoints beyond ``keep`` are pruned
        and the WAL is compacted to the oldest retained checkpoint's
        watermark.
        """
        dur = self.durability
        if dur is None:
            return None
        with self._cv:
            if self._state is None:
                return None
            if (
                not force
                and self._applied_seq - self._last_ckpt_seq
                < dur.checkpoint_every
            ):
                return None
            host_state = host_copy(self._state)
            meta = self._ckpt_meta()
            path = checkpoint_path(
                dur.dir, self.n_offered, self._fingerprint
            )
            wal_seq = self._applied_seq
        try:
            save_checkpoint(
                path, host_state, meta,
                faults=self.faults, fsync=dur.fsync,
            )
        except Exception as e:  # noqa: BLE001 -- counted, serving continues
            self._m_ckpt_failures.inc()
            _log.warning(
                "checkpoint save failed (%s: %s); serving continues on "
                "the previous checkpoint + WAL",
                type(e).__name__, e,
            )
            return None
        with self._cv:
            self._last_ckpt_seq = max(self._last_ckpt_seq, wal_seq)
        self._m_ckpt_saved.inc()
        self._m_ckpt_last_seq.set(wal_seq)
        floor = prune_checkpoints(dur.dir, dur.keep)
        if self._wal is not None and floor >= 0:
            try:
                self._wal.compact(floor)
            except Exception as e:  # noqa: BLE001 -- counted; the
                # superset log replays correctly, compaction retries on
                # the next checkpoint
                self.registry.counter("serve.wal.compact_errors").inc()
                _log.warning(
                    "WAL compaction failed (%s: %s); serving continues "
                    "on the uncompacted log", type(e).__name__, e,
                )
        return path

    def _install(self, state, meta: dict) -> None:
        """Put a loaded checkpoint's state on this runtime's device and
        take its stream position (under ``_cv``). A ``pipeline`` list is
        dealt round robin over the devices, as ``_init_state`` deals it;
        a single or stacked state goes onto the runtime's device."""
        if isinstance(state, list):
            devs = self._devices()
            self._state = [place_state(st, devs[i % len(devs)])
                           for i, st in enumerate(state)]
        else:
            self._state = place_state(state, self.device)
        self._fp_cache = None
        self.n_offered = int(meta["n_offered"])
        self._rr = int(meta.get("rr", 0))
        self._next_seq = int(meta["next_seq"])
        self._applied_seq = int(meta["wal_seq"])
        self._poisoned_seqs = [int(s) for s in meta.get("poisoned_seqs", ())]
        self._fingerprint, self._coreset_size = self._fingerprint_and_size()
        self._fp_history.append((self.n_offered, self._fingerprint))
        self._dirty = True

    @classmethod
    def restore(
        cls,
        durability: Union[DurabilityConfig, str],
        *,
        spec: Optional[MatroidSpec] = None,
        oracle=None,
        on_publish: Optional[Callable[[EpochSnapshot], None]] = None,
        registry: Optional[obs.MetricsRegistry] = None,
        fault_policy: Optional[FaultPolicy] = None,
        faults: Optional[FaultPlan] = None,
        device: DeviceLike = CUDA,
        **overrides,
    ) -> "StreamRuntime":
        """Rebuild a runtime on ``device`` from its durability dir: load
        the newest valid checkpoint, then replay the WAL tail in
        submission order through ``ingest`` (K3 on the card). The
        restored stream is bit-identical to the one that died (§3: the
        state is a pure fold over the batch sequence, and the scan is
        deterministic given the same config). The directory may be the
        reference package's: the formats are the same.

        The constructor config is read from the checkpoint; ``spec`` and
        keyword ``overrides`` (``k=``, ``tau=``, ...) take precedence and
        are *required* when no checkpoint exists yet (WAL-only restore).
        Host oracles and callbacks are not serializable: pass them
        again. Batches quarantined before the checkpoint are skipped on
        replay; quarantined batches *newer* than the checkpoint are
        re-attempted (at-least-once, in order).

        The outcome is in ``runtime.restore_report`` (checkpoint path,
        replayed batches/points, wall time, recovered epoch fingerprint).
        """
        dur = (
            DurabilityConfig(dir=durability)
            if isinstance(durability, str) else durability
        )
        t0 = time.perf_counter()
        path = latest_checkpoint(dur.dir)
        state = None
        meta: Optional[dict] = None
        cfg: dict = {}
        if path is not None:
            state, meta = load_checkpoint(path)
            cfg = dict(meta["config"])
        if spec is None:
            if "spec" not in cfg:
                raise ValueError(
                    "no checkpoint to read the config from: WAL-only "
                    "restore needs spec= plus k=/tau=/... overrides"
                )
            spec = MatroidSpec(**cfg["spec"])
        kw = dict(
            k=cfg.get("k"),
            tau=cfg.get("tau"),
            metric=cfg.get("metric", "euclidean"),
            caps=cfg.get("caps"),
            slot_cap=cfg.get("slot_cap"),
            variant=cfg.get("variant", "radius"),
            eps=cfg.get("eps", 0.5),
            c_const=cfg.get("c_const", 32),
            num_shards=cfg.get("num_shards", 1),
            block_size=cfg.get("block_size", 128),
            placement=cfg.get("placement", "auto"),
            publish_every=cfg.get("publish_every", 8),
            max_pending=cfg.get("max_pending", 64),
        )
        kw.update(overrides)
        k = kw.pop("k")
        if k is None or kw["tau"] is None:
            raise ValueError(
                "no checkpoint to read the config from: WAL-only restore "
                "needs k= and tau= overrides"
            )
        caps = kw.pop("caps")
        rt = cls(
            spec, int(k),
            caps=None if caps is None else np.asarray(caps, np.int32),
            oracle=oracle, on_publish=on_publish, registry=registry,
            durability=dur, fault_policy=fault_policy, faults=faults,
            device=device, **kw,
        )
        if meta is not None:
            with rt._cv:
                rt._install(state, meta)
                rt.epochs_published = int(meta.get("epoch", 0))
                rt._last_ckpt_seq = rt._applied_seq
        # replay the WAL tail: records newer than the checkpoint's
        # watermark, in file order == submission order
        replayed = 0
        replayed_points = 0
        skipped = 0
        poisoned = set(rt._poisoned_seqs)
        rt._replaying = True
        try:
            for rec in rt._wal.replay(after_seq=rt._applied_seq):
                with rt._cv:
                    rt._next_seq = max(rt._next_seq, rec.seq + 1)
                    rt._applied_seq = rec.seq
                if rec.seq in poisoned:
                    skipped += 1
                    continue
                try:
                    rt.ingest(rec.points, rec.cats)
                except Exception as e:  # noqa: BLE001 -- skip + count
                    rt.registry.counter("serve.wal.replay_errors").inc()
                    _log.warning(
                        "WAL replay of seq %d failed (%s: %s); skipped",
                        rec.seq, type(e).__name__, e,
                    )
                    continue
                replayed += 1
                replayed_points += int(rec.points.shape[0])
        finally:
            rt._replaying = False
        snap = rt.refresh(force=True) if rt._state is not None else None
        rt.restore_report = dict(
            checkpoint=path,
            replayed_batches=replayed,
            replayed_points=replayed_points,
            skipped_poisoned=skipped,
            restore_s=time.perf_counter() - t0,
            epoch=0 if snap is None else snap.epoch,
            fingerprint=None if snap is None else snap.fingerprint,
            n_offered=rt.n_offered,
        )
        return rt

    def close(
        self, *, drain: bool = True, timeout: Optional[float] = 30.0
    ) -> None:
        """Stop the async worker (idempotent).

        ``drain=True`` first waits, up to ``timeout`` seconds, for every
        submitted batch to be ingested; on expiry it raises
        ``TimeoutError`` without closing. ``drain=False`` stops at once:
        queued batches are dropped, counted in
        ``serve.worker.dropped_batches{reason=close}`` and surfaced as a
        worker error to a later ``flush``/``acquire`` (on a durable
        runtime they are in the WAL and come back on ``restore``). A
        durable runtime then saves a parting checkpoint, so it restores
        from the checkpoint alone. Synchronous ingestion and published
        epochs stay usable after close; further ``submit`` calls raise
        ``RuntimeError``.
        """
        if drain:
            deadline = (
                None if timeout is None else time.monotonic() + timeout
            )
            with self._cv:
                while (
                    not self._closed
                    and self._pending > 0
                    and self._worker_err is None
                ):
                    remaining = (
                        None if deadline is None
                        else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"close(drain=True) timed out with "
                            f"{self._pending} batch(es) pending; retry, "
                            f"or force-drop with close(drain=False)"
                        )
                    self._cv.wait(remaining)
        with self._cv:
            if self._closed:
                return
            self._closed = True
            if not drain:
                self._force_stop = True
            worker = self._worker
        if worker is not None:
            self._queue.put(_STOP)
            worker.join(timeout=60.0)
        if (
            self.durability is not None
            and self._applied_seq > self._last_ckpt_seq
        ):
            # parting save: a cleanly closed durable runtime restores
            # from its checkpoint alone, no config overrides needed
            self.checkpoint(force=True)
        if self._wal is not None:
            self._wal.close()

    def __enter__(self) -> "StreamRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
