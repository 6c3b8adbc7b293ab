"""Parallel micro-batch coalescing for the query frontend.

Reference: ``repro/serve/diversity/coalesce.py`` (the standard library
only; the port keeps its own copy). At high concurrency, every
``query_batch`` call pays registry dispatch, epoch acquire, cache fetch,
and a device launch *per call*. The coalescer amortizes them: concurrent
calls from any number of threads and tenants land in bounded-window
queues, a small dispatcher pool drains them into groups, and each group
executes as merged pow-2-bucketed batched solves -- stacked ACROSS
tenants into one call when the engine supports it
(``core/solvers/stacked.py``) -- fanning results back to each blocked
caller, the same answers the caller would have computed alone.

Topology:

* **sharded assembly** — calls hash by tenant name onto one of
  ``CoalesceConfig.dispatchers`` shards (default ``min(4, cpu)``), each
  with its own queue + window-assembly thread. Same tenant, same shard:
  per-tenant FIFO holds by construction through assembly.
* **shared dispatch stage** — assembled windows split into
  ``(tenant, engine, min_epoch)`` sub-groups and land in one shared
  ready deque. Any dispatcher thread grabs every ready sub whose tenant
  is not currently executing (a busy set — so two windows of one tenant
  can never reorder or run concurrently) and executes the grab as one
  wave: subs agreeing on ``(engine, min_epoch)`` become a single
  cross-tenant stacked solve. Work conservation: a grab that comes back
  empty only leaves subs whose tenants are busy, and every busy-holder
  re-grabs after it releases — nothing strands.
* **adaptive window** — the fixed 300 µs window became a Little's-law
  controller (``AdaptiveWindow``): the target in-window delay is the
  cost model's estimate for the solve the window is building (waiting
  about one solve-time doubles the batch for at worst ~2x latency —
  the classic batching sweet spot), *widened* when backlog shows
  arrivals outrunning service (``L = λW``: a standing queue means W is
  too small for the observed λ) and *collapsed to zero* when the
  observed arrival rate λ could not deliver a single companion even at
  the widest window (``λ · window_max_s < 1``) — an idle or lightly
  loaded frontend dispatches immediately instead of idling 300 µs.
  ``window_min_s``/``window_max_s`` clamp the controller; a deadline
  caller's cap (``deadline_window_frac`` of its budget) still bounds
  its group's wait — the window can shave a deadline, never blow it.

Groups cap at ``max_calls`` callers / ``max_queries`` queries, and a
window still closes early the moment every in-flight caller is already
parked somewhere in the pool (nobody new can be en route). A solo
caller never enters the queue at all: the frontend bypasses the
coalescer entirely when it is the only active caller.

Observability: the aggregate ``serve.coalesce.*`` series
(queue_wait_s / group_calls / group_queries histograms, queue_depth
gauge, coalesced/groups counters), joined by per-dispatcher
``serve.coalesce.{groups,calls,queue_depth}{dispatcher=dN}``, a
pool-wide ``serve.coalesce.backlog`` gauge, the live
``serve.coalesce.window_s`` gauge, and the stacked-solve counters the
frontend emits (``serve.coalesce.stacked_{solves,rows}``,
``stacked_tenants`` histogram). ``stats()`` aggregates across the pool
and embeds the controller's window-size-over-time trace.
"""
from __future__ import annotations

import dataclasses
import math
import os
import threading
import time
import zlib
from collections import deque
from typing import Optional, Sequence


def _default_dispatchers() -> int:
    return max(1, min(4, os.cpu_count() or 1))


@dataclasses.dataclass(frozen=True)
class CoalesceConfig:
    """Tuning knobs for the micro-batch window (see module docstring).

    ``window_s`` is the fixed window when ``adaptive=False`` and the
    controller's cold-start solve estimate before the cost model has fed
    it anything. ``dispatchers=0`` sizes the pool to ``min(4, cpu)``.
    """

    window_s: float = 300e-6
    max_calls: int = 64
    max_queries: int = 512
    # fraction of a deadline caller's remaining budget it may spend
    # waiting in the window (the rest is reserved for the solve itself)
    deadline_window_frac: float = 0.25
    enabled: bool = True
    dispatchers: int = 0  # 0 -> min(4, cpu)
    adaptive: bool = True
    window_min_s: float = 50e-6
    window_max_s: float = 2e-3

    def pool_size(self) -> int:
        return (
            int(self.dispatchers)
            if self.dispatchers and self.dispatchers > 0
            else _default_dispatchers()
        )


class PendingCall:
    """One caller parked in the window (internal).

    ``dispatch_by`` is the caller's absolute deadline-derived cap on
    in-window waiting (``+inf`` without a deadline); the window's own
    open duration is the assembling dispatcher's business (adaptive).
    """

    __slots__ = (
        "tenant", "queries", "engine", "min_epoch", "deadline",
        "enq_t", "dispatch_by", "done", "results", "error",
        "specs", "degraded", "from_cache",
    )

    def __init__(self, tenant, queries, *, engine, min_epoch, deadline,
                 enq_t, dispatch_by):
        self.tenant = tenant
        self.queries = queries
        self.engine = engine
        self.min_epoch = min_epoch
        self.deadline = deadline  # absolute perf_counter or None
        self.enq_t = enq_t
        self.dispatch_by = dispatch_by
        self.done = threading.Event()
        self.results = None
        self.error: Optional[BaseException] = None
        self.specs = None
        self.degraded = None
        self.from_cache = False


class AdaptiveWindow:
    """Little's-law window controller.

    State: an EMA of the call inter-arrival time (λ = 1/IAT, decayed by
    silence: the effective IAT is never shorter than the time since the
    last arrival) and an EMA of the cost model's solve estimates for
    dispatched groups (fed by the frontend at each merged launch).

    ``current(backlog)`` returns the window the assembling dispatcher
    should hold open right now:

    * idle collapse — if ``λ · window_max_s < 1``, even the widest
      legal window would not catch one companion call: return 0 and
      dispatch immediately;
    * target — ``W* = clamp(S, window_min_s, window_max_s)`` where S is
      the solve-estimate EMA: waiting about one solve-time doubles the
      batch at worst-equal latency;
    * queue growth — a standing backlog means arrivals outrun service
      at the current W (Little: L = λW); widen by
      ``1 + backlog / backlog_norm`` so the batch grows until service
      catches up, still clamped at ``window_max_s``.

    Every evaluation appends to a bounded (t, window) trace ring — the
    series the bench uploads so window dynamics are inspectable.
    """

    _ALPHA = 0.25  # EMA weight of one new arrival/solve observation
    _BACKLOG_NORM = 8.0  # backlog calls per +100% widening
    TRACE = 512

    def __init__(self, config: CoalesceConfig, clock=time.perf_counter):
        self.config = config
        self._clock = clock
        self._mu = threading.Lock()
        self._iat: Optional[float] = None  # EMA inter-arrival seconds
        self._last_arrival: Optional[float] = None
        self._solve_s: Optional[float] = None  # EMA solve estimate
        self._trace: deque = deque(maxlen=self.TRACE)

    def observe_arrival(self) -> None:
        now = self._clock()
        with self._mu:
            last = self._last_arrival
            if last is not None:
                dt = max(now - last, 1e-9)
                self._iat = (
                    dt if self._iat is None
                    else self._iat + self._ALPHA * (dt - self._iat)
                )
            self._last_arrival = now

    def observe_solve(self, est_s: float) -> None:
        """Feed one dispatched group's cost-model solve estimate."""
        if not (est_s >= 0.0):  # NaN/negative: refuse quietly
            return
        with self._mu:
            self._solve_s = (
                float(est_s) if self._solve_s is None
                else self._solve_s + self._ALPHA * (est_s - self._solve_s)
            )

    def rate_hz(self) -> float:
        """Current silence-decayed arrival-rate estimate."""
        now = self._clock()
        with self._mu:
            return self._rate_locked(now)

    def _rate_locked(self, now: float) -> float:
        if self._iat is None or self._last_arrival is None:
            return 0.0
        iat_eff = max(self._iat, now - self._last_arrival)
        return 1.0 / max(iat_eff, 1e-9)

    def current(self, backlog: int = 0) -> float:
        """Window seconds the assembler should hold open right now."""
        cfg = self.config
        if not cfg.adaptive:
            w = cfg.window_s
            with self._mu:
                self._trace.append((self._clock(), w))
            return w
        now = self._clock()
        with self._mu:
            lam = self._rate_locked(now)
            if lam * cfg.window_max_s < 1.0:
                w = 0.0  # idle: no companion expected, dispatch now
            else:
                s = self._solve_s if self._solve_s is not None else cfg.window_s
                target = min(max(s, cfg.window_min_s), cfg.window_max_s)
                w = target * (1.0 + max(0, backlog) / self._BACKLOG_NORM)
                w = min(w, cfg.window_max_s)
            self._trace.append((now, w))
            return w

    def snapshot(self) -> dict:
        now = self._clock()
        with self._mu:
            return {
                "adaptive": self.config.adaptive,
                "rate_hz": self._rate_locked(now),
                "interarrival_s": self._iat,
                "solve_est_s": self._solve_s,
                "window_s": self._trace[-1][1] if self._trace else 0.0,
                "trace": [[t, w] for t, w in self._trace],
            }


class _Shard:
    """One dispatcher's assembly queue (tenant-hash sharded)."""

    __slots__ = ("idx", "q", "cv", "thread")

    def __init__(self, idx: int):
        self.idx = idx
        self.q: deque[PendingCall] = deque()
        self.cv = threading.Condition()
        self.thread: Optional[threading.Thread] = None


class _DispatchStage:
    """Shared hand-off between sharded window assembly and solve
    execution. Items are ``(tenant_name, key, sub)`` in push order; a
    busy set keyed by tenant name guarantees at most one executor per
    tenant at a time, which (with FIFO ready order) preserves per-tenant
    execution order across windows while letting any free dispatcher
    stack whatever mix of tenants is ready."""

    def __init__(self):
        self._mu = threading.Lock()
        self._ready: deque = deque()
        self._busy: set = set()

    def push(self, items: Sequence[tuple]) -> None:
        with self._mu:
            self._ready.extend(items)

    def grab(self) -> tuple[list, set]:
        """Take every ready sub whose tenant is not executing, marking
        those tenants busy. Two subs of one (non-busy) tenant are taken
        together, in order — the executor merges them."""
        with self._mu:
            taken, names = [], set()
            keep: deque = deque()
            for item in self._ready:
                name = item[0]
                if name in self._busy:
                    keep.append(item)
                else:
                    taken.append(item)
                    names.add(name)
            self._ready = keep
            self._busy |= names
            return taken, names

    def release(self, names: set) -> None:
        with self._mu:
            self._busy -= names

    def depth(self) -> int:
        with self._mu:
            return len(self._ready)


class Coalescer:
    """Sharded bounded-window queues + a dispatcher pool in front of a
    frontend. Shard threads start lazily on the first call they see, so
    frontends that never see concurrency never own a thread."""

    def __init__(self, frontend, config: CoalesceConfig):
        self.frontend = frontend
        self.config = config
        reg = frontend.registry
        self._m_queue_wait = reg.histogram("serve.coalesce.queue_wait_s")
        self._m_group_calls = reg.histogram("serve.coalesce.group_calls")
        self._m_group_queries = reg.histogram(
            "serve.coalesce.group_queries"
        )
        self._m_depth = reg.gauge("serve.coalesce.queue_depth")
        self._g_backlog = reg.gauge("serve.coalesce.backlog")
        self._g_window = reg.gauge("serve.coalesce.window_s")
        self._c_coalesced = reg.counter("serve.coalesce.coalesced")
        self._c_groups = reg.counter("serve.coalesce.groups")
        n = config.pool_size()
        self._shards = [_Shard(i) for i in range(n)]
        self._sh_groups = [
            reg.counter("serve.coalesce.groups", dispatcher=f"d{i}")
            for i in range(n)
        ]
        self._sh_calls = [
            reg.counter("serve.coalesce.calls", dispatcher=f"d{i}")
            for i in range(n)
        ]
        self._sh_depth = [
            reg.gauge("serve.coalesce.queue_depth", dispatcher=f"d{i}")
            for i in range(n)
        ]
        self.window = AdaptiveWindow(config)
        self._stage = _DispatchStage()
        # calls owned by the coalescer pool-wide: from submit-enqueue
        # until just before their done event fires. The early-close
        # heuristic compares it against the frontend's active-call count.
        self._parked = 0
        self._pmu = threading.Lock()
        self._close_mu = threading.Lock()
        self._closed = False

    # ------------------------------------------------------------------
    # caller side
    # ------------------------------------------------------------------

    @property
    def backlog(self) -> int:
        """Pool-wide queued (not yet assembled) call count."""
        return sum(len(sh.q) for sh in self._shards)

    @property
    def parked(self) -> int:
        """Calls the pool currently owns (queued, staged, or solving)."""
        return self._parked

    def _shard_for(self, tenant_name: str) -> _Shard:
        # stable hash: per-tenant FIFO requires the same tenant to land
        # on the same shard in every process (hash() is salted)
        h = zlib.crc32(tenant_name.encode("utf-8", "surrogatepass"))
        return self._shards[h % len(self._shards)]

    def submit(
        self, tenant, queries: Sequence, *, engine: str,
        min_epoch: Optional[int], deadline_s: Optional[float],
    ):
        """Park the call in its tenant's shard; block until its group
        executed. Returns the call's results (same list the direct path
        returns) or re-raises whatever its group's execution raised."""
        now = time.perf_counter()
        cfg = self.config
        if deadline_s is None:
            deadline = None
            cap = math.inf
        else:
            deadline = now + deadline_s
            cap = now + max(0.0, deadline_s) * cfg.deadline_window_frac
        p = PendingCall(
            tenant, queries, engine=engine, min_epoch=min_epoch,
            deadline=deadline, enq_t=now, dispatch_by=cap,
        )
        self.window.observe_arrival()
        sh = self._shard_for(tenant.name)
        with sh.cv:
            if self._closed:
                raise RuntimeError("frontend is closed")
            sh.q.append(p)
            with self._pmu:
                self._parked += 1
            self._sh_depth[sh.idx].set(len(sh.q))
            depth = self.backlog
            self._m_depth.set(depth)
            self._g_backlog.set(depth)
            if sh.thread is None:
                sh.thread = threading.Thread(
                    target=self._loop,
                    args=(sh,),
                    name=f"repro-torch-coalesce-{sh.idx}",
                    daemon=True,
                )
                sh.thread.start()
            sh.cv.notify_all()
        p.done.wait()
        if p.error is not None:
            raise p.error
        return p.results

    def drain(self) -> list:
        """Stop the pool and hand back everything still queued on any
        shard — WITHOUT failing it. The callers stay blocked on their
        events; whoever drained (``ReplicaSet`` failover) owns
        re-dispatching each returned ``PendingCall`` on the new primary
        and setting ``results``/``error`` + ``done``. Calls a dispatcher
        already pulled into a window keep executing here and complete
        normally. After ``drain()`` the coalescer is closed: new
        submits raise."""
        with self._close_mu:
            self._closed = True
            pending: list[PendingCall] = []
            for sh in self._shards:
                with sh.cv:
                    pending.extend(sh.q)
                    sh.q.clear()
                    self._sh_depth[sh.idx].set(0)
                    sh.cv.notify_all()
            self._m_depth.set(0)
            self._g_backlog.set(0)
            self._join_threads()
            return pending

    def close(self) -> None:
        """Stop the pool; fail anything still queued on any shard (the
        callers get the RuntimeError) rather than leaving them blocked.
        Idempotent, including with dispatchers mid-solve: in-flight
        groups complete and release their callers, queued calls on
        every shard fail loudly, none hang."""
        with self._close_mu:
            self._closed = True
            pending: list[PendingCall] = []
            for sh in self._shards:
                with sh.cv:
                    pending.extend(sh.q)
                    sh.q.clear()
                    self._sh_depth[sh.idx].set(0)
                    sh.cv.notify_all()
            self._m_depth.set(0)
            self._g_backlog.set(0)
            for p in pending:
                p.error = RuntimeError(
                    "frontend closed while call was queued"
                )
                self._finish(p)
            self._join_threads()

    def _join_threads(self) -> None:
        me = threading.current_thread()
        for sh in self._shards:
            t = sh.thread
            if t is not None and t is not me:
                t.join(timeout=5.0)

    def stats(self) -> dict:
        reg = self.frontend.registry
        per = {
            f"d{sh.idx}": {
                "queue_depth": len(sh.q),
                "groups": self._sh_groups[sh.idx].value,
                "calls": self._sh_calls[sh.idx].value,
            }
            for sh in self._shards
        }
        return {
            "queue_depth": self.backlog,
            "staged": self._stage.depth(),
            "parked": self._parked,
            "dispatchers": len(self._shards),
            "per_dispatcher": per,
            "groups": self._c_groups.value,
            "coalesced_calls": self._c_coalesced.value,
            "stacked_solves": reg.counter(
                "serve.coalesce.stacked_solves"
            ).value,
            "stacked_rows": reg.counter(
                "serve.coalesce.stacked_rows"
            ).value,
            "group_calls_p95": self._m_group_calls.quantile(0.95),
            "queue_wait_p95_s": self._m_queue_wait.quantile(0.95),
            "window": self.window.snapshot(),
            "window_s": self.config.window_s,
            "adaptive": self.config.adaptive,
            "max_calls": self.config.max_calls,
            "max_queries": self.config.max_queries,
        }

    # ------------------------------------------------------------------
    # dispatcher side
    # ------------------------------------------------------------------

    def _finish(self, p: PendingCall) -> None:
        with self._pmu:
            self._parked -= 1
        p.done.set()

    def _collect(self, sh: _Shard) -> list[PendingCall]:
        """Block for the shard's next group: first waiting call +
        everything that arrives inside the adaptive window, closing
        early when every active caller is already parked pool-wide or
        the size caps hit. Deadline callers' caps bound the wait."""
        cfg = self.config
        group: list[PendingCall] = []
        n_queries = 0
        with sh.cv:
            while not sh.q and not self._closed:
                sh.cv.wait(timeout=0.1)
            if self._closed and not sh.q:
                return group
            t_open = time.perf_counter()
            while True:
                while (
                    sh.q
                    and len(group) < cfg.max_calls
                    and n_queries < cfg.max_queries
                ):
                    p = sh.q.popleft()
                    group.append(p)
                    n_queries += len(p.queries)
                self._sh_depth[sh.idx].set(len(sh.q))
                depth = self.backlog
                self._m_depth.set(depth)
                self._g_backlog.set(depth)
                if (
                    self._closed
                    or len(group) >= cfg.max_calls
                    or n_queries >= cfg.max_queries
                ):
                    break
                # parked callers (anywhere in the pool) stay "active"
                # until their results fan back, so active <= parked
                # means nobody new can be en route: close the window
                # early instead of idling it out
                if self.frontend.active_calls() <= self._parked:
                    break
                w = self.window.current(backlog=depth)
                self._g_window.set(w)
                dispatch_by = min(
                    t_open + w, min(p.dispatch_by for p in group)
                )
                now = time.perf_counter()
                if now >= dispatch_by:
                    break
                # bounded nap: re-evaluate the adaptive window as
                # arrivals/backlog move it while this group waits
                sh.cv.wait(timeout=min(dispatch_by - now, 0.05))
        return group

    def _loop(self, sh: _Shard) -> None:
        while True:
            group = self._collect(sh)
            if not group:
                if self._closed:
                    return
                continue
            now = time.perf_counter()
            for p in group:
                self._m_queue_wait.observe(now - p.enq_t)
            self._m_group_calls.observe(len(group))
            self._m_group_queries.observe(
                sum(len(p.queries) for p in group)
            )
            self._sh_calls[sh.idx].inc(len(group))
            if len(group) > 1:
                self._c_coalesced.inc(len(group))
            # executable sub-groups: only calls agreeing on
            # (tenant, engine, min_epoch) share an epoch acquire + solve
            subs: dict[tuple, list[PendingCall]] = {}
            for p in group:
                key = (p.tenant.name, p.engine, p.min_epoch)
                subs.setdefault(key, []).append(p)
            self._stage.push(
                [(key[0], key, sub) for key, sub in subs.items()]
            )
            self._drain_stage(sh)

    def _drain_stage(self, sh: _Shard) -> None:
        """Execute ready subs until a grab comes back empty. Any
        dispatcher that pushed drains; whichever one grabs a mixed set
        executes it as one stacked wave."""
        while True:
            taken, names = self._stage.grab()
            if not taken:
                return
            try:
                self._execute(sh, taken)
            finally:
                self._stage.release(names)

    def _execute(self, sh: _Shard, taken: list) -> None:
        """One execution wave: regroup grabbed subs by
        ``(engine, min_epoch)`` (re-merging multiple windows of one
        tenant, in ready order), solve each — stacked across tenants
        when >1 tenant shares the key — and release every caller."""
        waves: dict[tuple, dict[str, list[PendingCall]]] = {}
        for name, key, sub in taken:
            _tn, engine, min_epoch = key
            by_tenant = waves.setdefault((engine, min_epoch), {})
            by_tenant.setdefault(name, []).extend(sub)
        for (engine, min_epoch), by_tenant in waves.items():
            subs = list(by_tenant.values())
            self._c_groups.inc(len(subs))
            self._sh_groups[sh.idx].inc(len(subs))
            calls = [p for sub in subs for p in sub]
            try:
                if len(subs) == 1:
                    self.frontend._solve_coalesced(subs[0])
                else:
                    self.frontend._solve_coalesced_stacked(subs)
            except BaseException as e:  # noqa: BLE001 — fan the
                # failure back to every caller; the dispatcher must
                # survive any single wave's error
                for p in calls:
                    p.error = e
            finally:
                for p in calls:
                    self._finish(p)
