"""Deterministic fault-injection harness for the serving stack.

Reference: ``repro/serve/diversity/faults.py`` (numpy and threading
only; the port keeps its own copy). Every site below is instrumented in
the port as in the reference.

Chaos testing only earns its keep when a failure reproduces: a fault
plan here is a *seeded schedule*, not a random monkey. Every
instrumented site in the runtime calls ``plan.check(site)`` on each pass
through; the plan counts the hit and consults its rules — each rule owns
an independent ``numpy`` Generator seeded from ``(seed, site, rule
index)``, so whether hit #7 of ``"worker.ingest"`` fires is a pure
function of the plan's seed and that site's hit ordinal, regardless of
what any other site or thread is doing. The same seed therefore replays
the same fault schedule, which is what lets the chaos suite assert
exact post-fault state (bit-identical streams, exact retry counts).

Instrumented sites (see ``StreamRuntime``/``WriteAheadLog``/
``checkpoint``):

``worker.loop``        once per dequeued batch, *outside* the per-batch
                       error handling — a ``kind="crash"`` rule here
                       raises ``InjectedCrash`` (a ``BaseException``)
                       that kills the worker thread itself, exercising
                       the supervisor restart path;
``worker.ingest``      once per ingest *attempt* (so retries re-hit it)
                       — ``kind="error"`` raises the retryable
                       ``InjectedFault``, ``kind="delay"`` injects a
                       slow ingest;
``wal.append``         before each WAL record write;
``checkpoint.write``   before each checkpoint file write;
``wal.compact``        mid-compaction, *after* the replacement log is
                       fully written but *before* the atomic swap —
                       both generations exist on disk, either must
                       restore bit-identically;
``replication.ship``   once per record shipped primary -> standby — an
                       ``"error"`` drops the record on the wire (the
                       standby falls behind and must catch up from the
                       primary's WAL or re-seed);
``replica.crash``      once per record applied by a standby's apply
                       thread — ``kind="crash"`` kills the standby;
``health.heartbeat``   once per health-monitor heartbeat probe of the
                       primary — ``"error"`` makes the probe fail,
                       driving the failure-threshold -> failover path.

Clock skew: ``plan.monotonic()`` is ``time.monotonic() +
clock_skew_s``; the runtime stamps epochs and staleness with it, so a
skewed plan proves the staleness accounting only ever compares
timestamps from the same clock.

Fault *handling* policy lives in ``FaultPolicy`` (how many retries, what
backoff, quarantine vs truncate, how many worker restarts) — the plan
decides what breaks, the policy decides how the runtime survives it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Optional, Sequence

import numpy as np


class InjectedFault(RuntimeError):
    """A planned transient failure (an ``Exception``: the per-batch
    retry/quarantine machinery handles it like any real ingest error)."""


class InjectedCrash(BaseException):
    """A planned worker-thread death. Deliberately NOT an ``Exception``:
    it escapes the per-batch handler and kills the worker loop itself,
    the way a real thread-fatal condition would — only the supervisor
    catches it."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One line of a fault schedule.

    Of the hits at ``site``: skip the first ``after``, then consider
    every ``every``-th; fire at most ``times`` of those (``None`` =
    unbounded), each with probability ``p`` (drawn from the rule's own
    seeded generator, so the decision sequence is reproducible).
    """

    site: str
    kind: str = "error"  # "error" | "crash" | "delay"
    after: int = 0
    every: int = 1
    times: Optional[int] = 1
    p: float = 1.0
    delay_s: float = 0.0
    message: str = ""

    def __post_init__(self):
        if self.kind not in ("error", "crash", "delay"):
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.every < 1:
            raise ValueError("every must be >= 1")


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """How the ingest worker survives failures (the defaults reproduce
    the historical semantics: no retries, fail-fast truncation).

    max_retries          ingest attempts after the first failure of a
                         batch before it is declared failed;
    backoff_s            first retry delay; doubles per attempt, capped
                         at ``backoff_cap_s`` (capped exponential);
    on_failure           ``"truncate"``: record the error, drop this and
                         every later batch, surface on the next
                         submit/flush (the historical contract) —
                         ``"quarantine"``: move the batch to the poison
                         queue (counted + logged, re-submittable from
                         ``StreamRuntime.poison``) and keep ingesting
                         later batches;
    max_worker_restarts  times the supervisor will respawn a crashed
                         worker thread before giving up and recording
                         the crash as a worker error.
    """

    max_retries: int = 0
    backoff_s: float = 0.05
    backoff_cap_s: float = 2.0
    on_failure: str = "truncate"
    max_worker_restarts: int = 5

    def __post_init__(self):
        if self.on_failure not in ("truncate", "quarantine"):
            raise ValueError(
                f"on_failure must be 'truncate' or 'quarantine', got "
                f"{self.on_failure!r}"
            )

    def backoff(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (0-based): capped exponential."""
        return min(self.backoff_cap_s, self.backoff_s * (2.0 ** attempt))


class _RuleState:
    __slots__ = ("rule", "rng", "fired", "considered")

    def __init__(self, rule: FaultRule, seed: int, index: int):
        self.rule = rule
        # independent per-rule stream: the draw sequence depends only on
        # (plan seed, site, rule index) and this rule's own hit ordinals.
        # crc32, not hash(): str hashing is salted per process, and the
        # whole point is that one seed replays one schedule across runs.
        self.rng = np.random.default_rng(
            np.random.SeedSequence(
                entropy=seed,
                spawn_key=(zlib.crc32(rule.site.encode()), index),
            )
        )
        self.fired = 0
        self.considered = 0


class FaultPlan:
    """A seeded, deterministic schedule of injected faults.

    Thread-safe: rule bookkeeping runs under one lock; the decision for
    a given (site, hit ordinal) never depends on other sites' traffic.
    """

    def __init__(
        self,
        seed: int = 0,
        rules: Sequence[FaultRule] = (),
        *,
        clock_skew_s: float = 0.0,
    ):
        self.seed = int(seed)
        self.clock_skew_s = float(clock_skew_s)
        self._mu = threading.Lock()
        self._hits: dict[str, int] = {}
        self._rules: dict[str, list[_RuleState]] = {}
        self._fires: list[dict] = []
        for i, r in enumerate(rules):
            self._rules.setdefault(r.site, []).append(
                _RuleState(r, self.seed, i)
            )

    # -- the injection point ------------------------------------------

    def check(self, site: str) -> None:
        """Count one hit at ``site``; raise/sleep if a rule fires."""
        with self._mu:
            h = self._hits.get(site, 0) + 1
            self._hits[site] = h
            fire: Optional[FaultRule] = None
            for st in self._rules.get(site, ()):
                r = st.rule
                if h <= r.after:
                    continue
                st.considered += 1
                if (st.considered - 1) % r.every != 0:
                    continue
                if r.times is not None and st.fired >= r.times:
                    continue
                if r.p < 1.0 and float(st.rng.random()) >= r.p:
                    continue
                st.fired += 1
                fire = r
                self._fires.append(
                    dict(site=site, kind=r.kind, hit=h,
                         t=time.monotonic())
                )
                break
        if fire is None:
            return
        msg = fire.message or (
            f"injected {fire.kind} at {site!r} (hit {h}, seed {self.seed})"
        )
        if fire.kind == "delay":
            time.sleep(fire.delay_s)
            return
        if fire.kind == "crash":
            raise InjectedCrash(msg)
        raise InjectedFault(msg)

    # -- skewed clock --------------------------------------------------

    def monotonic(self) -> float:
        return time.monotonic() + self.clock_skew_s

    # -- introspection (what the chaos tests assert on) ----------------

    def hits(self, site: str) -> int:
        with self._mu:
            return self._hits.get(site, 0)

    def fired(self, site: Optional[str] = None) -> int:
        with self._mu:
            return sum(
                1 for f in self._fires
                if site is None or f["site"] == site
            )

    def fires(self) -> list[dict]:
        with self._mu:
            return list(self._fires)

    def snapshot(self) -> dict:
        with self._mu:
            return {
                "seed": self.seed,
                "clock_skew_s": self.clock_skew_s,
                "hits": dict(self._hits),
                "fires": list(self._fires),
            }
