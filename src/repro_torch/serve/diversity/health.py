"""Health monitoring for a ``ReplicaSet``: heartbeat + WAL-lag +
worker-liveness, driving automatic failover.

Reference: ``repro/serve/diversity/health.py`` (the standard library
only; the port keeps its own copy).

A ``HealthMonitor`` probes on a fixed cadence (or on demand via
``probe()`` for deterministic tests):

  heartbeat        ``ReplicaSet.check_primary()`` — the
                   ``health.heartbeat`` chaos site fires inside it, a
                   closed runtime or a dead/sticky-errored ingest worker
                   fails it;
  replication lag  per-standby acked-minus-applied batch counts into the
                   ``serve.replication.lag_batches`` gauge (per replica)
                   and histogram (the fleet-wide distribution the bench
                   gates on);
  parity           one O(1) fingerprint-exchange round
                   (``verify_standbys``) — divergent standbys fence and
                   re-seed per the set's ``ReplicationConfig``.

``failure_threshold`` *consecutive* failed heartbeats trigger
``ReplicaSet.failover()``; the probe pins the primary it observed, so a
failover that already happened (e.g. the submit path's inline promotion)
is never doubled.

Metrics: ``serve.health.probes`` / ``heartbeat_failures`` /
``failovers_triggered``; ``serve.health.healthy`` gauge (1/0).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional

from ... import obs

_log = logging.getLogger("repro_torch.serve.diversity.health")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """``interval_s`` probe cadence; ``failure_threshold`` consecutive
    heartbeat failures before failover; ``verify_parity`` run the
    fingerprint exchange each probe; ``auto_failover`` promote on
    threshold (off = observe/alert only)."""

    interval_s: float = 0.05
    failure_threshold: int = 3
    verify_parity: bool = True
    auto_failover: bool = True


class HealthMonitor:
    """Background prober for one ``ReplicaSet``. ``start()`` spawns the
    thread; tests call ``probe()`` directly for lockstep determinism."""

    def __init__(
        self,
        replica_set,
        config: Optional[HealthConfig] = None,
        *,
        registry: Optional[obs.MetricsRegistry] = None,
    ):
        self.rset = replica_set
        self.config = config if config is not None else HealthConfig()
        self.registry = registry if registry is not None else (
            replica_set.registry
        )
        self._fail_streak = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.last_status: Optional[dict] = None
        reg = self.registry
        self._m_probes = reg.counter("serve.health.probes")
        self._m_hb_failures = reg.counter("serve.health.heartbeat_failures")
        self._m_triggered = reg.counter("serve.health.failovers_triggered")
        self._g_healthy = reg.gauge("serve.health.healthy")

    def probe(self) -> dict:
        """One probe round; returns the status dict it recorded."""
        rset = self.rset
        p = rset.primary  # pin: only fail over the primary we observed
        self._m_probes.inc()
        reason = rset.check_primary()
        healthy = reason is None
        self._g_healthy.set(1.0 if healthy else 0.0)
        if healthy:
            self._fail_streak = 0
        else:
            self._fail_streak += 1
            self._m_hb_failures.inc()
        lag = rset.observe_lag()
        parity = None
        if self.config.verify_parity and healthy:
            parity = rset.verify_standbys()
        failed_over = None
        if (
            not healthy
            and self.config.auto_failover
            and self._fail_streak >= self.config.failure_threshold
        ):
            try:
                failed_over = rset.failover(
                    reason=f"heartbeat: {reason}", expect=p
                )
                self._m_triggered.inc()
                self._fail_streak = 0
            except RuntimeError as e:
                # no promotable standby: keep probing (and degrading)
                _log.warning("failover skipped: %s", e)
        self.last_status = dict(
            healthy=healthy,
            reason=reason,
            fail_streak=self._fail_streak,
            lag=lag,
            parity=parity,
            primary=rset.primary.name,
            failed_over=failed_over,
        )
        return self.last_status

    # -- background thread ---------------------------------------------

    def start(self) -> "HealthMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="replica-health", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.probe()
            except Exception as e:  # noqa: BLE001 — the monitor must
                # outlive any single probe failure
                _log.warning("health probe error: %s: %s",
                             type(e).__name__, e)

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
