"""Online integrity auditor: verify published coreset invariants off the
hot path.

Reference: ``repro/serve/diversity/audit.py``. The state is audited on a
host copy taken under the runtime lock (the scan updates the live tensors
in place). A cache entry's matrix lives in two places in the port: ``D``
on the card, which the batched engines read, and ``D_host``, which the
host engines read. The pdist check samples both (the card's by gathering
the sampled entries there, one small copy) and reports a violation when
either disagrees with the host recomputation or the two disagree with
each other.

The streaming scan (Alg. 2) maintains invariants that are cheap to spot-
check on a host copy of the state but would be catastrophic to violate
silently in serving:

  center budget   at most ``tau + 1`` valid centers per shard (the
                  restructure trigger);
  coverage        radius variant: every delegate sits within ``2R`` of
                  its center -- the HANDLE threshold opens a new center at
                  ``2R``, and each restructure halves-then-extends the
                  bound (``a/2 + 1``) back under 2, so ``dist(delegate,
                  center) <= 2R`` holds at every step (skipped for the
                  diameter variant, whose per-center slack is
                  ``eps``-scaled, and while ``R == 0``);
  independence    uniform/partition: each center's delegate set is
                  independent in the matroid (HANDLE enforces the count
                  and per-category caps); transversal: the slot cap
                  bounds the delegate count (independence is certified
                  downstream by the matching solver);
  snapshot        published epochs carry finite points and in-range,
                  duplicate-free source indices;
  pdist cache     sampled entries of each tenant's cached distance
                  matrix, on the card and on the host, match a host
                  recomputation and each other;
  fingerprint     the state copy the audit read re-hashes to the
                  fingerprint the runtime reported at copy time (a torn
                  copy or corrupted buffer fails this).

``IntegrityAuditor`` samples these on demand (``audit_once``) or on a
background cadence (``start``). Against a ``ReplicaSet`` it audits the
primary and every standby and *quarantines* a standby that fails --
excluded from stale reads and from promotion -- because a replica serving
corrupt answers is strictly worse than one fewer replica.

Metrics: ``serve.audit.runs`` / ``serve.audit.violations{check=}`` /
``serve.audit.quarantined`` / ``serve.audit.last_ok`` gauge.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Optional

import numpy as np
import torch

from ... import obs
from ...core.matroid import make_host_matroid
from ...core.streaming import StreamState, epoch_fingerprint
from .checkpoint import host_copy

_log = logging.getLogger("repro_torch.serve.diversity.audit")


@dataclasses.dataclass(frozen=True)
class AuditConfig:
    """``pdist_samples`` sampled matrix entries per cached tenant entry;
    ``rel_tol`` f32 relative tolerance for distance/coverage checks;
    ``interval_s`` background cadence; ``quarantine`` whether a failing
    ``ReplicaSet`` standby is quarantined; ``seed`` for the sampling
    rng (deterministic audits)."""

    pdist_samples: int = 32
    rel_tol: float = 1e-3
    interval_s: float = 0.25
    quarantine: bool = True
    seed: int = 0


@dataclasses.dataclass
class AuditReport:
    replica: str
    fingerprint: Optional[int]
    n_offered: int
    checks: int  # individual assertions evaluated
    violations: "list[str]" = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def _iter_shard_states(host_state):
    """Yield per-shard host ``StreamState``s from any placement's state:
    a single state, a stacked (leading shard dim) state, or a list. The
    fields may be numpy arrays or CPU tensors."""
    if host_state is None:
        return
    if isinstance(host_state, list):
        for st in host_state:
            yield st
        return
    R = np.asarray(host_state.R)
    if R.ndim == 0:
        yield host_state
        return
    S = R.shape[0]
    for s in range(S):
        yield type(host_state)(*(np.asarray(f)[s] for f in host_state))


def audit_state(
    st,
    *,
    spec,
    k: int,
    tau: int,
    caps=None,
    variant: str = "radius",
    oracle=None,
    rel_tol: float = 1e-3,
) -> "tuple[int, list[str]]":
    """Invariant checks on ONE host shard state. Returns
    ``(checks_evaluated, violations)``."""
    checks = 0
    v: "list[str]" = []
    cvalid = np.asarray(st.cvalid, bool)
    centers = np.asarray(st.centers, np.float32)
    dp = np.asarray(st.dp, np.float32)
    dv = np.asarray(st.dv, bool)
    dc = np.asarray(st.dc, np.int32)
    R = float(np.asarray(st.R))
    slot_cap = dp.shape[1]
    live = np.nonzero(cvalid)[0]
    checks += 1
    if live.size > tau + 1:
        v.append(
            f"center budget: {live.size} valid centers > tau+1 = {tau + 1}"
        )
    lim = 2.0 * R * (1.0 + rel_tol) + 1e-5
    for z in live:
        rows = np.nonzero(dv[z])[0]
        checks += 1
        if rows.size > slot_cap:
            v.append(
                f"slots: center {z} has {rows.size} delegates > slot "
                f"cap {slot_cap}"
            )
        if rows.size == 0:
            continue
        if variant == "radius" and R > 0.0:
            checks += 1
            dists = np.linalg.norm(dp[z][rows] - centers[z], axis=1)
            worst = float(dists.max())
            if worst > lim:
                v.append(
                    f"coverage: center {z} delegate at dist "
                    f"{worst:.6g} > 2R = {2.0 * R:.6g}"
                )
        if spec.kind in ("uniform", "partition"):
            checks += 1
            m = make_host_matroid(
                spec, dc[z][rows], caps, int(rows.size), k, oracle
            )
            if not m.is_independent(list(range(int(rows.size)))):
                v.append(
                    f"independence: center {z} delegate set of size "
                    f"{rows.size} is dependent under {spec.kind}"
                )
    return checks, v


def audit_snapshot(snap, n_offered: int) -> "tuple[int, list[str]]":
    """Published-epoch checks: finite points, in-range unique src_idx."""
    checks = 0
    v: "list[str]" = []
    if snap is None:
        return checks, v
    pts = np.asarray(snap.points)
    src = np.asarray(snap.src_idx)
    checks += 1
    if pts.size and not bool(np.isfinite(pts).all()):
        v.append(f"snapshot: epoch {snap.epoch} non-finite coreset points")
    checks += 1
    if src.size and (src.min() < 0 or src.max() >= max(1, n_offered)):
        v.append(
            f"snapshot: epoch {snap.epoch} src_idx outside [0, "
            f"{n_offered})"
        )
    checks += 1
    if src.size != np.unique(src).size:
        v.append(f"snapshot: epoch {snap.epoch} duplicate src_idx")
    return checks, v


class IntegrityAuditor:
    """Audit a ``ReplicaSet``, a ``(runtime, frontend)`` service stack,
    or a bare ``StreamRuntime``. See the module docstring for the
    invariants."""

    def __init__(
        self,
        target,
        *,
        config: Optional[AuditConfig] = None,
        registry: Optional[obs.MetricsRegistry] = None,
    ):
        self.target = target
        self.config = config if config is not None else AuditConfig()
        reg = registry
        if reg is None:
            reg = getattr(target, "registry", None)
        self.registry = reg if reg is not None else obs.default_registry()
        self._rng = np.random.default_rng(self.config.seed)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.total_checks = 0
        self.total_violations = 0
        self.reports: "list[AuditReport]" = []
        self._m_runs = self.registry.counter("serve.audit.runs")
        self._g_ok = self.registry.gauge("serve.audit.last_ok")

    # -- one audit pass ------------------------------------------------

    def audit_once(self) -> "list[AuditReport]":
        """Audit every replica of the target once. Updates metrics,
        quarantines failing ``ReplicaSet`` standbys, returns the
        reports."""
        reports = []
        for name, rt, fe, standby in self._replicas():
            rep = self._audit_replica(name, rt, fe)
            reports.append(rep)
            if not rep.ok:
                for viol in rep.violations:
                    check = viol.split(":", 1)[0].strip()
                    self.registry.counter(
                        "serve.audit.violations", check=check,
                        replica=name,
                    ).inc()
                if (
                    standby is not None
                    and self.config.quarantine
                    and not standby.quarantined
                ):
                    standby.quarantined = True
                    self.registry.counter(
                        "serve.audit.quarantined", replica=name
                    ).inc()
                    _log.warning(
                        "replica %s quarantined by audit: %s",
                        name, "; ".join(rep.violations),
                    )
        self._m_runs.inc()
        ok = all(r.ok for r in reports)
        self._g_ok.set(1.0 if ok else 0.0)
        self.total_checks += sum(r.checks for r in reports)
        self.total_violations += sum(len(r.violations) for r in reports)
        self.reports = reports
        return reports

    def _replicas(self):
        """Yield ``(name, runtime, frontend | None, standby | None)``."""
        t = self.target
        if hasattr(t, "primary") and hasattr(t, "standbys"):
            p = t.primary
            yield p.name, p.runtime, p.frontend, None
            for sb in t.standbys:
                if sb.dead:
                    continue
                yield sb.name, sb.runtime, sb.frontend, sb
        elif hasattr(t, "runtime") and hasattr(t, "frontend"):
            yield "service", t.runtime, t.frontend, None
        elif hasattr(t, "runtime"):
            yield "frontend", t.runtime, t, None
        else:
            yield "runtime", t, None, None

    def _audit_replica(self, name, rt, fe) -> AuditReport:
        cfg = self.config
        with obs.span("audit", cat="audit", replica=name):
            # one consistent cut of the live state: copy + fingerprint
            # under the runtime lock, verify outside it
            with rt._cv:
                fp = rt._fingerprint
                n_offered = rt.n_offered
                host = None if rt._state is None else host_copy(rt._state)
            rep = AuditReport(
                replica=name, fingerprint=fp, n_offered=n_offered,
                checks=0,
            )
            for st in _iter_shard_states(host):
                c, v = audit_state(
                    st,
                    spec=rt.spec, k=rt.k, tau=rt.tau, caps=rt.caps,
                    variant=rt.stream_variant, oracle=rt.oracle,
                    rel_tol=cfg.rel_tol,
                )
                rep.checks += c
                rep.violations.extend(v)
            if host is not None and fp is not None:
                rep.checks += 1
                fp2 = self._refingerprint(host)
                if fp2 != fp:
                    rep.violations.append(
                        f"fingerprint: state copy re-hashes to {fp2:#x}, "
                        f"runtime reported {fp:#x}"
                    )
            c, v = audit_snapshot(rt.latest(), n_offered)
            rep.checks += c
            rep.violations.extend(v)
            if fe is not None:
                c, v = self._audit_cache(fe)
                rep.checks += c
                rep.violations.extend(v)
            return rep

    @staticmethod
    def _refingerprint(host) -> int:
        """Mirror ``StreamRuntime._fingerprint_and_size`` on a host copy:
        the integer triple does not depend on the device, so it equals
        the runtime's."""
        def fp(st) -> int:
            return epoch_fingerprint(
                StreamState(*(torch.from_numpy(a) for a in st)))[0]

        if isinstance(host, list):
            return hash(tuple(fp(st) for st in host))
        return fp(host)

    def _audit_cache(self, fe) -> "tuple[int, list[str]]":
        """Spot-check cached pdist matrices, on the card and on the host,
        against host recomputation and against each other."""
        cfg = self.config
        checks = 0
        v: "list[str]" = []
        cache = fe.cache
        with cache._mu:
            entries = list(cache._entries.items())
        for key, e in entries:
            m = int(e.points.shape[0])
            if m < 2:
                continue
            s = min(cfg.pdist_samples, m * m)
            ii = self._rng.integers(0, m, size=s)
            jj = self._rng.integers(0, m, size=s)
            # solvers never consult self-distances, and the builder's
            # norm-expansion (|a|^2+|b|^2-2ab) leaves f32 noise on the
            # diagonal -- sample strictly off-diagonal entries
            off = ii != jj
            ii, jj = ii[off], jj[off]
            if ii.size == 0:
                continue
            pts = np.asarray(e.points, np.float32)
            want = np.linalg.norm(pts[ii] - pts[jj], axis=1)
            got_host = np.asarray(e.D_host)[ii, jj]
            dev = e.D.device
            got_dev = e.D[torch.as_tensor(ii, device=dev),
                          torch.as_tensor(jj, device=dev)].cpu().numpy()
            checks += 1
            tol = cfg.rel_tol * np.maximum(1.0, np.abs(want)) + 1e-4
            for where, got in (("card", got_dev), ("host", got_host)):
                bad = np.abs(got - want) > tol
                if bool(bad.any()):
                    b = int(np.nonzero(bad)[0][0])
                    v.append(
                        f"pdist: entry {key.spec.kind}/tau={key.tau} "
                        f"D[{ii[b]},{jj[b]}] on the {where} = "
                        f"{got[b]:.6g}, recomputed {want[b]:.6g}"
                    )
            split = got_dev != got_host
            if bool(split.any()):
                b = int(np.nonzero(split)[0][0])
                v.append(
                    f"pdist: entry {key.spec.kind}/tau={key.tau} "
                    f"D[{ii[b]},{jj[b]}] = {got_dev[b]:.6g} on the card, "
                    f"{got_host[b]:.6g} on the host"
                )
        return checks, v

    # -- background cadence --------------------------------------------

    def start(self) -> "IntegrityAuditor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="integrity-audit", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.audit_once()
            except Exception as e:  # noqa: BLE001 -- the auditor must
                # outlive any single pass's failure
                _log.warning("audit error: %s: %s", type(e).__name__, e)

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
