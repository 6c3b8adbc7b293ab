"""Replicated serving in the port, on the CPU: WAL shipping, fingerprint
fencing, failover, health-driven promotion and the integrity auditor.

Twins of ``tests/test_replication.py``. Every replica runs on
``device="cpu"``; every fault comes from a seeded ``FaultPlan``, so the
asserts are exact (bit-identical fingerprints, no acknowledged batch
lost). The replicated streams are also held to the JAX package's
synchronous stream over the same batches (the epoch fingerprint and the
snapshot's ``src_idx``). Probes and syncs run in lockstep; waits are
bounded polls, not sleeps.
"""
import dataclasses
import time

import numpy as np
import pytest

from conftest import make_clustered_points
from repro.core.matroid import MatroidSpec as JSpec
from repro.serve import diversity as jdiv
from repro_torch import obs
from repro_torch.core.matroid import MatroidSpec
from repro_torch.serve.diversity import (
    AuditConfig,
    DiversityQuery,
    FaultPlan,
    FaultPolicy,
    FaultRule,
    HealthConfig,
    HealthMonitor,
    IntegrityAuditor,
    ReplicaSet,
    StreamRuntime,
)
from repro_torch.serve.diversity.coalesce import PendingCall

CPU = "cpu"
SEEDS = (101, 202)
SPEC_ARGS = ("partition", 4, 1)


def _instance(rng, n=400, h=4, k=4):
    P = make_clustered_points(rng, n=n)
    cats = rng.integers(0, h, (n, 1)).astype(np.int32)
    caps = np.full(h, 2, np.int32)
    return P, cats, caps, MatroidSpec(*SPEC_ARGS), k


def _batches(P, cats, size=50):
    return [(P[o:o + size], cats[o:o + size])
            for o in range(0, P.shape[0], size)]


def _make_set(spec, k, caps, tmp_path, **kw):
    kw.setdefault("registry", obs.MetricsRegistry())
    return ReplicaSet.create(
        spec, k, dir=str(tmp_path / "replicas"), caps=caps, tau=12,
        block_size=32, device=CPU, **kw)


def _reference(k, caps, batches):
    """The JAX package's synchronous stream: (fingerprint, src_idx)."""
    ref = jdiv.StreamRuntime(JSpec(*SPEC_ARGS), k, tau=12, caps=caps,
                             block_size=32)
    for pts, cs in batches:
        ref.ingest(pts, cs)
    snap = ref.refresh(force=True)
    ref.close()
    return snap.fingerprint, snap.src_idx


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not met in time"
        time.sleep(0.005)


# --------------------------------------------------------------------------
# shipping parity
# --------------------------------------------------------------------------


def test_standby_replays_to_bit_identical_state(tmp_path):
    """A standby fed the primary's WAL records is bit-identical at every
    synced watermark, and both equal the JAX package's stream."""
    rng = np.random.default_rng(0)
    P, cats, caps, spec, k = _instance(rng)
    batches = _batches(P, cats)
    rs = _make_set(spec, k, caps, tmp_path)
    try:
        for pts, cs in batches:
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        prt = rs.primary.runtime
        srt = rs.standbys[0].runtime
        assert prt.n_offered == srt.n_offered == P.shape[0]
        assert prt.fingerprint == srt.fingerprint
        assert rs.verify_standbys() == {"standby-0": True}
        assert srt._applied_seq == prt._applied_seq == rs.acked_seq
        assert srt.latest() is not None
        assert srt.latest().fingerprint == prt.latest().fingerprint
        for a, b in zip(prt.state, srt.state):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        fp, src = _reference(k, caps, batches)
        assert prt.latest().fingerprint == fp
        assert np.array_equal(srt.latest().src_idx, src)
        # the two replicas' logs are record-for-record the same
        assert [r.seq for r in prt._wal.replay()] == \
            [r.seq for r in srt._wal.replay()]
    finally:
        rs.close()


def test_standby_serves_reads_and_tenant_fanout(tmp_path):
    rng = np.random.default_rng(1)
    P, cats, caps, spec, k = _instance(rng)
    rs = _make_set(spec, k, caps, tmp_path)
    try:
        rs.register_tenant("uni", spec=MatroidSpec("uniform"))
        for pts, cs in _batches(P, cats):
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        direct = rs.query_batch([DiversityQuery(k=k)], tenant="uni",
                                allow_stale=False)
        stale = rs.standbys[0].frontend.query_batch([DiversityQuery(k=k)],
                                                    tenant="uni")
        assert np.array_equal(np.sort(direct[0].indices),
                              np.sort(stale[0].indices))
        assert stale[0].epoch >= 0
    finally:
        rs.close()


def test_saturated_primary_sends_reads_to_a_standby(tmp_path):
    """With the primary's frontend at the saturation count, a deadline-
    free read is answered by the caught-up standby (counted), the same
    selection."""
    rng = np.random.default_rng(12)
    P, cats, caps, spec, k = _instance(rng, n=200)
    reg = obs.MetricsRegistry()
    rs = _make_set(spec, k, caps, tmp_path, registry=reg)
    try:
        for pts, cs in _batches(P, cats):
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        want = rs.query_batch([DiversityQuery(k=k)], allow_stale=False)
        fe = rs.primary.frontend
        fe._active = rs.config.saturation_active_calls
        try:
            got = rs.query_batch([DiversityQuery(k=k)])
        finally:
            fe._active = 0
        assert reg.counter("serve.replication.stale_reads").value == 1
        assert got[0].indices.tolist() == want[0].indices.tolist()
    finally:
        rs.close()


@pytest.mark.parametrize("seed", SEEDS)
def test_dropped_ship_heals_from_primary_wal(tmp_path, seed):
    rng = np.random.default_rng(seed)
    P, cats, caps, spec, k = _instance(rng)
    plan = FaultPlan(seed, [
        FaultRule(site="replication.ship", kind="error", after=2,
                  every=3, times=3),
    ])
    reg = obs.MetricsRegistry()
    rs = _make_set(spec, k, caps, tmp_path, registry=reg)
    rs.faults = plan  # ship side only: the runtimes stay clean
    try:
        bs = _batches(P, cats)
        for pts, cs in bs:
            rs.submit(pts, cs)
        rs.faults = None
        rs.submit(*bs[0])  # a clean trailing record fires the gap fetch
        rs.sync(timeout=120)
        drops = int(rs._m_ship_errors.value)
        assert drops >= 1
        heals = int(reg.counter("serve.replication.gap_heals",
                                replica="standby-0").value)
        assert heals >= drops
        assert rs.verify_standbys() == {"standby-0": True}
        assert not rs.standbys[0].fenced
        assert int(rs._m_reseeds.value) == 0
        assert rs.standbys[0].runtime.fingerprint == _reference(
            k, caps, bs + [bs[0]])[0]
    finally:
        rs.close()


@pytest.mark.parametrize("seed", SEEDS)
def test_transient_apply_fault_gap_heals(tmp_path, seed):
    rng = np.random.default_rng(seed)
    P, cats, caps, spec, k = _instance(rng, n=200)
    plan = FaultPlan(seed, [
        FaultRule(site="replica.crash", kind="error", after=1, times=1),
    ])
    reg = obs.MetricsRegistry()
    rs = _make_set(spec, k, caps, tmp_path, registry=reg,
                   standby_faults=plan)
    try:
        for pts, cs in _batches(P, cats):
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        assert not rs.standbys[0].dead
        assert int(reg.counter("serve.replication.gap_heals",
                               replica="standby-0").value) >= 1
        assert rs.verify_standbys() == {"standby-0": True}
    finally:
        rs.close()


def test_apply_crash_kills_standby(tmp_path):
    rng = np.random.default_rng(2)
    P, cats, caps, spec, k = _instance(rng, n=200)
    plan = FaultPlan(7, [
        FaultRule(site="replica.crash", kind="crash", after=1, times=1),
    ])
    reg = obs.MetricsRegistry()
    rs = _make_set(spec, k, caps, tmp_path, registry=reg,
                   standby_faults=plan)
    try:
        for pts, cs in _batches(P, cats):
            rs.submit(pts, cs)
        rs.flush()
        sb = rs.standbys[0]
        _wait(lambda: sb.dead)
        assert not sb.promotable
        assert int(reg.counter("serve.replication.apply_crashes",
                               replica="standby-0").value) == 1
        assert rs.verify_standbys() == {"standby-0": None}
        rs.sync(timeout=30)  # a dead standby is skipped, not waited on
        with pytest.raises(RuntimeError, match="no promotable standby"):
            rs.failover(reason="test")
    finally:
        rs.close()


# --------------------------------------------------------------------------
# divergence: fence + re-seed
# --------------------------------------------------------------------------


def test_divergent_standby_fences_and_reseeds(tmp_path):
    rng = np.random.default_rng(3)
    P, cats, caps, spec, k = _instance(rng)
    rs = _make_set(spec, k, caps, tmp_path)
    try:
        bs = _batches(P, cats)
        for pts, cs in bs[:4]:
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        sb = rs.standbys[0]
        # corrupt the standby out of band: a batch the primary never saw
        sb.runtime.ingest(
            rng.normal(size=(8, P.shape[1])).astype(np.float32),
            rng.integers(0, 4, (8, 1)).astype(np.int32))
        for pts, cs in bs[4:]:
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        assert rs.verify_standbys() == {"standby-0": False}
        assert int(rs._m_reseeds.value) == 1
        assert not sb.fenced  # re-seeded and back in rotation
        rs.sync(timeout=120)
        assert rs.verify_standbys() == {"standby-0": True}
        assert rs.primary.runtime.fingerprint == sb.runtime.fingerprint
        assert sb.runtime.state.dp.device == rs.primary.runtime.device
        assert sb.runtime.fingerprint == _reference(k, caps, bs)[0]
    finally:
        rs.close()


def test_fenced_standby_not_promotable(tmp_path):
    rng = np.random.default_rng(4)
    P, cats, caps, spec, k = _instance(rng, n=100)
    rs = _make_set(spec, k, caps, tmp_path)
    try:
        for pts, cs in _batches(P, cats):
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        rs.standbys[0]._fence("test")
        with pytest.raises(RuntimeError, match="no promotable standby"):
            rs.failover(reason="test")
    finally:
        rs.close()


# --------------------------------------------------------------------------
# failover
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_primary_kill_mid_ingest_promotes_with_parity(tmp_path, seed):
    """The primary's worker is killed mid-stream; the standby promotes,
    its stream is bit-identical to one runtime (and to the JAX package)
    over the same batches, and no acknowledged batch is lost."""
    rng = np.random.default_rng(seed)
    P, cats, caps, spec, k = _instance(rng, n=600)
    batches = _batches(P, cats)
    plan = FaultPlan(seed, [
        FaultRule(site="worker.loop", kind="crash", after=2 + seed % 5,
                  times=1),
    ])
    rs = _make_set(spec, k, caps, tmp_path, faults=plan,
                   fault_policy=FaultPolicy(max_worker_restarts=0))
    try:
        for pts, cs in batches:
            rs.submit(pts, cs)  # fails over inline if the death surfaced
        rs.flush()  # or here
        rs.sync(timeout=120)
        st = rs.stats()
        assert st["failovers"] == 1
        assert st["primary"] == "standby-0"
        assert st["acked_batches"] == len(batches)
        prt = rs.primary.runtime
        assert prt._applied_seq == rs.acked_seq
        assert prt.n_offered == P.shape[0]
        ref = StreamRuntime(spec, k, tau=12, caps=caps, block_size=32,
                            device=CPU)
        for pts, cs in batches:
            ref.ingest(pts, cs)
        assert prt.fingerprint == ref.refresh(force=True).fingerprint
        ref.close()
        fp, src = _reference(k, caps, batches)
        assert prt.fingerprint == fp
        assert np.array_equal(prt.latest().src_idx, src)
        assert rs.last_failover["promoted"] == "standby-0"
        res = rs.query_batch([DiversityQuery(k=k)], allow_stale=False)
        assert len(res) == 1 and res[0].indices.size > 0
        rs.submit(*batches[0])
        rs.flush()
    finally:
        rs.close()


@pytest.mark.parametrize("seed", SEEDS)
def test_health_monitor_heartbeat_failures_trigger_failover(tmp_path,
                                                           seed):
    rng = np.random.default_rng(seed)
    P, cats, caps, spec, k = _instance(rng, n=200)
    plan = FaultPlan(seed, [
        FaultRule(site="health.heartbeat", kind="error", times=None),
    ])
    rs = _make_set(spec, k, caps, tmp_path)
    mon = HealthMonitor(rs, HealthConfig(interval_s=0.01,
                                         failure_threshold=3))
    try:
        for pts, cs in _batches(P, cats):
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        assert mon.probe()["healthy"]
        rs.faults = plan  # every heartbeat now fails
        statuses = [mon.probe() for _ in range(3)]
        assert not statuses[-1]["healthy"]
        assert [s["failed_over"] for s in statuses] == [None, None,
                                                         "standby-0"]
        assert rs.primary.name == "standby-0"
        assert int(rs._m_failovers.value) == 1
        rs.faults = None
        assert mon.probe()["healthy"]
        assert rs.primary.runtime.fingerprint is not None
    finally:
        mon.close()
        rs.close()


def test_health_monitor_thread_starts_and_stops(tmp_path):
    """``start()`` probes on its own thread; ``close()`` stops it. The
    wait is on the probe counter, bounded."""
    rng = np.random.default_rng(13)
    P, cats, caps, spec, k = _instance(rng, n=100)
    reg = obs.MetricsRegistry()
    rs = _make_set(spec, k, caps, tmp_path, registry=reg)
    mon = HealthMonitor(rs, HealthConfig(interval_s=0.01))
    try:
        for pts, cs in _batches(P, cats):
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        assert mon.start() is mon.start()
        _wait(lambda: reg.counter("serve.health.probes").value >= 2)
        mon.close()
        n = reg.counter("serve.health.probes").value
        assert mon._thread is None
        assert reg.gauge("serve.health.healthy").value == 1.0
        assert reg.counter("serve.health.probes").value == n
    finally:
        mon.close()
        rs.close()


def test_failover_redispatches_parked_coalesced_calls(tmp_path):
    rng = np.random.default_rng(5)
    P, cats, caps, spec, k = _instance(rng)
    rs = _make_set(spec, k, caps, tmp_path)
    try:
        for pts, cs in _batches(P, cats):
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        fe = rs.primary.frontend
        co = fe.coalescer
        assert co is not None
        t0 = time.perf_counter()
        parked = [
            PendingCall(fe.default_tenant, [DiversityQuery(k=k)],
                        engine="auto", min_epoch=None, deadline=None,
                        enq_t=t0, dispatch_by=t0)
            for _ in range(2)
        ]
        for i, p in enumerate(parked):
            sh = co._shards[i % len(co._shards)]
            with sh.cv:
                sh.q.append(p)
        drained = fe.drain_pending()
        assert all(p in drained for p in parked)
        released = rs.standbys[0].frontend.adopt_pending(drained)
        assert released == len(drained)
        want = rs.standbys[0].frontend._query_batch_direct(
            [DiversityQuery(k=k)])
        for p in parked:
            assert p.done.is_set()
            assert p.error is None
            assert len(p.results) == 1
            assert p.results[0].indices.tolist() == \
                want[0].indices.tolist()
    finally:
        rs.close()


def test_most_caught_up_standby_wins_promotion(tmp_path):
    rng = np.random.default_rng(6)
    P, cats, caps, spec, k = _instance(rng)
    rs = _make_set(spec, k, caps, tmp_path, n_standbys=2)
    try:
        bs = _batches(P, cats)
        for pts, cs in bs[:4]:
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        sb1 = next(s for s in rs.standbys if s.name == "standby-1")
        sb1.stop(drain=False)
        behind = sb1.applied_upto
        for pts, cs in bs[4:]:
            rs.submit(pts, cs)
        rs.flush()
        sb0 = next(s for s in rs.standbys if s.name == "standby-0")
        _wait(lambda: sb0.applied_upto >= rs.acked_seq)
        assert sb1.applied_upto == behind < sb0.applied_upto
        assert rs.failover(reason="test") == "standby-0"
        assert rs.primary.runtime._applied_seq == rs.acked_seq
        assert rs.last_failover["retired"] == "primary"
        assert rs.primary.runtime.fingerprint == _reference(k, caps, bs)[0]
    finally:
        rs.close()


# --------------------------------------------------------------------------
# integrity auditor
# --------------------------------------------------------------------------


def test_audit_clean_stack_passes(tmp_path):
    rng = np.random.default_rng(7)
    P, cats, caps, spec, k = _instance(rng)
    rs = _make_set(spec, k, caps, tmp_path)
    try:
        for pts, cs in _batches(P, cats):
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        rs.query_batch([DiversityQuery(k=k)], allow_stale=False)
        aud = IntegrityAuditor(rs)
        reports = aud.audit_once()
        assert len(reports) == 2
        for r in reports:
            assert r.ok, r.violations
            assert r.checks > 0
        assert aud.total_violations == 0
        assert not rs.standbys[0].quarantined
    finally:
        rs.close()


@pytest.mark.parametrize("where", ["card", "host", "both"])
def test_audit_catches_corrupt_pdist_cache(tmp_path, where):
    """The matrix lives twice in a port entry: ``D`` (the card's; here a
    CPU tensor) and ``D_host``. Corrupting either, or both, is a pdist
    violation."""
    rng = np.random.default_rng(8)
    P, cats, caps, spec, k = _instance(rng, n=200)
    rs = _make_set(spec, k, caps, tmp_path, n_standbys=0)
    try:
        for pts, cs in _batches(P, cats):
            rs.submit(pts, cs)
        rs.flush()
        rs.query_batch([DiversityQuery(k=k)], allow_stale=False)
        fe = rs.primary.frontend
        aud = IntegrityAuditor(rs, config=AuditConfig(pdist_samples=64))
        assert all(r.ok for r in aud.audit_once())
        with fe.cache._mu:
            key, entry = next(iter(fe.cache._entries.items()))
            bad = dataclasses.replace(
                entry,
                D=entry.D + 10.0 if where != "host" else entry.D,
                D_host=(entry.D_host + 10.0 if where != "card"
                        else entry.D_host))
            fe.cache._entries[key] = bad
        reports = aud.audit_once()
        pdist = [v for r in reports for v in r.violations
                 if v.startswith("pdist")]
        assert pdist
        assert any(("card" if where == "card" else "host") in v
                   for v in pdist)
        if where != "both":
            assert any("on the card," in v for v in pdist)  # the two split
        with fe.cache._mu:
            fe.cache._entries[key] = entry
        assert all(r.ok for r in aud.audit_once())
    finally:
        rs.close()


def test_audit_catches_corrupt_state_and_quarantines(tmp_path):
    rng = np.random.default_rng(9)
    P, cats, caps, spec, k = _instance(rng)
    rs = _make_set(spec, k, caps, tmp_path)
    try:
        for pts, cs in _batches(P, cats):
            rs.submit(pts, cs)
        rs.sync(timeout=120)
        sb = rs.standbys[0]
        rt = sb.runtime
        with rt._cv:
            st = rt._state
            rt._state = st._replace(dp=st.dp + 1.0e6)
        reports = IntegrityAuditor(rs).audit_once()
        bad = next(r for r in reports if r.replica == "standby-0")
        assert not bad.ok
        assert any(v.startswith(("coverage", "fingerprint"))
                   for v in bad.violations)
        assert sb.quarantined and not sb.promotable
        with pytest.raises(RuntimeError, match="no promotable standby"):
            rs.failover(reason="test")
        assert next(r for r in reports if r.replica == "primary").ok
    finally:
        rs.close()


def test_audit_refingerprint_equals_the_runtime_and_reference():
    """The auditor re-hashes a host copy with the port's
    ``epoch_fingerprint``; the triple does not depend on the device, so it
    equals the runtime's, which equals the JAX package's."""
    rng = np.random.default_rng(10)
    P, cats, caps, spec, k = _instance(rng, n=200)
    batches = _batches(P, cats)
    rt = StreamRuntime(spec, k, tau=12, caps=caps, block_size=32,
                       registry=obs.MetricsRegistry(), device=CPU)
    try:
        for pts, cs in batches:
            rt.ingest(pts, cs)
        rt.refresh(force=True)
        aud = IntegrityAuditor(rt)
        reports = aud.audit_once()
        assert len(reports) == 1 and reports[0].ok
        assert reports[0].replica == "runtime"
        from repro_torch.serve.diversity.checkpoint import host_copy
        assert aud._refingerprint(host_copy(rt.state)) == rt.fingerprint
        assert rt.fingerprint == _reference(k, caps, batches)[0]
    finally:
        rt.close()


@pytest.mark.parametrize("placement", ["vmap", "pipeline"])
def test_audit_sharded_states(tmp_path, placement):
    """Stacked lanes and the pipeline's list are audited shard by shard,
    and re-hash to the runtime's fingerprint."""
    rng = np.random.default_rng(14)
    P, cats, caps, spec, k = _instance(rng, n=300)
    rt = StreamRuntime(spec, k, tau=12, caps=caps, block_size=32,
                       num_shards=3, placement=placement,
                       registry=obs.MetricsRegistry(), device=CPU)
    try:
        for pts, cs in _batches(P, cats):
            rt.ingest(pts, cs)
        rt.refresh(force=True)
        reports = IntegrityAuditor(rt).audit_once()
        assert reports[0].ok, reports[0].violations
        assert reports[0].checks > 3
    finally:
        rt.close()


# --------------------------------------------------------------------------
# the watermarked fingerprint history
# --------------------------------------------------------------------------


def test_fingerprint_watermarks_recorded_per_ingest():
    rng = np.random.default_rng(11)
    P, cats, caps, spec, k = _instance(rng, n=200)
    rt = StreamRuntime(spec, k, tau=12, caps=caps, block_size=32,
                       registry=obs.MetricsRegistry(), device=CPU)
    jrt = jdiv.StreamRuntime(JSpec(*SPEC_ARGS), k, tau=12, caps=caps,
                             block_size=32)
    try:
        offs = []
        for pts, cs in _batches(P, cats):
            rt.ingest(pts, cs)
            jrt.ingest(pts, cs)
            offs.append(rt.n_offered)
        assert rt.fingerprint_watermarks() == offs
        for n in offs:
            assert rt.fingerprint_at(n) is not None
            assert rt.fingerprint_at(n) == jrt.fingerprint_at(n)
        assert rt.fingerprint_at(offs[-1]) == rt.fingerprint
        assert rt.fingerprint_at(offs[-1] + 7) is None
    finally:
        rt.close()
        jrt.close()
