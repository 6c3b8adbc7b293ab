"""Freshness, concurrency, supervision and observability of the port's
serving runtime on the CPU.

Twins of ``tests/test_freshness.py`` (queries concurrent with async
ingestion answer from published epochs, ``flush()`` barriers to the newest
epoch, the epoch-aware snapshot), of the service-needing parts of
``tests/test_obs.py`` (trace IDs through ``query_batch`` and across
``submit``, staleness and publish latency under concurrent submit,
``on_publish`` containment, truncation on a worker error, per-tenant
metrics, ``stats()``) and of the supervised-worker parts of
``tests/test_fault_tolerance.py`` that need no write-ahead log (the
log's cases are in ``tests/test_torch_durability.py``). Streams that went through the async worker are held to the JAX
package's synchronous stream over the same batches (the epoch
fingerprint, which hashes the integer cells only).
"""
import math
import threading
import time

import numpy as np
import pytest

from conftest import make_clustered_points
from repro.core.matroid import MatroidSpec as JSpec
from repro.serve import diversity as jdiv
from repro_torch import obs
from repro_torch.core.matroid import MatroidSpec, PartitionMatroid
from repro_torch.serve.diversity import (
    DiversityQuery,
    DiversityService,
    FaultPlan,
    FaultPolicy,
    FaultRule,
    QueryFrontend,
    StreamRuntime,
)

CPU = "cpu"
SEEDS = (101, 202)
SPEC_ARGS = ("partition", 4, 1)


def _instance(rng, n=400, h=4, k=4):
    P = make_clustered_points(rng, n=n)
    cats = rng.integers(0, h, (n, 1)).astype(np.int32)
    caps = np.full(h, 2, np.int32)
    return P, cats, caps, MatroidSpec("partition", num_categories=h,
                                      gamma=1), k


def _runtime(spec, k, caps, **kw):
    kw.setdefault("block_size", 32)
    kw.setdefault("tau", 12)
    return StreamRuntime(spec, k, caps=caps, device=CPU, **kw)


def _batches(P, cats, size=50):
    return [(P[o:o + size], cats[o:o + size])
            for o in range(0, P.shape[0], size)]


def _reference_fingerprint(k, caps, batches):
    """The JAX package's synchronous stream over the same batches."""
    ref = jdiv.StreamRuntime(JSpec(*SPEC_ARGS), k, tau=12, caps=caps,
                             block_size=32)
    for pts, cs in batches:
        ref.ingest(pts, cs)
    fp = ref.refresh(force=True).fingerprint
    ref.close()
    return fp


# --------------------------------------------------------------------------
# freshness (tests/test_freshness.py)
# --------------------------------------------------------------------------


def test_flush_round_trips_to_newest_epoch(rng):
    P, cats, caps, spec, k = _instance(rng)
    n, batch = P.shape[0], 100
    rt = _runtime(spec, k, caps)
    fe = QueryFrontend(rt)
    with rt:
        for off in range(0, n, batch):
            rt.submit(P[off:off + batch], cats[off:off + batch])
        e = rt.flush()
        assert rt.n_offered == n
        snap = rt.latest()
        assert snap.epoch == e and snap.n_offered == n
        res = fe.query(DiversityQuery(k=k), min_epoch=e)
        assert res.epoch >= e
    svc = DiversityService(spec, k, tau=12, caps=caps, block_size=32,
                           device=CPU)
    jsvc = jdiv.DiversityService(JSpec(*SPEC_ARGS), k, tau=12, caps=caps,
                                 block_size=32)
    for off in range(0, n, batch):
        svc.ingest(P[off:off + batch], cats[off:off + batch])
        jsvc.ingest(P[off:off + batch], cats[off:off + batch])
    _, _, src = svc.snapshot()
    assert np.array_equal(snap.src_idx, src)
    assert np.array_equal(snap.src_idx, jsvc.snapshot()[2])
    assert snap.fingerprint == jsvc.runtime.fingerprint
    ref = svc.query(DiversityQuery(k=k))
    assert sorted(res.indices.tolist()) == sorted(ref.indices.tolist())
    assert res.diversity == ref.diversity


def test_concurrent_queries_always_answer_published_epochs(rng):
    P, cats, caps, spec, k = _instance(rng, n=800)
    n, batch = P.shape[0], 50
    history: dict[int, tuple] = {}

    def on_publish(snap):
        history[snap.epoch] = (snap.size, set(snap.src_idx.tolist()),
                               snap.published_at)

    rt = _runtime(spec, k, caps, publish_every=2, on_publish=on_publish)
    fe = QueryFrontend(rt)
    rt.ingest(P[:batch], cats[:batch])
    fe.query(DiversityQuery(k=k))
    results, errors = [], []

    def reader():
        try:
            for _ in range(25):
                r = fe.query(DiversityQuery(k=k))
                results.append((r, time.monotonic()))
        except BaseException as exc:  # pragma: no cover - surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=reader) for _ in range(2)]
    with rt:
        for t in threads:
            t.start()
        for off in range(batch, n, batch):
            rt.submit(P[off:off + batch], cats[off:off + batch])
        for t in threads:
            t.join()
        rt.flush()
    assert not errors and results
    m = PartitionMatroid(cats[:, 0], caps)
    for r, t_answer in results:
        assert r.epoch in history, "answer from an unpublished epoch"
        size, src, published_at = history[r.epoch]
        assert published_at <= t_answer
        assert r.coreset_size == size, "torn read"
        assert set(r.indices.tolist()) <= src, "torn read"
        assert m.is_independent(list(r.indices))
    assert rt.latest().epoch == max(history)
    assert rt.latest().n_offered == n
    assert rt.latest().fingerprint == _reference_fingerprint(
        k, caps, _batches(P, cats))


def test_min_epoch_blocks_until_published_and_validates(rng):
    P, cats, caps, spec, k = _instance(rng, n=200)
    rt = _runtime(spec, k, caps)
    fe = QueryFrontend(rt)
    with rt:
        rt.ingest(P[:100], cats[:100])
        e1 = rt.refresh().epoch
        with pytest.raises(ValueError, match="min_epoch"):
            fe.query(DiversityQuery(k=k), min_epoch=e1 + 5)
        rt.submit(P[100:], cats[100:])
        e2 = rt.flush()
        assert e2 > e1
        assert fe.query(DiversityQuery(k=k), min_epoch=e2).epoch >= e2


def test_worker_errors_surface_and_truncate_the_stream(rng):
    P, cats, caps, spec, k = _instance(rng, n=100)
    rt = _runtime(spec, k, caps)
    with rt:
        rt.ingest(P[:50], cats[:50])
        rt.submit(P[50:60], np.zeros((10, 3), np.int32))  # wrong width
        try:
            rt.submit(P[60:70], cats[60:70])
        except RuntimeError:
            pass  # the worker may have recorded the error already
        with pytest.raises(RuntimeError, match="async ingest worker"):
            rt.flush()
        with pytest.raises(RuntimeError, match="async ingest worker"):
            rt.submit(P[70:80], cats[70:80])
        assert rt.n_offered == 50, "stream did not truncate at the failure"
        assert rt.pending == 0, "dropped batches left pending stuck"


def test_close_is_idempotent_and_stops_submit(rng):
    P, cats, caps, spec, k = _instance(rng, n=100)
    rt = _runtime(spec, k, caps)
    rt.submit(P[:50], cats[:50])
    rt.flush()
    rt.close()
    rt.close()
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit(P[50:], cats[50:])
    rt.ingest(P[50:], cats[50:])
    assert rt.n_offered == 100
    assert rt.refresh(force=True).n_offered == 100


def test_snapshot_is_epoch_aware_noop_on_unchanged_state(rng):
    P, cats, caps, spec, k = _instance(rng, n=300)
    svc = DiversityService(spec, k, tau=12, caps=caps, device=CPU)
    svc.ingest(P, cats)
    a = svc.snapshot()
    mats = svc.runtime.snapshot_materializations
    b = svc.snapshot()
    assert all(x is y for x, y in zip(a, b)), "unchanged snapshot recopied"
    assert svc.runtime.snapshot_materializations == mats
    rep = svc.ingest(a[0][:1], a[1][:1])
    svc.query(DiversityQuery(k=k))
    c = svc.snapshot()
    if not rep.coreset_changed:
        assert c[0] is a[0]
        assert svc.runtime.snapshot_materializations == mats
    svc.ingest(np.zeros((0, P.shape[1]), np.float32), pad_to=svc.block_size)
    svc.snapshot()
    assert svc.runtime.snapshot_materializations == (
        mats if not rep.coreset_changed else mats + 1)


def test_unchanged_epoch_not_bumped_by_queries(rng):
    P, cats, caps, spec, k = _instance(rng, n=300)
    svc = DiversityService(spec, k, tau=12, caps=caps, device=CPU)
    svc.ingest(P, cats)
    e1 = svc.query(DiversityQuery(k=k)).epoch
    e2 = svc.query(DiversityQuery(k=k)).epoch
    assert e1 == e2 == svc.runtime.epochs_published


def test_fingerprint_history_matches_reference_watermarks(rng):
    P, cats, caps, spec, k = _instance(rng, n=300)
    rt = _runtime(spec, k, caps)
    jrt = jdiv.StreamRuntime(JSpec(*SPEC_ARGS), k, tau=12, caps=caps,
                             block_size=32)
    for pts, cs in _batches(P, cats, 75):
        rt.ingest(pts, cs)
        jrt.ingest(pts, cs)
    assert rt.fingerprint_watermarks() == jrt.fingerprint_watermarks()
    for n in rt.fingerprint_watermarks():
        assert rt.fingerprint_at(n) == jrt.fingerprint_at(n)
    assert rt.fingerprint_at(1) is None


# --------------------------------------------------------------------------
# observability through the service (tests/test_obs.py)
# --------------------------------------------------------------------------


def _obs_runtime(**kw):
    kw.setdefault("registry", obs.MetricsRegistry())
    return StreamRuntime(MatroidSpec("partition", num_categories=4, gamma=1),
                         8, tau=16, caps=np.full(4, 4, np.int32), device=CPU,
                         **kw)


def _feed(rng, n=64):
    return (rng.normal(size=(n, 4)).astype(np.float32),
            rng.integers(0, 4, size=(n, 1)).astype(np.int32))


def test_instrumented_serving_paths_are_trace_clean(rng):
    rt = _obs_runtime()
    fe = QueryFrontend(rt)
    rt.ingest(*_feed(rng, 128))
    assert len(fe.query_batch([DiversityQuery(k=4)])) == 1


def test_trace_id_propagates_through_query_batch_spans(rng):
    rt = _obs_runtime()
    fe = QueryFrontend(rt)
    rt.ingest(*_feed(rng, 128))
    buf = obs.default_buffer()
    buf.clear()
    fe.query_batch([DiversityQuery(k=4), DiversityQuery(k=3)])
    spans = buf.drain()
    assert {"query_batch", "resolve_tenant", "acquire_epoch", "cache_entry",
            "solve", "device_sync"} <= {s.name for s in spans}
    ids = {s.trace_id for s in spans}
    assert len(ids) == 1 and None not in ids
    buf.clear()
    fe.query_batch([DiversityQuery(k=4)])
    ids2 = {s.trace_id for s in buf.drain()}
    assert len(ids2) == 1 and ids2 != ids


def test_trace_id_crosses_submit_to_worker_thread(rng):
    rt = _obs_runtime()
    buf = obs.default_buffer()
    buf.clear()
    rt.submit(*_feed(rng, 64))
    rt.flush()
    spans = buf.drain()
    sub = [s for s in spans if s.name == "submit"]
    wrk = [s for s in spans if s.name == "worker_ingest"]
    assert len(sub) == 1 and len(wrk) == 1
    assert sub[0].trace_id is not None
    assert wrk[0].trace_id == sub[0].trace_id
    assert wrk[0].tid != sub[0].tid
    rt.close()


def test_staleness_and_publish_latency_under_concurrent_submit(rng):
    reg = obs.MetricsRegistry()
    rt = _obs_runtime(registry=reg, publish_every=2)
    rt.ingest(*_feed(rng, 64))
    n_batches = 12
    threads = [
        threading.Thread(
            target=lambda i=i: rt.submit(*_feed(np.random.default_rng(i),
                                                32)),
            daemon=True)
        for i in range(n_batches)
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30.0)
    rt.flush()
    stale = reg.histogram("serve.epoch.staleness_s")
    pub = reg.histogram("serve.epoch.publish_latency_s")
    assert stale.count == n_batches
    assert stale.sum >= 0 and math.isfinite(stale.sum)
    assert pub.count == reg.counter("serve.epoch.published").value > 0
    assert reg.counter("serve.submit.batches").value == n_batches
    assert reg.counter("serve.worker.errors").value == 0
    d = stale.describe()
    assert d["min"] >= 0 and d["p95"] >= d["min"]
    rt.close()


def test_on_publish_error_is_counted_not_fatal(rng):
    reg = obs.MetricsRegistry()
    boom = []

    def bad_callback(snap):
        boom.append(snap.epoch)
        raise RuntimeError("subscriber bug")

    rt = _obs_runtime(registry=reg, on_publish=bad_callback)
    P, C = _feed(rng, 64)
    rt.submit(P, C)
    assert rt.flush() >= 1 and boom
    assert reg.counter("serve.publish.callback_errors").value == len(boom)
    n0 = rt.n_offered
    rt.submit(P, C)
    rt.flush()
    assert rt.n_offered == n0 + 64
    assert reg.counter("serve.worker.errors").value == 0
    rt.close()


def test_ingest_errors_still_truncate_the_stream(rng):
    rt = _obs_runtime()
    rt.submit(*_feed(rng, 64))
    rt.flush()
    rt.submit(np.full((8, 3), 1.0, np.float32), None)  # wrong dimension
    with pytest.raises(RuntimeError, match="worker failed"):
        rt.flush()
    rt.close()


def test_query_metrics_labeled_by_tenant_and_engine(rng):
    reg = obs.MetricsRegistry()
    rt = _obs_runtime(registry=reg)
    fe = QueryFrontend(rt)
    rt.ingest(*_feed(rng, 128))
    fe.register_tenant("cosine", metric="cosine")
    fe.query_batch([DiversityQuery(k=4)] * 3)
    fe.query_batch([DiversityQuery(k=4)], tenant="cosine")
    snap = reg.snapshot()
    assert snap["serve.query.latency_s{tenant=default}"]["count"] == 1
    assert snap["serve.query.latency_s{tenant=cosine}"]["count"] == 1
    assert snap["serve.query.batch_size{tenant=default}"]["max"] == 3
    assert any("engine=" in key and "tenant=default" in key
               for key in snap if key.startswith("serve.solve.latency_s{")
               and snap[key]["count"] > 0)
    assert reg.counter("serve.query.cache_misses",
                       tenant="default").value == 1
    fe.query_batch([DiversityQuery(k=4)])
    assert reg.counter("serve.query.cache_hits", tenant="default").value == 1
    assert reg.counter("serve.query.cache_misses",
                       tenant="default").value == 1
    traffic = fe.tenant_traffic()
    assert traffic["default"]["requests"] == 2
    assert traffic["cosine"]["queries"] == 1
    rt.close()


def test_stats_view(rng):
    rt = _obs_runtime()
    fe = QueryFrontend(rt)
    rt.ingest(*_feed(rng, 128))
    fe.query(DiversityQuery(k=4))
    s = fe.stats()
    assert s["epoch"] >= 1 and s["n_offered"] == 128
    assert s["cache"]["builds"] == 1 and s["cache"]["misses"] == 1
    fe.query(DiversityQuery(k=4))
    assert fe.stats()["cache"]["hits"] == 1
    assert fe.stats()["cost_model"]["observations"] >= 1
    rt.close()


# --------------------------------------------------------------------------
# the supervised worker (tests/test_fault_tolerance.py, no log)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_worker_crash_restart_matches_reference_stream(rng, seed):
    P, cats, caps, spec, k = _instance(rng)
    batches = _batches(P, cats)
    reg = obs.MetricsRegistry()
    plan = FaultPlan(seed, [FaultRule(site="worker.loop", kind="crash",
                                      after=seed % 3, times=2, every=2)])
    rt = _runtime(spec, k, caps, registry=reg, faults=plan,
                  fault_policy=FaultPolicy(max_worker_restarts=5))
    for pts, cs in batches:
        rt.submit(pts, cs)
    rt.flush()
    assert rt.n_offered == P.shape[0]
    crashes = reg.counter("serve.worker.crashes").value
    assert crashes == plan.fired("worker.loop") == 2
    assert reg.counter("serve.worker.restarts").value == crashes
    assert reg.counter("serve.worker.errors").value == 0
    rt.close()
    assert rt.latest().fingerprint == _reference_fingerprint(k, caps,
                                                             batches)


def test_worker_restarts_exhausted_surfaces_one_error(rng):
    P, cats, caps, spec, k = _instance(rng, n=200)
    reg = obs.MetricsRegistry()
    plan = FaultPlan(0, [FaultRule(site="worker.loop", kind="crash",
                                   times=None)])
    rt = _runtime(spec, k, caps, registry=reg, faults=plan,
                  fault_policy=FaultPolicy(max_worker_restarts=2))
    with pytest.raises(RuntimeError, match="worker failed"):
        for pts, cs in _batches(P, cats):
            rt.submit(pts, cs)
        rt.flush()
    assert reg.counter("serve.worker.errors").value == 1
    assert reg.counter("serve.worker.restarts").value == 2
    with pytest.raises(RuntimeError, match="worker failed"):
        rt.flush()
    assert reg.counter("serve.worker.errors").value == 1
    rt.close()


@pytest.mark.parametrize("seed", SEEDS)
def test_transient_errors_retry_to_success(rng, seed):
    P, cats, caps, spec, k = _instance(rng)
    batches = _batches(P, cats)
    reg = obs.MetricsRegistry()
    plan = FaultPlan(seed, [FaultRule(site="worker.ingest", kind="error",
                                      after=seed % 4, times=3, every=3)])
    rt = _runtime(spec, k, caps, registry=reg, faults=plan,
                  fault_policy=FaultPolicy(max_retries=3, backoff_s=0.01))
    for pts, cs in batches:
        rt.submit(pts, cs)
    rt.flush()
    assert reg.counter("serve.worker.errors").value == 0
    assert reg.counter("serve.worker.retries").value == plan.fired(
        "worker.ingest") == 3
    assert len(rt.poison) == 0
    rt.close()
    assert rt.latest().fingerprint == _reference_fingerprint(k, caps,
                                                             batches)


def test_poison_queue_quarantines_and_stream_continues(rng):
    P, cats, caps, spec, k = _instance(rng)
    batches = _batches(P, cats)
    reg = obs.MetricsRegistry()
    plan = FaultPlan(7, [FaultRule(site="worker.ingest", kind="error",
                                   after=2, times=2)])
    rt = _runtime(spec, k, caps, registry=reg, faults=plan,
                  fault_policy=FaultPolicy(max_retries=1, backoff_s=0.01,
                                           on_failure="quarantine"))
    for pts, cs in batches:
        rt.submit(pts, cs)
    rt.flush()
    assert len(rt.poison) == 1
    bad = rt.poison[0]
    assert bad.attempts == 2 and bad.seq == -1
    assert reg.counter("serve.worker.errors").value == 1
    assert reg.counter("serve.worker.poisoned").value == 1
    assert rt.n_offered == P.shape[0] - bad.points.shape[0]
    kept = [b for b in batches if not np.array_equal(b[0], bad.points)]
    assert rt.latest().fingerprint == _reference_fingerprint(k, caps, kept)
    rt.submit(bad.points, bad.cats)
    rt.flush()
    assert rt.n_offered == P.shape[0]
    rt.close()


def test_clock_skew_never_tears_staleness(rng):
    P, cats, caps, spec, k = _instance(rng, n=200)
    reg = obs.MetricsRegistry()
    rt = _runtime(spec, k, caps, registry=reg,
                  faults=FaultPlan(0, clock_skew_s=-1800.0))
    for pts, cs in _batches(P, cats):
        rt.submit(pts, cs)
    rt.flush()
    stale = reg.histogram("serve.epoch.staleness_s")
    assert stale.count == 4 and stale.describe()["min"] >= 0.0
    assert rt.latest().published_at < time.monotonic()
    rt.close()


def test_forced_close_counts_dropped_batches(rng):
    P, cats, caps, spec, k = _instance(rng, n=300)
    reg = obs.MetricsRegistry()
    plan = FaultPlan(0, [FaultRule(site="worker.ingest", kind="delay",
                                   delay_s=0.1, times=None)])
    rt = _runtime(spec, k, caps, registry=reg, faults=plan)
    for pts, cs in _batches(P, cats):
        rt.submit(pts, cs)
    with pytest.raises(TimeoutError, match="drain"):
        rt.close(timeout=0.01)
    assert rt.pending > 0
    rt.close(drain=False)
    assert reg.counter("serve.worker.dropped_batches",
                       reason="close").value > 0
    with pytest.raises(RuntimeError, match="worker failed"):
        rt.flush()
    assert reg.counter("serve.worker.errors").value == 0


def test_nonfinite_batch_rejected(rng):
    P, cats, caps, spec, k = _instance(rng, n=100)
    reg = obs.MetricsRegistry()
    rt = _runtime(spec, k, caps, registry=reg)
    bad = P[:10].copy()
    bad[3, 1] = np.nan
    for call in (rt.ingest, rt.submit):
        with pytest.raises(ValueError, match="non-finite"):
            call(bad, cats[:10])
    assert reg.counter("serve.ingest.rejected",
                       reason="nonfinite").value == 2
    assert rt.n_offered == 0 and rt.pending == 0
    rt.close()
