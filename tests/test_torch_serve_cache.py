"""The port's ``DistanceCache``, tenants and ``CacheStats`` on the CPU.

Twins of ``tests/test_cache.py`` (LRU eviction, TTL expiry, the lazy
sweep), ``tests/test_multitenant.py`` (per-tenant entries over one stream,
churn under eviction pressure, exact invalidation, admission rules; the
per-tenant answers also against the JAX package's frontend on the same
batches) and the cache parts of ``tests/test_obs.py`` (``CacheStats`` as
registry series, counting in an isolated registry).
"""
import numpy as np
import pytest
import torch

from conftest import make_clustered_points
from repro.core.matroid import MatroidSpec as JSpec
from repro.serve import diversity as jdiv
from repro_torch import obs
from repro_torch.core.matroid import MatroidSpec, PartitionMatroid
from repro_torch.serve.diversity import (
    CacheKey,
    CacheStats,
    DistanceCache,
    DiversityQuery,
    QueryFrontend,
    StreamRuntime,
)

CPU = "cpu"


def _key(tau):
    return CacheKey(spec=MatroidSpec("uniform"), tau=tau, metric="euclidean")


def _build(cache, key, fp=0, m=4):
    pts = np.arange(m * 2, dtype=np.float32).reshape(m, 2)
    cats = np.zeros((m, 1), np.int32)
    src = np.arange(m, dtype=np.int64)
    return cache.build(key, pts, cats, src, fp)


def _zeros(p):
    return np.zeros((p.shape[0],) * 2, np.float32)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _cache(**kw):
    return DistanceCache(build_fn=_zeros, device=CPU, **kw)


# --------------------------------------------------------------------------
# bounds (tests/test_cache.py)
# --------------------------------------------------------------------------


def test_lru_eviction_keeps_recently_used():
    clock = FakeClock()
    cache = _cache(max_entries=2, clock=clock)
    _build(cache, _key(1))
    clock.t = 1.0
    _build(cache, _key(2))
    clock.t = 2.0
    assert cache.lookup(_key(1), 0) is not None
    clock.t = 3.0
    _build(cache, _key(3))  # evicts the least recently used: key 2
    assert len(cache) == 2
    assert cache.stats.evictions == 1
    assert cache.lookup(_key(2), 0) is None
    assert cache.lookup(_key(1), 0) is not None
    assert cache.lookup(_key(3), 0) is not None


def test_ttl_sweeps_abandoned_keys_on_build():
    clock = FakeClock()
    cache = _cache(ttl_s=10.0, clock=clock)
    _build(cache, _key(1))
    clock.t = 20.0
    _build(cache, _key(2))
    assert len(cache) == 1
    assert cache.stats.expirations == 1
    assert cache.lookup(_key(2), 0) is not None


def test_ttl_expiry_forces_rebuild():
    clock = FakeClock()
    cache = _cache(ttl_s=10.0, clock=clock)
    _build(cache, _key(1))
    clock.t = 9.0
    assert cache.lookup(_key(1), 0) is not None
    clock.t = 11.0
    assert cache.lookup(_key(1), 0) is None
    assert cache.stats.expirations == 1
    assert len(cache) == 0
    _build(cache, _key(1))
    clock.t = 20.0
    assert cache.lookup(_key(1), 0) is not None


def test_unbounded_by_default_and_validation():
    cache = _cache()
    for tau in range(10):
        _build(cache, _key(tau))
    assert len(cache) == 10 and cache.stats.evictions == 0
    with pytest.raises(ValueError):
        DistanceCache(max_entries=0)


def test_sweep_is_lazy_deadline_gated():
    clock = FakeClock()
    cache = _cache(ttl_s=100.0, clock=clock)
    for i in range(20):
        clock.t = float(i)
        _build(cache, _key(i))
        cache.lookup(_key(i), 0)
    assert cache.stats.sweeps == 0, "swept before anything could expire"
    clock.t = 150.0
    _build(cache, _key(99))
    assert cache.stats.sweeps == 1
    assert cache.stats.expirations == 20
    assert len(cache) == 1
    plain = _cache(max_entries=2)
    for i in range(5):
        _build(plain, _key(i))
    assert plain.stats.sweeps == 0 and plain.stats.evictions == 3


def test_fingerprint_mismatch_still_invalidates():
    clock = FakeClock()
    cache = _cache(max_entries=4, ttl_s=100.0, clock=clock)
    _build(cache, _key(1), fp=7)
    assert cache.lookup(_key(1), 7) is not None
    assert cache.lookup(_key(1), 8) is None
    assert cache.stats.invalidations == 1


def test_default_build_is_k1_on_the_cache_device():
    """Without a build_fn the entry's D is ``coreset_distance_matrix`` on
    the cache's device (the plain pdist on the CPU), kept there, with the
    same values on the host."""
    from repro_torch.core.final_solve import coreset_distance_matrix

    cache = DistanceCache(device=CPU)
    pts = np.random.default_rng(0).normal(size=(9, 5)).astype(np.float32)
    e = cache.build(_key(1), torch.as_tensor(pts), np.zeros((9, 1), np.int32),
                    np.arange(9), 3)
    assert torch.is_tensor(e.D) and e.D.device.type == CPU
    assert np.array_equal(e.D_host, coreset_distance_matrix(pts, device=CPU))
    assert isinstance(e.points, np.ndarray) and np.array_equal(e.points, pts)
    assert e.size == 9


# --------------------------------------------------------------------------
# tenants over one stream (tests/test_multitenant.py)
# --------------------------------------------------------------------------


def _instance(rng, n=400, h=4, k=4):
    P = make_clustered_points(rng, n=n)
    cats = rng.integers(0, h, (n, 1)).astype(np.int32)
    caps = np.full(h, 2, np.int32)
    return P, cats, caps, ("partition", h, 1), k


def _four_tenants(fe, uniform):
    return [
        fe.default_tenant,
        fe.register_tenant("cosine", metric="cosine"),
        fe.register_tenant("tau-hi", tau=fe.runtime.tau * 2),
        fe.register_tenant("uniform", spec=uniform),
    ]


def test_tenant_fanout_isolated_entries_one_stream_as_reference(rng):
    P, cats, caps, sp, k = _instance(rng)
    # its own registry: the coalescer's counters below must count this
    # frontend's groups only, not those of every frontend in the process
    rt = StreamRuntime(MatroidSpec(*sp), k, tau=12, caps=caps, device=CPU,
                       registry=obs.MetricsRegistry())
    fe = QueryFrontend(rt)
    tenants = _four_tenants(fe, MatroidSpec("uniform"))
    jrt = jdiv.StreamRuntime(JSpec(*sp), k, tau=12, caps=caps)
    jfe = jdiv.QueryFrontend(jrt)
    _four_tenants(jfe, JSpec("uniform"))
    rt.ingest(P, cats)
    jrt.ingest(P, cats)
    res = {t.name: fe.query(DiversityQuery(k=k), tenant=t.name, engine="host")
           for t in tenants}
    for name, r in res.items():
        jr = jfe.query(DiversityQuery(k=k), tenant=name, engine="host")
        assert r.indices.tolist() == jr.indices.tolist(), name
        assert r.epoch == jr.epoch and r.coreset_size == jr.coreset_size
    assert len({t.key for t in tenants}) == 4
    assert len(fe.cache) == 4 and fe.cache.stats.builds == 4
    assert len({r.epoch for r in res.values()}) == 1
    assert {r.tenant for r in res.values()} == {t.name for t in tenants}
    e_def = fe.cache.lookup(tenants[0].key, rt.fingerprint)
    e_cos = fe.cache.lookup(tenants[1].key, rt.fingerprint)
    assert np.array_equal(e_def.src_idx, e_cos.src_idx)
    assert not np.allclose(e_def.points, e_cos.points)
    assert np.allclose(np.linalg.norm(e_cos.points, axis=1), 1.0, atol=1e-5)
    assert PartitionMatroid(cats[:, 0], caps).is_independent(
        list(res["default"].indices))
    builds = fe.cache.stats.builds
    for t in tenants:
        fe.query(DiversityQuery(k=k), tenant=t.name)
    assert fe.cache.stats.builds == builds
    st = fe.stats()
    assert st["cache"]["builds"] == builds
    assert st["tenants"] == sorted(t.name for t in tenants)
    # the frontend coalesces by default, as the reference's does; these
    # single-threaded queries all took the direct path
    assert st["coalesce"]["queue_depth"] == 0
    assert st["coalesce"]["groups"] == 0


def test_identical_keys_share_one_entry(rng):
    P, cats, caps, sp, k = _instance(rng)
    rt = StreamRuntime(MatroidSpec(*sp), k, tau=12, caps=caps, device=CPU)
    fe = QueryFrontend(rt)
    tight = fe.register_tenant("tight", caps=np.ones_like(caps))
    assert tight.key == fe.default_tenant.key
    rt.ingest(P, cats)
    r1 = fe.query(DiversityQuery(k=k))
    r2 = fe.query(DiversityQuery(k=k), tenant="tight")
    assert fe.cache.stats.builds == 1
    got = cats[r2.indices, 0]
    assert len(got) == len(set(got)), "tight tenant's caps=1 violated"
    assert len(set(r1.indices.tolist())) == k


def test_lru_ttl_interplay_under_eviction_pressure(rng):
    P, cats, caps, sp, k = _instance(rng)
    clock = FakeClock()
    cache = DistanceCache(max_entries=2, ttl_s=100.0, clock=clock,
                          device=CPU)
    rt = StreamRuntime(MatroidSpec(*sp), k, tau=12, caps=caps, device=CPU)
    fe = QueryFrontend(rt, cache=cache)
    tenants = _four_tenants(fe, MatroidSpec("uniform"))
    rt.ingest(P, cats)
    baseline = {}
    for r in range(3):
        for t in tenants:
            clock.t += 1.0
            res = fe.query(DiversityQuery(k=k), tenant=t.name)
            if r == 0:
                baseline[t.name] = res
            else:
                assert sorted(res.indices.tolist()) == sorted(
                    baseline[t.name].indices.tolist()), t.name
    assert len(cache) == 2
    assert cache.stats.evictions >= 8
    assert cache.stats.builds >= 10
    sweeps = cache.stats.sweeps
    clock.t += 200.0
    fe.query(DiversityQuery(k=k))
    assert cache.stats.expirations >= 2
    assert cache.stats.sweeps >= sweeps
    assert len(cache) == 1
    clock.t += 1.0
    fe.query(DiversityQuery(k=k), tenant="cosine")
    assert len(cache) == 2
    clock.t += 150.0
    ev = cache.stats.evictions
    fe.query(DiversityQuery(k=k), tenant="uniform")
    assert cache.stats.evictions == ev, "evicted a reclaimable entry"
    assert len(cache) == 1


def test_epoch_publication_invalidates_exactly_affected_entries(rng):
    P, cats, caps, sp, k = _instance(rng, n=600)
    spec = MatroidSpec(*sp)
    cache = DistanceCache(device=CPU)
    rt_a = StreamRuntime(spec, k, tau=12, caps=caps, device=CPU)
    rt_b = StreamRuntime(spec, k, tau=8, caps=caps, device=CPU)
    fe_a = QueryFrontend(rt_a, cache=cache)
    fe_b = QueryFrontend(rt_b, cache=cache)
    fe_a.register_tenant("cosine", metric="cosine")
    rt_a.ingest(P[:300], cats[:300])
    rt_b.ingest(P[:300], cats[:300])
    for fe, names in ((fe_a, ("default", "cosine")), (fe_b, ("default",))):
        for name in names:
            fe.query(DiversityQuery(k=k), tenant=name)
    assert cache.stats.builds == 3
    rep = rt_a.ingest(P[300:], cats[300:])
    shift = 1
    while not rep.coreset_changed and shift < 64:
        rep = rt_a.ingest(P[:100] + 10.0 * shift, cats[:100])
        shift *= 2
    assert rep.coreset_changed
    builds, inval = cache.stats.builds, cache.stats.invalidations
    ra = fe_a.query(DiversityQuery(k=k))
    ra2 = fe_a.query(DiversityQuery(k=k), tenant="cosine")
    assert cache.stats.builds == builds + 2
    assert cache.stats.invalidations == inval + 2
    assert ra.epoch == ra2.epoch == rt_a.latest().epoch
    hits = cache.stats.hits
    rb = fe_b.query(DiversityQuery(k=k))
    assert cache.stats.builds == builds + 2
    assert cache.stats.hits == hits + 1
    assert rb.from_cache


def test_tenant_registry_admission_rules(rng):
    _, _, caps, sp, k = _instance(rng, n=100)
    rt = StreamRuntime(MatroidSpec(*sp), k, tau=8, caps=caps, device=CPU)
    fe = QueryFrontend(rt)
    t = fe.register_tenant("cosine", metric="cosine")
    assert fe.register_tenant("cosine", metric="cosine") is t
    with pytest.raises(ValueError, match="different configuration"):
        fe.register_tenant("cosine", metric="euclidean")
    with pytest.raises(KeyError, match="unknown tenant"):
        fe.query(DiversityQuery(k=k), tenant="nope")
    with pytest.raises(ValueError, match="oracle"):
        fe.register_tenant("gen", spec=MatroidSpec("general"))
    inh = fe.register_tenant("inherit", tau=99)
    assert np.array_equal(inh.caps, rt.caps)
    fe_u = QueryFrontend(StreamRuntime(MatroidSpec("uniform"), k, tau=8,
                                       device=CPU))
    with pytest.raises(ValueError, match="caps"):
        fe_u.register_tenant(
            "capless",
            spec=MatroidSpec("partition", num_categories=4, gamma=1))
    fe_c = QueryFrontend(StreamRuntime(MatroidSpec("uniform"), k, tau=8,
                                       metric="cosine", device=CPU))
    with pytest.raises(ValueError, match="not\\s+derivable"):
        fe_c.register_tenant("euc", metric="euclidean")
    assert fe_c.register_tenant("cos2", metric="cosine").metric == "cosine"


# --------------------------------------------------------------------------
# CacheStats (tests/test_obs.py)
# --------------------------------------------------------------------------


def test_cache_stats_registry_backed():
    reg = obs.MetricsRegistry()
    s = CacheStats(reg, cache="t0")
    assert s.hits == 0 and s.misses == 0
    s.incr("hits")
    s.incr("builds", 2)
    assert s.hits == 1 and s.builds == 2
    assert s.snapshot() == {
        "hits": 1, "misses": 0, "builds": 2, "invalidations": 0,
        "evictions": 0, "expirations": 0, "sweeps": 0,
    }
    assert reg.snapshot()["serve.cache.builds{cache=t0}"]["value"] == 2
    with pytest.raises(AttributeError):
        s.nonexistent_field


def test_distance_cache_counts_in_isolated_registry():
    reg = obs.MetricsRegistry()
    cache = DistanceCache(registry=reg, device=CPU)
    key = ("spec", 1, "euclidean")
    assert cache.lookup(key, 7) is None
    pts = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    cache.build(key, pts, np.zeros((6, 1), np.int32), np.arange(6), 7)
    assert cache.lookup(key, 7) is not None
    assert (cache.stats.misses, cache.stats.builds, cache.stats.hits) == (
        1, 1, 1)
    other = DistanceCache(registry=reg, device=CPU)
    assert other.stats.misses == 0
