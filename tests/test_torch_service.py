"""The port's ``DiversityService`` on the CPU against the JAX package's.

The same numpy batches go through the reference service and the port's
(``device="cpu"``) on tie-free ``make_clustered_points`` data, for
partition, uniform and transversal matroids, one shard and three under
the ``vmap`` and ``pipeline`` placements. They must agree on the epoch
counts, the epoch triple ``(count, h1, h2)``, the scan state's discrete
fields, the snapshot's ``src_idx`` and the ``host`` and ``auto``
selections; floats within ``allclose(rtol=1e-5)``. The rest are the port's
twins of ``tests/test_service.py`` (its ahead-of-time compile cases
aside: eager PyTorch compiles nothing). The ``shard_map`` placement is
held to ``vmap`` in ``tests/test_torch_distributed.py``.
"""
import numpy as np
import pytest
import torch

from conftest import make_clustered_points
from repro.core import streaming as jstream
from repro.core.matroid import MatroidSpec as JSpec
from repro.serve import diversity as jdiv
from repro_torch.core import solve_dmmc, streaming
from repro_torch.core.compose import unstack_shards
from repro_torch.core.diversity import VARIANTS, diversity
from repro_torch.core.matroid import (
    MatroidSpec,
    PartitionMatroid,
    TransversalMatroid,
)
from repro_torch.core.solvers import CostModel
from repro_torch.serve.diversity import DiversityQuery, DiversityService
from repro_torch import obs

CPU = "cpu"
DISCRETE = ("n_seen", "cvalid", "dv", "dc", "ds", "overflow")


def _partition_instance(rng, n=400, h=4, k=4):
    P = make_clustered_points(rng, n=n)
    cats = rng.integers(0, h, (n, 1)).astype(np.int32)
    caps = np.full(h, 2, np.int32)
    spec = ("partition", h, 1)
    return P, cats, caps, spec, k


def _transversal_instance(rng, n=300, h=5, gamma=2, k=3):
    P = make_clustered_points(rng, n=n)
    cats = np.full((n, gamma), -1, np.int32)
    cats[:, 0] = rng.integers(0, h, n)
    extra = rng.random(n) < 0.4
    cats[extra, 1] = rng.integers(0, h, extra.sum())
    return P, cats, None, ("transversal", h, gamma), k


def _uniform_instance(rng, n=400, k=5):
    P = make_clustered_points(rng, n=n)
    return P, None, None, ("uniform", 0, 1), k


INSTANCES = {"partition": _partition_instance,
             "transversal": _transversal_instance,
             "uniform": _uniform_instance}


def _svc(sp, k, caps=None, **kw):
    return DiversityService(MatroidSpec(*sp), k, caps=caps, device=CPU, **kw)


def _jsvc(sp, k, caps=None, **kw):
    return jdiv.DiversityService(JSpec(*sp), k, caps=caps, **kw)


def _states(state):
    if isinstance(state, list):
        return state
    return [state]


def _assert_same_stream(svc, jsvc):
    """Scan states, epoch triple and counters equal across frameworks."""
    port, ref = _states(svc.state), _states(jsvc.state)
    assert len(port) == len(ref)
    for st, jst in zip(port, ref):
        got = streaming.state_to_arrays(st)
        want = jstream.state_to_arrays(jst)
        for f in DISCRETE + ("centers", "dp", "x1"):
            assert np.array_equal(got[f], want[f]), f"field {f} differs"
        np.testing.assert_allclose(got["R"], want["R"], rtol=1e-5)
        assert ([int(v) for v in streaming.epoch_stats(st)]
                == [int(v) for v in jstream.epoch_stats(jst)])
    assert svc.runtime.fingerprint == jsvc.runtime.fingerprint
    assert svc.n_offered == jsvc.n_offered


def _entry_matrix(s):
    e = s.cache.lookup(s.cache_key, s.runtime.fingerprint)
    return np.asarray(getattr(e, "D_host", e.D), np.float64)


def _value_without_diagonal(D, r):
    """An answer's value with the diagonal taken out: the frameworks'
    matmul-form pdist leave different cancellation noise there (up to
    ~1e-3 after the sqrt), which the sum and star values include."""
    sub = D[np.ix_(r.local_indices, r.local_indices)].copy()
    np.fill_diagonal(sub, 0.0)
    return diversity(sub, r.variant)


def _assert_same_answers(a, b, Da, Db, exact_order=False):
    for x, y in zip(a, b):
        if exact_order:
            assert x.indices.tolist() == y.indices.tolist()
        else:
            assert sorted(x.indices.tolist()) == sorted(y.indices.tolist())
        np.testing.assert_allclose(_value_without_diagonal(Da, x),
                                   _value_without_diagonal(Db, y), rtol=1e-5)
        assert x.coreset_size == y.coreset_size
        assert x.epoch == y.epoch


# --------------------------------------------------------------------------
# parity with the reference service
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [(1, "vmap"), (3, "vmap"),
                                    (3, "pipeline")],
                         ids=["1", "3-vmap", "3-pipeline"])
@pytest.mark.parametrize("kind", ["partition", "uniform", "transversal"])
def test_service_matches_reference(rng, kind, shards):
    S, placement = shards
    P, cats, caps, sp, k = INSTANCES[kind](rng)
    kw = dict(tau=10, num_shards=S, placement=placement, block_size=32)
    svc, jsvc = _svc(sp, k, caps, **kw), _jsvc(sp, k, caps, **kw)
    assert svc.placement == jsvc.placement == placement
    for off in range(0, P.shape[0], 97):
        c = None if cats is None else cats[off:off + 97]
        r, jr = svc.ingest(P[off:off + 97], c), jsvc.ingest(P[off:off + 97], c)
        assert (r.n, r.total, r.coreset_size, r.coreset_changed) == (
            jr.n, jr.total, jr.coreset_size, jr.coreset_changed)
    _assert_same_stream(svc, jsvc)
    pts, cts, src = svc.snapshot()
    jpts, jcts, jsrc = jsvc.snapshot()
    assert np.array_equal(src, jsrc) and np.array_equal(cts, jcts)
    np.testing.assert_allclose(pts, jpts, rtol=1e-5, atol=1e-6)
    qs = [DiversityQuery(k=k), DiversityQuery(k=max(2, k - 1)),
          DiversityQuery(k=k, gamma=0.01)]
    host, jhost = (s.query_batch(qs, engine="host") for s in (svc, jsvc))
    D, jD = _entry_matrix(svc), _entry_matrix(jsvc)
    _assert_same_answers(host, jhost, D, jD, exact_order=True)
    auto, jauto = (s.query_batch(qs) for s in (svc, jsvc))
    _assert_same_answers(auto, jauto, D, jD)
    _assert_same_answers(auto, host, D, D)
    for s in (svc, jsvc):
        assert s.runtime.epochs_published == 1
    assert svc.frontend.stats()["epoch"] == jsvc.frontend.stats()["epoch"]


@pytest.mark.parametrize("block_size", [1, 7, 64, 256])
def test_incremental_ingestion_matches_one_shot(rng, block_size):
    """Batched == one-shot, and every blocked scan == the per-point scan."""
    P, cats, caps, sp, k = _partition_instance(rng)
    spec = MatroidSpec(*sp)
    n, d = P.shape
    tau = 12
    _, st1 = streaming.stream_coreset(P, cats, np.ones(n, bool), spec, caps,
                                      k, tau, block_size=1, device=CPU)
    st = streaming.init_stream_state(d, 1, spec, k, tau, device=CPU)
    off = 0
    for b in (100, 37, 163, 100):
        st = streaming.ingest_batch(
            st, P[off:off + b], cats[off:off + b], np.ones(b, bool), spec,
            caps, k, tau, base_index=off, block_size=block_size)
        off += b
    for f in streaming.StreamState._fields:
        assert torch.equal(getattr(st1, f), getattr(st, f)), f


def test_service_snapshot_matches_offline_coreset(rng):
    P, cats, caps, sp, k = _partition_instance(rng)
    tau = 12
    svc = _svc(sp, k, caps, tau=tau)
    for off in range(0, P.shape[0], 128):
        svc.ingest(P[off:off + 128], cats[off:off + 128])
    sol = solve_dmmc(P, k, MatroidSpec(*sp), cats=cats, caps=caps, tau=tau,
                     setting="streaming", device=CPU)
    _, _, src = svc.snapshot()
    assert np.array_equal(src, sol.coreset_indices)


# --------------------------------------------------------------------------
# sharded ingestion
# --------------------------------------------------------------------------


def test_sharded_service_matches_per_shard_streams(rng):
    P, cats, caps, sp, k = _partition_instance(rng)
    spec = MatroidSpec(*sp)
    n = P.shape[0]
    tau, S = 12, 3
    svc = _svc(sp, k, caps, tau=tau, num_shards=S, block_size=32,
               placement="vmap")
    for off in range(0, n, 150):
        svc.ingest(P[off:off + 150], cats[off:off + 150])
    union_src = []
    for s, shard_st in enumerate(unstack_shards(svc.state)):
        rows = np.arange(s, n, S)
        st = streaming.init_stream_state(P.shape[1], 1, spec, k, tau,
                                         device=CPU)
        st = streaming.ingest_batch(st, P[rows], cats[rows],
                                    np.ones(len(rows), bool), spec, caps, k,
                                    tau, src=rows)
        for f in st._fields:
            assert torch.equal(getattr(st, f), getattr(shard_st, f)), (s, f)
        cs = streaming.snapshot_coreset(st)
        union_src.append(cs.src_idx[cs.valid].numpy())
    _, _, src = svc.snapshot()
    assert np.array_equal(src, np.concatenate(union_src))


def test_sharded_service_quality_and_cache(rng):
    P, cats, caps, sp, k = _partition_instance(rng, n=600)
    svc1 = _svc(sp, k, caps, tau=12)
    svc4 = _svc(sp, k, caps, tau=12, num_shards=4, block_size=32)
    svc1.ingest(P, cats)
    svc4.ingest(P, cats)
    r1 = svc1.query(DiversityQuery(k=k))
    r4 = svc4.query(DiversityQuery(k=k))
    assert r4.diversity >= 0.8 * r1.diversity
    assert r4.coreset_size >= r1.coreset_size
    assert PartitionMatroid(cats[:, 0], caps).is_independent(list(r4.indices))
    builds = svc4.cache.stats.builds
    pts_c, cats_c, _ = svc4.snapshot()
    rep = svc4.ingest(pts_c[:1], cats_c[:1])
    svc4.query(DiversityQuery(k=k))
    assert svc4.cache.stats.builds == builds + (1 if rep.coreset_changed
                                                else 0)


def test_sharded_ingest_requires_multiple_shards(rng):
    P, cats, caps, sp, k = _partition_instance(rng, n=50)
    svc = _svc(sp, k, caps, tau=8)
    with pytest.raises(ValueError):
        svc.ingest_sharded(P, cats)
    with pytest.raises(ValueError):
        svc.ingest_pipeline(P, cats)
    with pytest.raises(ValueError):
        _svc(sp, k, caps, tau=8, num_shards=0)
    pipe = _svc(sp, k, caps, tau=8, num_shards=2, placement="pipeline")
    with pytest.raises(ValueError, match="pipeline"):
        pipe.ingest_sharded(P, cats)
    with pytest.raises(ValueError):
        _svc(sp, k, caps, tau=8, num_shards=2, placement="nope")


def test_placement_resolution(rng):
    _, _, caps, sp, k = _partition_instance(rng, n=50)
    for pl in ("vmap", "pipeline"):
        assert _svc(sp, k, caps, tau=8, num_shards=2,
                    placement=pl).placement == pl
    # the CPU resolves auto as the reference does there
    assert _svc(sp, k, caps, tau=8, num_shards=2).placement == "pipeline"
    assert _svc(sp, k, caps, tau=8).placement == "vmap"


def test_pipeline_placement_matches_per_batch_streams(rng):
    P, cats, caps, sp, k = _partition_instance(rng)
    spec = MatroidSpec(*sp)
    n, batch, tau, S = P.shape[0], 100, 12, 2
    svc = _svc(sp, k, caps, tau=tau, num_shards=S, block_size=32,
               placement="pipeline")
    for off in range(0, n, batch):
        svc.ingest(P[off:off + batch], cats[off:off + batch])
    assert isinstance(svc.state, list) and len(svc.state) == S
    union_src = []
    for s in range(S):
        st = streaming.init_stream_state(P.shape[1], 1, spec, k, tau,
                                         device=CPU)
        for bi, off in enumerate(range(0, n, batch)):
            if bi % S != s:
                continue
            m = min(batch, n - off)
            pad = -m % 32
            pts = np.concatenate(
                [P[off:off + m], np.zeros((pad, P.shape[1]), np.float32)])
            ca = np.concatenate(
                [cats[off:off + m], np.full((pad, 1), -1, np.int32)])
            st = streaming.ingest_batch(
                st, pts, ca, np.arange(m + pad) < m, spec, caps, k, tau,
                base_index=off, block_size=32)
        for f in st._fields:
            assert torch.equal(getattr(st, f), getattr(svc.state[s], f)), f
        cs = streaming.snapshot_coreset(st)
        union_src.append(cs.src_idx[cs.valid].numpy())
    _, _, src = svc.snapshot()
    assert np.array_equal(src, np.concatenate(union_src))
    r = svc.query(DiversityQuery(k=k))
    assert PartitionMatroid(cats[:, 0], caps).is_independent(list(r.indices))


def test_warmup_is_a_noop_and_primes_the_cache(rng):
    """warmup() leaves the stream as it was, builds the default tenant's
    matrix once, and the first real query then hits it; on the CPU it
    builds no kernel library."""
    P, cats, caps, sp, k = _partition_instance(rng, n=300)
    svc = _svc(sp, k, caps, tau=12)
    with pytest.raises(ValueError):
        svc.warmup()  # no state yet and no dimension given
    watch = obs.RecompileWatch()
    try:
        rep = svc.warmup(d=P.shape[1], ingest_sizes=(300,))
        assert "kernels" not in rep and watch.total() == 0
    finally:
        watch.close()
    assert any(key.startswith("ingest[") for key in rep)
    assert rep["queries"].startswith("skipped")
    assert svc.n_offered == 0
    svc.ingest(P, cats)
    rep2 = svc.warmup(ks=(k,), query_batch_sizes=(1,))
    assert f"query[sum k={k} b=1]" in rep2
    fp, builds = svc._fingerprint, svc.cache.stats.builds
    assert builds == 1
    res = svc.query(DiversityQuery(k=k))
    assert res.from_cache and svc.cache.stats.builds == builds
    assert svc._fingerprint == fp
    ref = _svc(sp, k, caps, tau=12)
    ref.ingest(P, cats)
    r2 = ref.query(DiversityQuery(k=k))
    assert res.indices.tolist() == r2.indices.tolist()
    assert res.diversity == r2.diversity


@pytest.mark.parametrize("placement", ["vmap", "pipeline"])
def test_warmup_sharded_states_unchanged(rng, placement):
    P, cats, caps, sp, k = _partition_instance(rng, n=200)
    svc = _svc(sp, k, caps, tau=12, num_shards=2, block_size=32,
               placement=placement)
    svc.ingest(P[:100], cats[:100])
    before = svc.snapshot()
    svc.warmup(ingest_sizes=(100,), ks=(k,))
    after = svc.snapshot()
    for a, b in zip(before, after):
        assert np.array_equal(a, b)
    svc.ingest(P[100:], cats[100:])


# --------------------------------------------------------------------------
# service/offline parity: indices AND value
# --------------------------------------------------------------------------


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("instance", ["partition", "transversal"])
def test_service_matches_solve_dmmc(rng, instance, variant):
    if instance == "partition":
        P, cats, caps, sp, k = _partition_instance(rng, n=300)
    else:
        P, cats, caps, sp, k = _transversal_instance(rng)
    tau = 10
    svc = _svc(sp, k, caps, tau=tau)
    for off in range(0, P.shape[0], 97):
        svc.ingest(P[off:off + 97], cats[off:off + 97])
    sol = solve_dmmc(P, k, MatroidSpec(*sp), cats=cats, caps=caps, tau=tau,
                     setting="streaming", variant=variant, device=CPU)
    res = svc.query(DiversityQuery(k=k, variant=variant), engine="host")
    assert res.indices.tolist() == sol.indices.tolist()
    assert res.diversity == sol.diversity
    assert res.coreset_size == sol.coreset_size
    auto = svc.query(DiversityQuery(k=k, variant=variant))
    assert sorted(auto.indices.tolist()) == sorted(res.indices.tolist())
    assert auto.diversity == res.diversity


def test_vmap_engine_matches_host(rng):
    P, cats, caps, sp, k = _partition_instance(rng, n=500, h=5, k=5)
    svc = _svc(sp, k, caps, tau=16)
    svc.ingest(P, cats)
    qs = [
        DiversityQuery(k=kk, caps=cc, allowed_cats=ac)
        for kk in (2, 3, 5)
        for cc in (None, (1,) * 5)
        for ac in (None, frozenset({0, 1, 2, 3}))
    ]
    hosts = svc.query_batch(qs, engine="host")
    vmaps = svc.query_batch(qs, engine="vmap")  # alias of jit_sum
    for q, a, b in zip(qs, hosts, vmaps):
        assert sorted(a.indices.tolist()) == sorted(b.indices.tolist()), q
        assert b.diversity == a.diversity
        assert a.engine == "host_local_search" and b.engine == "jit_sum"


class _FrozenCostModel(CostModel):
    """The seeds' estimates, never refined: routing does not depend on
    how long a solve took."""

    def observe(self, *args, **kwargs) -> None:
        return None


def test_query_default_engine_consistency(rng):
    """query() and query_batch([q]) share the engine="auto" default and
    route alike; a frozen cost model keeps the wall clock out of it."""
    P, cats, caps, sp, k = _partition_instance(rng, n=300)
    svc = _svc(sp, k, caps, tau=12, cost_model=_FrozenCostModel())
    svc.ingest(P, cats)
    q = DiversityQuery(k=k)
    one = svc.query(q)
    batch = svc.query_batch([q])[0]
    assert one.engine == batch.engine
    assert one.engine in ("jit_sum", "host_local_search")
    assert one.indices.tolist() == batch.indices.tolist()
    assert one.diversity == batch.diversity


def test_uniform_vmap_engine(rng):
    P = make_clustered_points(rng, n=400)
    svc = _svc(("uniform", 0, 1), 6, tau=12)
    svc.ingest(P)
    a = svc.query(DiversityQuery(k=6), engine="host")
    b = svc.query(DiversityQuery(k=6), engine="vmap")
    assert sorted(a.indices.tolist()) == sorted(b.indices.tolist())


def test_query_respects_caps_and_filters(rng):
    P, cats, caps, sp, k = _partition_instance(rng, n=400, h=4, k=4)
    svc = _svc(sp, k, caps, tau=12)
    svc.ingest(P, cats)
    for engine in ("host", "vmap"):
        r = svc.query(DiversityQuery(k=4, caps=(1, 1, 1, 1)), engine=engine)
        got = cats[r.indices, 0]
        assert len(got) == len(set(got)), f"caps=1 violated ({engine})"
        r2 = svc.query(DiversityQuery(k=3, allowed_cats=frozenset({0, 1})),
                       engine=engine)
        assert set(cats[r2.indices, 0]) <= {0, 1}, engine
    r3 = svc.query(DiversityQuery(k=4))
    assert PartitionMatroid(cats[:, 0], caps).is_independent(list(r3.indices))


def test_transversal_batch_independent(rng):
    P, cats, _, sp, k = _transversal_instance(rng)
    svc = _svc(sp, k, tau=10)
    svc.ingest(P, cats)
    m = TransversalMatroid(cats, sp[1])
    qs = [DiversityQuery(k=kk) for kk in (2, 3)]
    auto = svc.query_batch(qs)
    hosts = svc.query_batch(qs, engine="host")
    for r, hr in zip(auto, hosts):
        assert m.is_independent(list(r.indices))
        assert r.engine in ("jit_sum", "host_local_search")
        assert hr.engine == "host_local_search"
        assert sorted(r.indices.tolist()) == sorted(hr.indices.tolist())
        assert r.diversity == hr.diversity


def test_transversal_star_tree_hint_engines(rng):
    P, cats, _, sp, k = _transversal_instance(rng)
    svc = _svc(sp, k, tau=10)
    svc.ingest(P, cats)
    m = TransversalMatroid(cats, sp[1])
    for variant in ("star", "tree"):
        exact = svc.query(DiversityQuery(k=3, variant=variant))
        fast = svc.query(
            DiversityQuery(k=3, variant=variant, engine_hint="jit_greedy"))
        assert exact.engine == "host_exhaustive"
        assert fast.engine == "jit_greedy"
        assert m.is_independent(list(fast.indices))
        assert fast.diversity <= exact.diversity + 1e-9
        r = svc.query(DiversityQuery(k=3, engine_hint="jit_greedy"))
        assert r.engine in ("jit_sum", "host_local_search")


# --------------------------------------------------------------------------
# cache discipline
# --------------------------------------------------------------------------


def test_warm_batch_of_32_reuses_cached_matrix(rng):
    P, cats, caps, sp, k = _partition_instance(rng, n=500, h=4, k=5)
    svc = _svc(sp, k, caps, tau=16)
    svc.ingest(P, cats)
    svc.query(DiversityQuery(k=k))
    assert svc.cache.stats.builds == 1
    qs = [
        DiversityQuery(
            k=2 + i % 4,
            variant="sum" if i % 3 else "tree",
            caps=None if i % 2 else (1,) * 4,
            allowed_cats=None if i % 5 else frozenset({0, 1, 2}),
        )
        for i in range(32)
    ]
    out = svc.query_batch(qs)
    assert len(out) == 32 and all(r.from_cache for r in out)
    assert svc.cache.stats.builds == 1, "warm batch recomputed pdist"
    assert "host_exhaustive" in {r.engine for r in out}
    assert all(r.engine in ("jit_sum", "host_local_search")
               for r in out if r.variant == "sum")
    assert sorted({len(r.indices) for r in out if r.variant == "sum"}) == [
        2, 3, 4, 5]


def test_cache_invalidated_only_on_coreset_change(rng):
    P, cats, caps, sp, k = _partition_instance(rng, n=300)
    svc = _svc(sp, k, caps, tau=12)
    rep = svc.ingest(P[:250], cats[:250])
    assert rep.coreset_changed
    svc.query(DiversityQuery(k=k))
    assert svc.cache.stats.builds == 1
    rep2 = svc.ingest(P[250:], cats[250:])
    svc.query(DiversityQuery(k=k))
    expected = 2 if rep2.coreset_changed else 1
    assert svc.cache.stats.builds == expected
    pts_c, cats_c, _ = svc.snapshot()
    rep3 = svc.ingest(pts_c[:1], cats_c[:1])
    svc.query(DiversityQuery(k=k))
    assert svc.cache.stats.builds == expected + int(rep3.coreset_changed)
    assert svc.n_offered == 301


def test_cache_entry_matrix_on_the_runtime_device(rng):
    """The entry's D is a tensor on the runtime's device, its host copy
    the same values, and both equal the reference entry's matrix."""
    P, cats, caps, sp, k = _partition_instance(rng, n=300)
    svc, jsvc = _svc(sp, k, caps, tau=12), _jsvc(sp, k, caps, tau=12)
    for s in (svc, jsvc):
        s.ingest(P, cats)
        s.query(DiversityQuery(k=k))
    e = svc.cache.lookup(svc.cache_key, svc.runtime.fingerprint)
    je = jsvc.cache.lookup(jsvc.cache_key, jsvc.runtime.fingerprint)
    assert torch.is_tensor(e.D) and e.D.device.type == CPU
    assert np.array_equal(e.D.numpy(), e.D_host)
    assert np.array_equal(e.src_idx, je.src_idx)
    # squared distances within the pdist margin (1e-5 x the largest
    # squared norm): the matmul form's cancellation noise, the diagonal's
    # included, differs between the frameworks
    margin = 1e-5 * float(np.max(np.sum(e.points.astype(np.float64) ** 2,
                                        axis=1)))
    d2, jd2 = e.D_host.astype(np.float64) ** 2, np.asarray(je.D,
                                                           np.float64) ** 2
    assert np.max(np.abs(d2 - jd2)) <= margin
    assert np.max(np.diag(d2)) <= margin


def test_ingest_reports(rng):
    P, cats, caps, sp, k = _partition_instance(rng, n=200)
    svc = _svc(sp, k, caps, tau=10)
    r1 = svc.ingest(P[:120], cats[:120])
    r2 = svc.ingest(P[120:], cats[120:])
    assert (r1.n, r2.n) == (120, 80)
    assert r2.total == 200 and r2.coreset_size > 0
    with pytest.raises(ValueError):
        _svc(("general", 0, 1), k, tau=10)
    with pytest.raises(ValueError):
        _svc(sp, k, tau=10)  # partition without caps


# --------------------------------------------------------------------------
# what waits for later steps raises, naming the step; the card by default
# --------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["durability", "coalesce", "restore",
                                  "shard_map"])
def test_later_steps_raise_not_implemented(rng, tmp_path, what):
    """Step 10 (durability, coalescing, restore) and step 11 (the
    ``shard_map`` placement) are ported and no longer raise."""
    P, cats, caps, sp, k = _partition_instance(rng, n=50)
    if what == "shard_map":
        svc = _svc(sp, k, caps, tau=8, num_shards=2, placement="shard_map")
        assert svc.runtime.placement == "shard_map"
        svc.ingest(P, cats)
        assert svc.query(DiversityQuery(k=k)).indices.size == k
        svc.close()
    elif what == "durability":
        svc = _svc(sp, k, caps, tau=8, durability=str(tmp_path))
        svc.ingest(P, cats)
        assert svc.runtime._applied_seq == 0
        svc.close()
    elif what == "coalesce":
        svc = _svc(sp, k, caps, tau=8)
        assert svc.frontend.coalescer is not None  # on by default
        svc.close()
    else:
        svc = _svc(sp, k, caps, tau=8, durability=str(tmp_path))
        svc.ingest(P, cats)
        svc.close()  # the parting checkpoint holds the config
        back = DiversityService.restore(str(tmp_path), device=CPU)
        assert back.runtime.n_offered == P.shape[0]
        back.close()
        with pytest.raises(ValueError, match="WAL-only"):
            DiversityService.restore(str(tmp_path / "empty"), device=CPU)
    # a disabled coalescer is the direct path
    svc = _svc(sp, k, caps, tau=8,
               coalesce=jdiv.CoalesceConfig(enabled=False))
    assert svc.frontend.coalescer is None


def test_service_defaults_to_the_card(rng):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default runs there")
    _, _, caps, sp, k = _partition_instance(rng, n=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiversityService(MatroidSpec(*sp), k, tau=8, caps=caps)


def test_deadline_degrades_exact_to_greedy(rng):
    """Admission reads the latency histograms and the cost model, not the
    clock: a taught host_exhaustive over the budget degrades star/tree to
    jit_greedy, and nothing fitting sheds."""
    P, cats, _, sp, k = _transversal_instance(rng)
    reg = obs.MetricsRegistry()
    svc = _svc(sp, k, tau=10, registry=reg, cost_model=_FrozenCostModel())
    svc.ingest(P, cats)
    fe = svc.frontend
    reg.histogram("serve.solve.latency_s", tenant="default",
                  engine="host_exhaustive").observe(300.0)
    res = fe.query_batch([DiversityQuery(k=3, variant="star"),
                          DiversityQuery(k=3, variant="tree")],
                         deadline_s=60.0)
    assert all(r.degraded and r.engine == "jit_greedy" for r in res)
    assert all(not r.shed and len(r.indices) == 3 for r in res)
    assert reg.counter("serve.query.degraded", tenant="default").value == 2
    assert fe.query(DiversityQuery(k=3, variant="star")).engine == (
        "host_exhaustive")
    for eng in ("jit_greedy", "jit_sum", "host_local_search"):
        reg.histogram("serve.solve.latency_s", tenant="default",
                      engine=eng).observe(300.0)
    shed = fe.query_batch([DiversityQuery(k=k),
                           DiversityQuery(k=3, variant="star")],
                          deadline_s=60.0)
    assert all(r.shed and r.engine == "shed" and len(r.indices) == 0
               for r in shed)
    assert reg.counter("serve.query.shed", tenant="default").value == 2
