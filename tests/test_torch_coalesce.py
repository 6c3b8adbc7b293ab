"""Micro-batch coalescing in the port's query frontend, on the CPU.

Twins of the coalescer cases of ``tests/test_coalesce.py`` (from
``test_concurrent_multitenant_parity`` on; the cost-model cases above them
are twinned in ``tests/test_torch_stacked_solve.py``): coalesced answers
equal the direct per-call path across tenants, engines, hints and k
buckets, a solo caller bypasses the window, deadlines cap the window and
degrade or shed per caller, ``min_epoch`` groups never merge, the
cross-tenant stacked wave, the adaptive window on a fake clock, per-tenant
FIFO, ``close``/``drain`` and the failover re-dispatch. The answers are
also held to the JAX package's frontend on the same batches (the selected
indices; values within allclose). Waits are bounded polls on the
coalescer's own counters, not sleeps.
"""
import threading
import time
import zlib

import numpy as np
import pytest

from conftest import make_clustered_points
from repro.core.matroid import MatroidSpec as JSpec
from repro.serve import diversity as jdiv
from repro_torch import obs
from repro_torch.core.diversity import diversity
from repro_torch.core.matroid import MatroidSpec
from repro_torch.core.solvers import CostModel
from repro_torch.serve.diversity import (
    CoalesceConfig,
    DiversityQuery,
    QueryFrontend,
    StreamRuntime,
)
from repro_torch.serve.diversity.coalesce import AdaptiveWindow, Coalescer

CPU = "cpu"


def _data(rng, n):
    P = make_clustered_points(rng, n=n)
    cats = rng.integers(0, 4, (n, 1)).astype(np.int32)
    return P, cats


def _frontend(rng, reg, *, coalesce=None, n=300, tau=24):
    spec = MatroidSpec("partition", num_categories=4, gamma=1)
    caps = np.full(4, 3, np.int32)
    rt = StreamRuntime(spec, 5, tau=tau, caps=caps, registry=reg,
                       device=CPU)
    fe = QueryFrontend(rt, registry=reg, coalesce=coalesce)
    P, cats = _data(rng, n)
    rt.ingest(P, cats)
    return rt, fe


def _jfrontend(seed, n=300, tau=24):
    """The JAX package's frontend over the same points (seeded as
    ``_frontend``'s)."""
    caps = np.full(4, 3, np.int32)
    rt = jdiv.StreamRuntime(JSpec("partition", num_categories=4, gamma=1),
                            5, tau=tau, caps=caps)
    fe = jdiv.QueryFrontend(rt, coalesce=jdiv.CoalesceConfig(enabled=False))
    P, cats = _data(np.random.default_rng(seed), n)
    rt.ingest(P, cats)
    return rt, fe


def _entry_matrix(fe, tenant):
    """The tenant's matrix on the newest epoch, on the host (the port's
    ``D_host``, the reference's ``D``)."""
    e = fe.cache.lookup(fe.tenants.get(tenant).key,
                        fe.runtime.latest().fingerprint)
    return np.asarray(getattr(e, "D_host", e.D), np.float64)


def _value_without_diagonal(D, r):
    """An answer's value with the diagonal out: the frameworks'
    matmul-form pdist leave different cancellation noise there, which the
    sum and star values include (as in ``tests/test_torch_service.py``)."""
    sub = D[np.ix_(r.local_indices, r.local_indices)].copy()
    np.fill_diagonal(sub, 0.0)
    return diversity(sub, r.variant)


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not met in time"
        time.sleep(0.002)


def _mixed_calls():
    """(tenant, queries): tenants, ks across pow-2 buckets, engine hints
    and category filters."""
    return [
        ("default", [DiversityQuery(k=2), DiversityQuery(k=5)]),
        ("default", [DiversityQuery(k=3, allowed_cats=frozenset({0, 1, 2}))]),
        ("uniform", [DiversityQuery(k=8)]),
        ("uniform", [DiversityQuery(k=4, variant="star",
                                    engine_hint="jit_greedy")]),
        ("default", [DiversityQuery(k=4, caps=(1, 1, 1, 1))]),
        ("uniform", [DiversityQuery(k=2), DiversityQuery(k=7),
                     DiversityQuery(k=3)]),
    ]


def _assert_same(a, b):
    assert a.indices.tolist() == b.indices.tolist()
    assert a.local_indices.tolist() == b.local_indices.tolist()
    assert a.diversity == b.diversity  # exact float equality
    assert a.epoch == b.epoch
    assert a.tenant == b.tenant
    assert not a.degraded and not a.shed


def _concurrently(fe, calls, **kw):
    """Every call from its own thread, released together by a barrier."""
    results = [None] * len(calls)
    barrier = threading.Barrier(len(calls))

    def worker(i, t, qs):
        barrier.wait()
        results[i] = fe.query_batch(qs, tenant=t, **kw)

    threads = [threading.Thread(target=worker, args=(i, t, qs))
               for i, (t, qs) in enumerate(calls)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120.0)
        assert not th.is_alive()
    return results


def test_coalescing_is_on_by_default(rng):
    """``coalesce=None`` means ``CoalesceConfig()``, as in the reference."""
    reg = obs.MetricsRegistry()
    rt, fe = _frontend(rng, reg, n=80, tau=12)
    assert fe.coalescer is not None
    assert fe.coalescer.config == CoalesceConfig()
    assert fe.coalescer.config.enabled
    off = QueryFrontend(rt, registry=reg,
                        coalesce=CoalesceConfig(enabled=False))
    assert off.coalescer is None and off.stats()["coalesce"] is None
    fe.close()
    off.close()
    rt.close()


def test_concurrent_multitenant_parity(rng):
    """Coalesced answers equal the direct per-call path across tenants,
    engines, hints and k buckets, and select what the JAX package's
    direct path selects."""
    reg = obs.MetricsRegistry()
    rt, fe = _frontend(rng, reg, coalesce=CoalesceConfig(window_s=0.02))
    fe.register_tenant("uniform", spec=MatroidSpec("uniform"))
    calls = _mixed_calls()
    baseline = [fe._query_batch_direct(list(qs), tenant=fe.tenants.get(t))
                for t, qs in calls]
    for _round in range(3):
        for got, want in zip(_concurrently(fe, calls), baseline):
            for a, b in zip(got, want):
                _assert_same(a, b)
    assert reg.counter("serve.coalesce.coalesced").value >= 2
    jrt, jfe = _jfrontend(0)
    jfe.register_tenant("uniform", spec=JSpec("uniform"))
    for (t, qs), got in zip(calls, baseline):
        D = _entry_matrix(fe, t)
        for a, b in zip(jfe.query_batch(qs, tenant=t), got):
            assert sorted(a.indices.tolist()) == sorted(b.indices.tolist())
            np.testing.assert_allclose(
                _value_without_diagonal(_entry_matrix(jfe, t), a),
                _value_without_diagonal(D, b), rtol=1e-5)
    jrt.close()
    fe.close()
    rt.close()


@pytest.mark.parametrize("engine", ["host", "jit_sum"])
def test_forced_engine_parity_under_concurrency(rng, engine):
    reg = obs.MetricsRegistry()
    rt, fe = _frontend(rng, reg, coalesce=CoalesceConfig(window_s=0.02))
    qs = [DiversityQuery(k=3), DiversityQuery(k=5)]
    want = fe._query_batch_direct(list(qs), tenant=None, engine=engine)
    for got in _concurrently(fe, [("default", qs)] * 6, engine=engine):
        for a, b in zip(got, want):
            _assert_same(a, b)
            assert a.engine == b.engine  # forced engine honored
    fe.close()
    rt.close()


def test_solo_caller_bypasses_window(rng):
    """A single-threaded caller never enters the window: the solo counter
    counts it and no group forms."""
    reg = obs.MetricsRegistry()
    rt, fe = _frontend(rng, reg, coalesce=CoalesceConfig(window_s=5.0))
    for _ in range(3):
        fe.query(DiversityQuery(k=4))
    assert reg.counter("serve.coalesce.solo").value == 3
    assert reg.counter("serve.coalesce.coalesced").value == 0
    assert reg.counter("serve.coalesce.groups").value == 0
    assert fe.coalescer.backlog == 0
    fe.close()
    rt.close()


class _Tenant:
    name = "default"


def test_deadline_bounds_window_wait():
    """A caller's time in the window is capped at deadline_window_frac of
    its budget, whatever window_s says: the 60 s fixed window dispatches
    well inside the 2 s deadline."""

    class _FakeFrontend:
        def __init__(self):
            self.registry = obs.MetricsRegistry()

        def active_calls(self):
            return 1_000_000  # never triggers the early close

        def _solve_coalesced(self, calls):
            now = time.perf_counter()
            for c in calls:
                c.results = now

    co = Coalescer(_FakeFrontend(),
                   CoalesceConfig(window_s=60.0, adaptive=False))
    try:
        t0 = time.perf_counter()
        dispatched_at = co.submit(
            _Tenant(), [DiversityQuery(k=2)], engine="auto",
            min_epoch=None, deadline_s=2.0,
        )
        # budget 2 s x frac 0.25 = 0.5 s in the window, not 60 s
        assert dispatched_at - t0 < 2.0
    finally:
        co.close()


def test_deadline_degrade_shed_through_coalescer(rng):
    """Concurrent deadline callers each get per-caller degrade/shed."""
    reg = obs.MetricsRegistry()
    rt, fe = _frontend(rng, reg, coalesce=CoalesceConfig(window_s=0.05))
    fe.query(DiversityQuery(k=4, variant="star", engine_hint="jit_greedy"))
    for eng in ("host_exhaustive", "jit_greedy", "jit_sum",
                "host_local_search"):
        reg.histogram("serve.solve.latency_s", tenant="default",
                      engine=eng).observe(300.0)
    deadline_s = 60.0
    calls = [("default", [DiversityQuery(k=4, variant="star")])] * 6
    for (r,) in _concurrently(fe, calls, deadline_s=deadline_s):
        assert r.shed and r.engine == "shed"  # nothing fits the budget
        assert len(r.indices) == 0
    assert reg.counter("serve.query.shed", tenant="default").value == 6
    ok = fe.query(DiversityQuery(k=5))
    assert not ok.shed and len(ok.indices) == 5
    fe.close()
    rt.close()


def test_min_epoch_not_merged_across_values(rng):
    """Calls with different min_epoch never share an epoch acquire."""
    reg = obs.MetricsRegistry()
    rt, fe = _frontend(rng, reg, coalesce=CoalesceConfig(window_s=0.05))
    e0 = fe.flush()
    P2, cats2 = _data(np.random.default_rng(7), 64)
    rt.submit(P2, cats2)
    e1 = fe.flush()
    assert e1 > e0
    results = [None, None]
    barrier = threading.Barrier(2)

    def worker(i, min_epoch):
        barrier.wait()
        results[i] = fe.query(DiversityQuery(k=4), min_epoch=min_epoch)

    threads = [threading.Thread(target=worker, args=(0, None)),
               threading.Thread(target=worker, args=(1, e1))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60.0)
    assert results[1].epoch >= e1
    assert results[0].epoch >= e0
    fe.close()
    rt.close()


def test_stats_tenant_traffic_and_coalesce_sections(rng):
    reg = obs.MetricsRegistry()
    rt, fe = _frontend(rng, reg, coalesce=CoalesceConfig(window_s=0.02))
    fe.register_tenant("uniform", spec=MatroidSpec("uniform"))
    fe.query_batch([DiversityQuery(k=3)] * 4)
    fe.query(DiversityQuery(k=4), tenant="uniform")
    st = fe.stats()
    tt = st["tenant_traffic"]
    assert tt["default"]["requests"] == 1
    assert tt["default"]["queries"] == 4
    assert tt["uniform"]["requests"] == 1
    assert tt["uniform"]["queries"] == 1
    assert tt["default"]["in_flight"] == 0.0
    assert tt["default"]["qps"] > 0.0
    assert fe.stats()["tenant_traffic"]["default"]["qps"] == 0.0
    assert st["coalesce"]["queue_depth"] == 0
    assert st["active_calls"] == 0
    assert st["cost_model"]["decisions"]
    assert all("estimates" in d for d in st["cost_model"]["decisions"])
    fe.close()
    rt.close()


def test_frontend_close_idempotent_and_coalescer_refuses_after(rng):
    reg = obs.MetricsRegistry()
    rt, fe = _frontend(rng, reg, n=80, tau=12)
    fe.query(DiversityQuery(k=3))
    co = fe.coalescer
    fe.close()
    fe.close()  # idempotent
    with pytest.raises(RuntimeError):
        co.submit(fe.default_tenant, [DiversityQuery(k=3)], engine="auto",
                  min_epoch=None, deadline_s=None)
    rt.close()


class _FrozenCostModel(CostModel):
    """The seeds' estimates, never refined: routing does not depend on
    how long a solve took."""

    def observe(self, *args, **kwargs) -> None:
        return None


class _OneWindowRounds:
    """Makes each round of concurrent calls one window, however late a
    loaded host schedules a thread: the round's unfinished calls count as
    active from its start (so the window's early close waits for every
    one of them to park), and a caller that took the solo path is held
    until the others are parked (so at most one call is solo: while it is
    inside the frontend every later call sees another active caller)."""

    def __init__(self, fe):
        self.fe = fe
        self.pending = 0
        self.mu = threading.Lock()
        real_active, real_direct = fe.active_calls, fe._query_batch_direct

        def active_calls():
            return max(real_active(), self.pending)

        def direct(*args, **kwargs):
            if self.pending:
                _wait(lambda: fe.coalescer.parked >= self.pending - 1)
            return real_direct(*args, **kwargs)

        fe.active_calls = active_calls
        fe._query_batch_direct = direct

    def run(self, calls):
        self.pending = len(calls)

        def call(t, qs):
            try:
                return self.fe.query_batch(qs, tenant=t)
            finally:
                with self.mu:
                    self.pending -= 1

        return _concurrently(_Caller(call), calls)


class _Caller:
    """``_concurrently``'s frontend: ``query_batch`` through ``fn``."""

    def __init__(self, fn):
        self.fn = fn

    def query_batch(self, qs, tenant):
        return self.fn(tenant, qs)


def test_cross_tenant_stacked_parity_through_frontend(rng):
    """A mixed multi-tenant window executes as stacked cross-tenant solves
    and every answer equals the direct per-tenant path. dispatchers=1
    keeps window assembly deterministic; each round is one window
    (``_OneWindowRounds``, a fixed window that only the early close ends)
    and the cost model is frozen, so which lanes stack does not depend on
    the host's load."""
    reg = obs.MetricsRegistry()
    spec = MatroidSpec("partition", num_categories=4, gamma=1)
    rt = StreamRuntime(spec, 5, tau=24, caps=np.full(4, 3, np.int32),
                       registry=reg, device=CPU)
    fe = QueryFrontend(rt, registry=reg, cost_model=_FrozenCostModel(),
                       coalesce=CoalesceConfig(window_s=10.0, adaptive=False,
                                               dispatchers=1))
    rt.ingest(*_data(rng, 300))
    fe.register_tenant("uniform", spec=MatroidSpec("uniform"))
    fe.register_tenant("uniform2", spec=MatroidSpec("uniform"))
    fe.register_tenant("part2", spec=MatroidSpec("partition",
                                                 num_categories=4, gamma=1))
    calls = [
        ("default", [DiversityQuery(k=2), DiversityQuery(k=5)]),
        ("uniform", [DiversityQuery(k=8)]),
        ("uniform2", [DiversityQuery(k=3), DiversityQuery(k=4)]),
        ("part2", [DiversityQuery(k=4, caps=(1, 1, 1, 1))]),
        ("default", [DiversityQuery(k=3,
                                    allowed_cats=frozenset({0, 1, 2}))]),
        ("uniform", [DiversityQuery(k=4, variant="star",
                                    engine_hint="jit_greedy")]),
    ]
    baseline = [fe._query_batch_direct(list(qs), tenant=fe.tenants.get(t))
                for t, qs in calls]
    rounds = _OneWindowRounds(fe)
    for _round in range(3):
        for got, want in zip(rounds.run(calls), baseline):
            for a, b in zip(got, want):
                _assert_same(a, b)
    assert reg.counter("serve.coalesce.stacked_solves").value >= 1
    assert reg.counter("serve.coalesce.stacked_rows").value >= 2
    assert fe.stats()["coalesce"]["stacked_solves"] >= 1
    fe.close()
    rt.close()


# --------------------------------------------------------------------------
# the adaptive window, on a fake clock
# --------------------------------------------------------------------------


def _ticking_window(cfg):
    clk = [0.0]
    return clk, AdaptiveWindow(cfg, clock=lambda: clk[0])


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_adaptive_window_widens_under_queue_growth(impl):
    """The port's controller, and the reference's on the same clock ticks,
    give the same windows."""
    cfg = CoalesceConfig(window_s=3e-4, window_min_s=1e-4, window_max_s=2e-3)
    clk = [0.0]
    if impl == "port":
        w = AdaptiveWindow(cfg, clock=lambda: clk[0])
    else:
        w = jdiv.coalesce.AdaptiveWindow(
            jdiv.CoalesceConfig(window_s=3e-4, window_min_s=1e-4,
                                window_max_s=2e-3),
            clock=lambda: clk[0])
    for _ in range(50):
        clk[0] += 1e-4
        w.observe_arrival()
    w.observe_solve(5e-4)
    base = w.current(backlog=0)
    assert base == pytest.approx(5e-4, rel=1e-6)  # Little target = S
    wide = w.current(backlog=16)
    assert base < wide <= cfg.window_max_s
    assert w.current(backlog=10_000) == cfg.window_max_s  # clamped
    snap = w.snapshot()
    assert snap["rate_hz"] == pytest.approx(1e4, rel=0.2)
    assert len(snap["trace"]) >= 3
    assert snap["trace"][-1][1] == cfg.window_max_s


def test_adaptive_window_collapses_when_idle():
    cfg = CoalesceConfig(window_min_s=1e-4, window_max_s=2e-3)
    clk, w = _ticking_window(cfg)
    assert w.current(backlog=0) == 0.0  # cold start: no companion
    for _ in range(50):
        clk[0] += 1e-4
        w.observe_arrival()
    assert w.current(backlog=0) > 0.0
    clk[0] += 10.0  # silence decays the rate
    assert w.current(backlog=0) == 0.0
    clk2, w2 = _ticking_window(cfg)
    for _ in range(10):
        clk2[0] += 1.0
        w2.observe_arrival()
    assert w2.current(backlog=0) == 0.0  # 1 Hz can't fill 2 ms


def test_adaptive_window_fixed_mode_and_bad_observations():
    cfg = CoalesceConfig(window_s=7e-4, adaptive=False)
    _clk, w = _ticking_window(cfg)
    assert w.current(backlog=0) == 7e-4
    assert w.current(backlog=1_000) == 7e-4
    w.observe_solve(float("nan"))
    w.observe_solve(-1.0)
    assert w.snapshot()["solve_est_s"] is None


# --------------------------------------------------------------------------
# the dispatcher pool: FIFO, close/drain, failover re-dispatch
# --------------------------------------------------------------------------


class _T:
    def __init__(self, name):
        self.name = name


class _PoolFakeFrontend:
    """Records execution order; optionally blocks every solve until
    ``release`` is set. ``solving`` counts calls inside a solve."""

    def __init__(self, block=False):
        self.registry = obs.MetricsRegistry()
        self.order = []
        self.mu = threading.Lock()
        self.solving = 0
        self.release = threading.Event()
        if not block:
            self.release.set()

    def active_calls(self):
        return 1_000_000  # never triggers the early close

    def _solve_coalesced(self, calls):
        self._solve_coalesced_stacked([calls])

    def _solve_coalesced_stacked(self, subs):
        with self.mu:
            self.solving += sum(len(sub) for sub in subs)
        assert self.release.wait(timeout=60.0)
        with self.mu:
            for sub in subs:
                for c in sub:
                    self.order.extend(c.queries)
                    c.results = list(c.queries)


def _shard_distinct_names(n_shards, n_names):
    """Tenant names covering ``n_shards`` distinct shards."""
    names, seen = [], set()
    i = 0
    while len(names) < n_names:
        name = f"tn{i}"
        i += 1
        shard = zlib.crc32(name.encode()) % n_shards
        if len(seen) < n_shards and shard in seen and \
                n_names - len(names) <= n_shards - len(seen):
            continue
        seen.add(shard)
        names.append(name)
    assert len(seen) == n_shards
    return names


def _submit_thread(co, tenant, queries, **kw):
    kw.setdefault("engine", "auto")
    th = threading.Thread(target=co.submit, args=(tenant, queries),
                          kwargs=dict(min_epoch=None, deadline_s=None, **kw))
    th.start()
    return th


def test_per_tenant_fifo_under_dispatcher_pool():
    """Same tenant, same shard; windows assemble FIFO; the busy set
    forbids two executors on one tenant. Each call is parked before the
    next is submitted, so the submission order is the enqueue order."""
    fe = _PoolFakeFrontend()
    co = Coalescer(fe, CoalesceConfig(window_s=0.01, adaptive=False,
                                      dispatchers=3))
    try:
        names = _shard_distinct_names(3, 3)
        tenants = {n: _T(n) for n in names}
        threads, sent = [], 0
        for i in range(6):
            for n in names:
                threads.append(_submit_thread(co, tenants[n], [f"{n}:{i}"]))
                sent += 1
                _wait(lambda: co.parked + len(fe.order) >= sent)
        for th in threads:
            th.join(timeout=30.0)
            assert not th.is_alive()
        for n in names:
            got = [q for q in fe.order if q.startswith(f"{n}:")]
            assert got == [f"{n}:{i}" for i in range(6)], (n, got)
    finally:
        co.close()


def _block_every_dispatcher(co, fake, tenants, call, tag):
    """One call a shard, each submitted once the previous one's dispatcher
    is blocked in its solve: every dispatcher ends up blocked, none holding
    another shard's call."""
    threads = []
    for t in tenants:
        th = threading.Thread(target=call, args=(t, f"{tag}-{t.name}"))
        th.start()
        threads.append(th)
        n = len(threads)
        _wait(lambda: fake.solving >= n)
    return threads


def test_close_fails_queued_calls_on_every_shard_loudly():
    """close() with dispatchers mid-solve: in-flight groups complete,
    queued calls on every shard fail with the close error, none hang."""
    fe = _PoolFakeFrontend(block=True)
    co = Coalescer(fe, CoalesceConfig(window_s=0.02, adaptive=False,
                                      dispatchers=3))
    names = _shard_distinct_names(3, 6)
    tenants = [_T(n) for n in names]
    outcomes = {}
    omu = threading.Lock()

    def call(t, tag):
        try:
            r = co.submit(t, [tag], engine="auto", min_epoch=None,
                          deadline_s=None)
            with omu:
                outcomes[tag] = ("ok", r)
        except RuntimeError as e:
            with omu:
                outcomes[tag] = ("err", str(e))

    first = _block_every_dispatcher(co, fe, tenants[:3], call, "first")
    second = [threading.Thread(target=call, args=(t, f"second-{t.name}"))
              for t in tenants]
    for th in second:
        th.start()
    _wait(lambda: co.backlog == len(tenants))  # queued behind the solves
    closer = threading.Thread(target=co.close)
    closer.start()
    _wait(lambda: co.backlog == 0)  # close took the queued calls
    fe.release.set()
    closer.join(timeout=30.0)
    assert not closer.is_alive()
    for th in first + second:
        th.join(timeout=30.0)
        assert not th.is_alive()  # none hang
    assert len(outcomes) == 9
    for t in tenants[:3]:
        assert outcomes[f"first-{t.name}"][0] == "ok"
    for t in tenants:
        kind, detail = outcomes[f"second-{t.name}"]
        assert kind == "err" and "closed" in detail, (t.name, detail)
    co.close()  # idempotent


def test_failover_redispatch_drains_all_dispatchers(rng):
    """drain() hands back the queued calls of every shard un-failed, and
    adopt_pending on another frontend re-dispatches the multi-tenant set
    as one stacked wave, releasing every caller with real answers."""
    reg = obs.MetricsRegistry()
    rt, fe = _frontend(rng, reg)
    names = _shard_distinct_names(2, 2)
    for n in names:
        fe.register_tenant(n, spec=MatroidSpec("uniform"))
    fake = _PoolFakeFrontend(block=True)
    co = Coalescer(fake, CoalesceConfig(window_s=0.02, adaptive=False,
                                        dispatchers=2))
    results = {}
    rmu = threading.Lock()

    def call(name, tag, k):
        # forced jit_sum: the adoption wave goes through the stacked path
        r = co.submit(fe.tenants.get(name), [DiversityQuery(k=k)],
                      engine="jit_sum", min_epoch=None, deadline_s=None)
        with rmu:
            results[tag] = r

    first = _block_every_dispatcher(
        co, fake, [fe.tenants.get(n) for n in names],
        lambda t, tag: call(t.name, tag, 3), "first")
    second = [threading.Thread(target=call, args=(n, f"second-{n}", 4))
              for n in names]
    for th in second:
        th.start()
    _wait(lambda: co.backlog == 2)  # one queued call per shard
    drained = co.drain()
    assert sorted(c.tenant.name for c in drained) == sorted(names)
    assert co.backlog == 0
    stacked_before = reg.counter("serve.coalesce.stacked_solves").value
    assert fe.adopt_pending(drained) == len(drained)
    assert reg.counter("serve.coalesce.stacked_solves").value > \
        stacked_before
    fake.release.set()
    for th in first + second:
        th.join(timeout=30.0)
        assert not th.is_alive()
    for n in names:
        want = fe._query_batch_direct([DiversityQuery(k=4)],
                                      tenant=fe.tenants.get(n),
                                      engine="jit_sum")
        _assert_same(results[f"second-{n}"][0], want[0])
    co.close()
    fe.close()
    rt.close()


def test_pool_stats_aggregate_across_dispatchers(rng):
    reg = obs.MetricsRegistry()
    rt, fe = _frontend(rng, reg,
                       coalesce=CoalesceConfig(window_s=0.02, dispatchers=2))
    fe.register_tenant("uniform", spec=MatroidSpec("uniform"))
    calls = [("default" if i % 2 else "uniform", [DiversityQuery(k=3)])
             for i in range(4)]
    _concurrently(fe, calls)
    st = fe.stats()["coalesce"]
    assert st["dispatchers"] == 2
    assert set(st["per_dispatcher"]) == {"d0", "d1"}
    assert st["groups"] == sum(d["groups"]
                               for d in st["per_dispatcher"].values())
    assert st["queue_depth"] == 0
    assert reg.gauge("serve.coalesce.backlog").value == 0
    assert st["adaptive"] is True
    assert "trace" in st["window"]
    fe.close()
    rt.close()
