"""Contracts of the port's observability layer, ``repro_torch.obs``.

Twins of the ``tests/test_obs.py`` tests that need no serving stack:
registry semantics, log-bucket histogram geometry (equal to the
reference's on the same observations), the tracer-leak guard (inside a
``torch.compile`` trace here; CUDA-graph capture is a card test in
``tests/test_torch_cuda.py``), span export, the ring buffer, and the
recompile watch over the port's compile events (dynamo frames, nvcc
builds, Triton specialisations).
"""
import json
import math
import sys
import threading
import types

import numpy as np
import pytest
import torch
from torch._dynamo.comptime import comptime

from repro import obs as jobs
from repro_torch import obs
from repro_torch.core.solvers.jit_sum import bucket_pow2
from repro_torch.kernels import _build, gmm_step
from repro_torch.obs.metrics import bucket_index, bucket_lo


# ---------------------------------------------------------------------------
# registry + histogram geometry
# ---------------------------------------------------------------------------


def test_registry_series_identity_and_labels():
    reg = obs.MetricsRegistry()
    a = reg.counter("req", tenant="a")
    b = reg.counter("req", tenant="b")
    assert a is reg.counter("req", tenant="a")  # get-or-create
    assert a is not b
    a.inc(3)
    b.inc()
    snap = reg.snapshot()
    assert snap["req{tenant=a}"]["value"] == 3
    assert snap["req{tenant=b}"]["value"] == 1
    c = reg.gauge("g", x="1", y="2")
    assert c is reg.gauge("g", y="2", x="1")
    with pytest.raises(TypeError):
        reg.histogram("req", tenant="a")


def test_histogram_log2_bucket_boundaries():
    for i in (1, 5, 30, 60):
        edge = 2.0 ** (i - 30)
        assert bucket_index(edge) == i
        assert bucket_index(np.nextafter(edge, 0.0)) == i - 1
        assert bucket_index(bucket_lo(i)) == i
        assert bucket_lo(i) / bucket_lo(i - 1) == 2.0
    idx = [bucket_index(1e-8 * 1.9 ** j) for j in range(16)]
    assert idx == sorted(idx)
    assert bucket_index(0.0) == 0
    assert bucket_index(-1.0) == 0
    assert bucket_index(1e30) == 95


def test_histogram_quantiles_within_bucket_resolution():
    reg = obs.MetricsRegistry()
    h = reg.histogram("lat")
    vals = [0.001 * (1 + i % 7) for i in range(1000)]
    for v in vals:
        h.observe(v)
    d = h.describe()
    assert d["count"] == 1000
    assert d["min"] == pytest.approx(min(vals))
    assert d["max"] == pytest.approx(max(vals))
    assert d["sum"] == pytest.approx(sum(vals))
    for q, true in ((0.5, np.quantile(vals, 0.5)),
                    (0.95, np.quantile(vals, 0.95))):
        got = h.quantile(q)
        assert true / 2 <= got <= true * 2
        assert d["min"] <= got <= d["max"]
    h1 = reg.histogram("one")
    h1.observe(0.0042)
    assert h1.quantile(0.5) == pytest.approx(0.0042)


def test_histogram_equals_reference_on_same_observations():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.lognormal(-7, 2, 500), [0.0, -1.0, 1e30]])
    mine = obs.MetricsRegistry().histogram("lat", tenant="t")
    ref = jobs.MetricsRegistry().histogram("lat", tenant="t")
    for v in vals:
        mine.observe(float(v))
        ref.observe(float(v))
    assert mine.describe() == ref.describe()
    for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
        assert mine.quantile(q) == ref.quantile(q)
    assert [bucket_index(float(v)) for v in vals] == [
        jobs.metrics.bucket_index(float(v)) for v in vals]


def test_registry_reset_and_disable():
    reg = obs.MetricsRegistry()
    c = reg.counter("n")
    h = reg.histogram("h")
    c.inc(5)
    h.observe(1.0)
    reg.reset()
    assert c.value == 0 and h.count == 0
    assert reg.counter("n") is c  # handles survive reset
    reg.enabled = False
    c.inc()
    h.observe(1.0)
    assert c.value == 0 and h.count == 0  # disabled ops are no-ops


def test_write_jsonl(tmp_path):
    reg = obs.MetricsRegistry()
    reg.counter("a", engine="x").inc(2)
    reg.histogram("b").observe(0.5)
    p = tmp_path / "metrics.jsonl"
    reg.write_jsonl(str(p))
    recs = [json.loads(line) for line in p.read_text().splitlines()]
    by_series = {r["series"]: r for r in recs}
    assert by_series["a{engine=x}"]["value"] == 2
    assert by_series["a{engine=x}"]["labels"] == {"engine": "x"}
    assert by_series["b"]["count"] == 1


# ---------------------------------------------------------------------------
# tracer-leak guard
# ---------------------------------------------------------------------------


def test_metric_mutation_inside_compile_trace_raises():
    torch._dynamo.reset()
    reg = obs.MetricsRegistry()
    c = reg.counter("leaked")
    h = reg.histogram("leaked_h")

    @torch.compile(backend="eager")
    def f(x):
        c.inc()
        return x * 2

    with pytest.raises(obs.TracerLeakError):
        f(torch.ones(3))
    assert c.value == 0  # the trace-time call never landed

    @torch.compile(backend="eager")
    def g(x):
        h.observe(0.1)
        return x

    with pytest.raises(obs.TracerLeakError):
        g(torch.ones(3))
    assert h.count == 0
    c.inc()  # eager: host-side as ever
    assert c.value == 1


def test_span_inside_compile_trace_raises():
    torch._dynamo.reset()
    buf = obs.TraceBuffer(capacity=16)

    @torch.compile(backend="eager")
    def f(x):
        with buf.span("inside"):
            return x + 1

    with pytest.raises(obs.TracerLeakError):
        f(torch.ones(3))
    assert buf.drain() == []


def test_guard_is_thread_local():
    """A worker thread mutating metrics while ANOTHER thread traces must
    not trip the guard: dynamo's tracing state is per thread."""
    torch._dynamo.reset()
    reg = obs.MetricsRegistry()
    c = reg.counter("worker_side")
    errs = []
    go = threading.Event()
    done = threading.Event()

    def worker():
        go.wait(5.0)
        try:
            c.inc()
        except Exception as e:  # pragma: no cover - the failure mode
            errs.append(e)
        done.set()

    def while_tracing(_ctx):
        go.set()
        done.wait(5.0)  # the worker increments WHILE this trace is active

    th = threading.Thread(target=worker, daemon=True)
    th.start()

    @torch.compile(backend="eager")
    def f(x):
        comptime(while_tracing)
        return x

    f(torch.ones(2))
    th.join(5.0)
    assert not th.is_alive()
    assert not errs and c.value == 1


def test_guard_outside_capture_on_this_host():
    """Without a capture (and on a CPU-only build, where the capture
    query itself raises) every host-side operation goes through."""
    obs.assert_host_side("probe")
    reg = obs.MetricsRegistry()
    reg.counter("c").inc()
    reg.gauge("g").set(2.0)
    assert reg.snapshot()["c"]["value"] == 1


# ---------------------------------------------------------------------------
# tracing: spans, IDs, export
# ---------------------------------------------------------------------------


def test_trace_ids_nest_and_resume():
    buf = obs.TraceBuffer(capacity=16)
    with obs.trace() as tid:
        with obs.trace() as inner:
            assert inner == tid  # nested calls join the caller's trace
        with buf.span("a"):
            pass
    assert obs.current_trace_id() is None
    seen = []

    def other_thread():
        with obs.resume_trace(tid):
            with buf.span("b"):
                seen.append(obs.current_trace_id())

    th = threading.Thread(target=other_thread)
    th.start()
    th.join(5.0)
    assert not th.is_alive() and seen == [tid]
    spans = {s.name: s for s in buf.drain()}
    assert spans["a"].trace_id == spans["b"].trace_id == tid
    assert spans["a"].tid != spans["b"].tid


def test_chrome_trace_export(tmp_path):
    buf = obs.TraceBuffer(capacity=8)
    with buf.span("outer", cat="test", n=3):
        with buf.span("inner", cat="test"):
            pass
    p = tmp_path / "trace.json"
    buf.dump(str(p))
    doc = json.loads(p.read_text())
    evs = doc["traceEvents"]
    assert [e["name"] for e in evs] == ["outer", "inner"]
    for e in evs:
        assert e["ph"] == "X" and e["dur"] >= 0 and "pid" in e
    outer, inner = evs
    assert outer["ts"] <= inner["ts"]
    assert outer["ts"] + outer["dur"] >= inner["ts"] + inner["dur"]
    assert evs[0]["args"]["n"] == 3


def test_ring_buffer_overwrites_oldest():
    buf = obs.TraceBuffer(capacity=4)
    for i in range(10):
        with buf.span(f"s{i}"):
            pass
    got = [s.name for s in buf.drain()]
    assert got == ["s6", "s7", "s8", "s9"]


# ---------------------------------------------------------------------------
# recompile watch over the port's compile events
# ---------------------------------------------------------------------------


def test_recompile_counter_exact_across_pow2_buckets():
    torch._dynamo.reset()
    watch = obs.RecompileWatch()
    try:
        @torch.compile(backend="eager", dynamic=False)
        def f(x):
            return torch.sum(x * 2.0)

        def call(n):
            b = bucket_pow2(n)
            x = torch.zeros((b,))
            with obs.compile_region(f"test[b={b}]"):
                f(x)
            return b

        watch.reset()
        for n in (5, 6, 8):  # one bucket: exactly ONE dynamo compile
            assert call(n) == 8
        assert watch.by_key().get("test[b=8]", 0) == 1
        assert call(9) == 16
        assert watch.by_key().get("test[b=16]", 0) == 1
        before = watch.total()
        call(7)
        call(16)
        assert watch.total() == before
        assert watch.by_source() == {"dynamo": 2}
    finally:
        watch.close()


def test_recompile_watch_windows_and_unattributed():
    torch._dynamo.reset()
    watch = obs.RecompileWatch()
    try:
        @torch.compile(backend="eager")
        def g(x):
            return x + 1

        x = torch.zeros(3)
        with obs.compile_region("win[a]"):
            g(x)
        assert watch.by_key().get("win[a]") == 1
        assert watch.seconds_by_key()["win[a]"] > 0
        watch.reset()  # a fresh measurement window
        with obs.compile_region("win[a]"):
            g(x)  # cached: no event
        assert watch.total() == 0

        @torch.compile(backend="eager")
        def h(x):
            return x - 1

        h(x)  # no active region
        assert watch.by_key().get(obs.UNATTRIBUTED, 0) >= 1
        assert watch.total(include_unattributed=False) == 0
    finally:
        watch.close()


def test_nvcc_build_is_a_compile_event_only_on_a_cache_miss(
        tmp_path, monkeypatch):
    """``_build.library`` reports one ``nvcc`` event when it runs the
    compiler, attributed to the active region, and none when the hashed
    library is already on disk."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "ctypes",
                        types.SimpleNamespace(CDLL=lambda path: path))
    monkeypatch.setattr(_build, "_libs", {})
    watch = obs.RecompileWatch()
    try:
        with obs.compile_region("build[fake]"):
            lib = _build.library("fake")
        assert lib.endswith(".so")
        assert watch.by_key() == {"build[fake]": 1}
        assert watch.by_source() == {"nvcc": 1}
        _build._libs.clear()  # a new process: the library is on disk
        _build.library("fake")
        assert watch.total() == 1
    finally:
        watch.close()


def test_triton_cache_size_reads_both_layouts():
    """K2's first-compile probe counts a JITFunction's cached kernels in
    Triton's two cache layouts (``device_caches`` from 3.2, ``cache``
    before)."""
    new = types.SimpleNamespace(device_caches={
        0: ({"k1": 1, "k2": 2}, "target", "backend", "binder"),
        1: ({"k3": 3}, "target", "backend", "binder"),
    })
    old = types.SimpleNamespace(cache={0: {"k1": 1}, 1: {}})
    assert gmm_step._cached_kernels(new) == 3
    assert gmm_step._cached_kernels(old) == 1
    assert gmm_step._cached_kernels(types.SimpleNamespace()) == 0


def test_profiler_trace_is_opt_in(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_OBS_PROFILE", raising=False)
    with obs.profiler_trace(str(tmp_path)) as on:
        torch.ones(3) + 1
    assert on is False and list(tmp_path.iterdir()) == []
    with obs.profiler_trace(str(tmp_path), enabled=True) as on:
        torch.ones(3) + 1
    assert on is True
    (trace,) = tmp_path.iterdir()
    assert "traceEvents" in json.loads(trace.read_text())
    env_dir = tmp_path / "env"
    monkeypatch.setenv("REPRO_OBS_PROFILE", str(env_dir))
    with obs.profiler_trace() as on:
        pass
    assert on is True and len(list(env_dir.iterdir())) == 1


def test_named_scope_labels_profiler_events():
    with torch.profiler.profile() as prof:
        with obs.named_scope("solver/jit_sum"):
            torch.ones(4) * 2
    assert any(e.name == "solver/jit_sum" for e in prof.events())


# ---------------------------------------------------------------------------
# module-level conveniences
# ---------------------------------------------------------------------------


def test_set_enabled_toggles_default_registry_and_buffer():
    obs.set_enabled(False)
    try:
        c = obs.counter("toggle_test")
        v0 = c.value
        c.inc()
        assert c.value == v0  # disabled
        buf = obs.default_buffer()
        n0 = len(buf.drain())
        with obs.span("toggle_span"):
            pass
        assert len(buf.drain()) == n0
    finally:
        obs.set_enabled(True)
    c = obs.counter("toggle_test")
    c.inc()
    assert c.value >= 1


def test_observability_report_shape():
    rep = obs.observability_report(obs.MetricsRegistry())
    assert set(rep) == {
        "metrics", "recompiles_by_key", "recompile_seconds_by_key"
    }
    assert set(rep) == set(jobs.observability_report(jobs.MetricsRegistry()))
    assert math.isfinite(len(rep["metrics"]))
