"""Thread-safe metrics registry for the serving stack.

Reference: ``repro/obs/metrics.py``, copied except for the tracer-leak
guard's probe: the reference asks ``jax.core.trace_state_clean`` (absent
from jax 0.9, so its guard never trips); here the guard trips inside a
``torch.compile`` trace and during CUDA-graph capture (see
``assert_host_side``).

Three instrument kinds, all host-side, all O(1) memory per series:

* ``Counter``    monotonically increasing int (``inc``);
* ``Gauge``      last-write-wins float (``set``/``inc``/``dec``);
* ``Histogram``  bounded log2-bucket distribution — 96 fixed buckets
                 spanning ``[1e-9, 1e-9 * 2**96)`` (sub-nanosecond to
                 ~10**19), so any latency/size this stack can produce
                 lands in a bucket without ever allocating. Quantiles
                 (p50/p95/p99) are read off the bucket boundaries with
                 at most one-bucket (2x) resolution error — the right
                 trade for a registry that must never grow under load.

Series are keyed by ``(name, sorted labels)``: the same call site can fan
out per tenant/engine/placement without pre-declaring anything
(``registry.counter("serve.query.requests", tenant="cosine")``). Snapshot
and JSONL/stdout exporters render a series as ``name{k=v,...}``.

Concurrency model: instrument *creation* takes the registry lock once;
every mutation takes only that instrument's own lock (a few tens of ns —
traced and captured code never holds or waits on any of these, because
it is forbidden from calling in at all, see below). Reads (``value``,
``snapshot``) are lock-free and may observe a mid-update tear across
fields of one histogram — fine for monitoring, never corrupting.

Tracer-leak guard: every mutating operation asserts it is running as real
host Python, not inside a trace. A metric call that lands in a
``torch.compile`` graph, or in a captured CUDA graph, would execute once
while tracing or capturing and never again on replay — the worst kind of
observability bug (a counter that reads 1 forever). The guard turns that
into a loud ``TracerLeakError`` at trace or capture time. Disabling a
registry (``enabled=False``) short-circuits mutations *before* the guard,
so a disabled registry is a couple of attribute loads per call — that is
the A/B the serve bench measures as ``obs_overhead``.
"""
from __future__ import annotations

import json
import math
import sys
import threading
from typing import Optional

import torch


class TracerLeakError(RuntimeError):
    """A host-side metric mutation was attempted inside a trace."""


class _CompileTraceLeak(TracerLeakError, AssertionError):
    """The guard's error when raised while dynamo traces. Dynamo rewraps
    most exceptions raised at trace time as ``InternalTorchDynamoError``
    but lets ``AssertionError`` through, so callers catch a
    ``TracerLeakError`` either way."""


def _raise_in_compile_trace(_ctx=None) -> None:
    raise _CompileTraceLeak(
        "metric operation called inside a torch.compile trace; "
        "observability is host-side only — move the call outside the "
        "compiled function (torch.profiler.record_function is the "
        "in-trace annotation)"
    )


_cuda_present: Optional[bool] = None


def _capturing() -> bool:
    """True while this thread's current CUDA stream is capturing a graph.
    Asked only where CUDA is available: on a CPU-only build the capture
    query raises."""
    global _cuda_present
    if _cuda_present is None:
        _cuda_present = torch.cuda.is_available()
    return _cuda_present and torch.cuda.is_current_stream_capturing()


def assert_host_side(what: str) -> None:
    """Raise ``TracerLeakError`` inside a ``torch.compile`` trace or during
    CUDA-graph capture on this thread. Host-side observability must never
    leak into traced or captured code: it would run once and never again.

    Under dynamo, ``torch.compiler.is_compiling()`` is True only while
    tracing, and a plain ``raise`` there would make dynamo fall back to
    eager and run the call anyway; ``comptime`` runs the raise at trace
    time instead, so the trace fails."""
    if torch.compiler.is_compiling():
        from torch._dynamo.comptime import comptime

        comptime(_raise_in_compile_trace)
    if _capturing():
        raise TracerLeakError(
            f"metric operation {what!r} called during CUDA-graph capture; "
            "observability is host-side only — move the call outside the "
            "captured region"
        )


def series_key(name: str, labels: tuple) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class _Instrument:
    kind = "?"

    def __init__(self, registry: "MetricsRegistry", name: str, labels: tuple):
        self._registry = registry
        self.name = name
        self.labels = labels
        self.key = series_key(name, labels)
        self._mu = threading.Lock()

    def _on(self, what: str) -> bool:
        """Shared mutation preamble: disabled -> no-op, traced -> raise."""
        if not self._registry.enabled:
            return False
        assert_host_side(what)
        return True

    def describe(self) -> dict:
        raise NotImplementedError


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._n = 0

    def inc(self, n: int = 1) -> None:
        if not self._on(self.key):
            return
        with self._mu:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._mu:
            self._n = 0

    def describe(self) -> dict:
        return {"type": "counter", "value": self._n}


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._v = 0.0

    def set(self, v: float) -> None:
        if not self._on(self.key):
            return
        with self._mu:
            self._v = float(v)

    def inc(self, dv: float = 1.0) -> None:
        if not self._on(self.key):
            return
        with self._mu:
            self._v += dv

    def dec(self, dv: float = 1.0) -> None:
        self.inc(-dv)

    @property
    def value(self) -> float:
        return self._v

    def reset(self) -> None:
        with self._mu:
            self._v = 0.0

    def describe(self) -> dict:
        return {"type": "gauge", "value": self._v}


# log2 histogram geometry: bucket i spans [LO * 2**i, LO * 2**(i+1))
_HIST_LO = 1e-9
_HIST_NB = 96
# frexp(LO) = (0.5..., -29): cache the exponent offset once
_HIST_E0 = math.frexp(_HIST_LO)[1]


def bucket_index(v: float) -> int:
    """Bucket of value ``v`` (values <= LO clamp to 0, huge clamp to last)."""
    if v <= _HIST_LO:
        return 0
    e = math.frexp(v)[1] - _HIST_E0
    return min(_HIST_NB - 1, max(0, e))


def bucket_lo(i: int) -> float:
    return _HIST_LO * 2.0 ** i


class Histogram(_Instrument):
    """Bounded log2-bucket histogram: O(1) memory, 2x quantile resolution."""

    kind = "histogram"

    def __init__(self, registry, name, labels):
        super().__init__(registry, name, labels)
        self._counts = [0] * _HIST_NB
        self._n = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        if not self._on(self.key):
            return
        v = float(v)
        i = bucket_index(v)
        with self._mu:
            self._counts[i] += 1
            self._n += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """q in [0, 1]; geometric midpoint of the bucket holding rank
        ceil(q * count) (one-bucket resolution), clamped to observed
        min/max so a single-sample histogram reports the sample itself."""
        n = self._n
        if n == 0:
            return math.nan
        rank = max(1, math.ceil(q * n))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                mid = math.sqrt(bucket_lo(i) * bucket_lo(i + 1))
                return min(max(mid, self._min), self._max)
        return self._max  # pragma: no cover - rank <= n always hits above

    def reset(self) -> None:
        with self._mu:
            self._counts = [0] * _HIST_NB
            self._n = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def describe(self) -> dict:
        n = self._n
        d = {
            "type": "histogram",
            "count": n,
            "sum": self._sum,
            "min": self._min if n else None,
            "max": self._max if n else None,
            "avg": (self._sum / n) if n else None,
            "p50": self.quantile(0.50) if n else None,
            "p95": self.quantile(0.95) if n else None,
            "p99": self.quantile(0.99) if n else None,
        }
        d["buckets"] = {
            f"{bucket_lo(i):.3g}": c
            for i, c in enumerate(self._counts)
            if c
        }
        return d


class MetricsRegistry:
    """Get-or-create instrument store; the process-global default lives in
    ``repro_torch.obs`` (``default_registry()``). Components accept a
    ``registry=`` argument so tests can count in isolation."""

    def __init__(self, *, enabled: bool = True):
        self.enabled = enabled
        self._mu = threading.Lock()
        self._metrics: dict[tuple, _Instrument] = {}

    def _get(self, cls, name: str, labels: dict) -> _Instrument:
        key = (name, tuple(sorted(labels.items())))
        m = self._metrics.get(key)  # lock-free fast path (GIL-atomic read)
        if m is None:
            with self._mu:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(self, name, key[1])
                    self._metrics[key] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {series_key(name, key[1])!r} already registered "
                f"as {m.kind}, requested {cls.kind}"
            )
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def series(self) -> list[_Instrument]:
        with self._mu:
            return sorted(self._metrics.values(), key=lambda m: m.key)

    def snapshot(self) -> dict:
        """``{series_key: describe()}`` for every registered series."""
        return {m.key: m.describe() for m in self.series()}

    def write_jsonl(self, path: str) -> None:
        """One JSON object per line per series (the exporter format the
        bench/CI artifacts and the example use)."""
        with open(path, "w") as f:
            for m in self.series():
                rec = {"series": m.key, "name": m.name,
                       "labels": dict(m.labels), **m.describe()}
                f.write(json.dumps(rec) + "\n")

    def dump(self, stream=None) -> None:
        """Human-oriented stdout exporter (one line per series)."""
        stream = stream if stream is not None else sys.stdout
        for m in self.series():
            d = m.describe()
            if d["type"] == "histogram":
                if d["count"]:
                    stream.write(
                        f"{m.key} count={d['count']} avg={d['avg']:.3g} "
                        f"p50={d['p50']:.3g} p95={d['p95']:.3g} "
                        f"p99={d['p99']:.3g}\n"
                    )
                else:
                    stream.write(f"{m.key} count=0\n")
            else:
                stream.write(f"{m.key} {d['value']}\n")

    def reset(self) -> None:
        """Zero every series (the series themselves stay registered, so
        instrument handles held by components remain valid)."""
        for m in self.series():
            m.reset()


_default: Optional[MetricsRegistry] = None
_default_mu = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _default
    if _default is None:
        with _default_mu:
            if _default is None:
                _default = MetricsRegistry()
    return _default
