"""``repro_torch.obs`` — the observability layer of the port: metrics
registry, span-based request tracing, and PyTorch-aware profiling hooks.

Reference: ``repro/obs/__init__.py``, with the same exports (``torchprof``
in place of ``jaxprof``; ``COMPILE_SOURCES`` in place of the XLA event
name ``BACKEND_COMPILE_EVENT``). ``tests/test_torch_obs.py`` pins the
contracts.

Three pillars, one import:

* **metrics** — thread-safe counters/gauges/log-bucket histograms with
  labels (tenant/engine/placement), O(1) memory per series, p50/p95/p99
  off bucket boundaries, JSONL/stdout exporters, and a tracer-leak guard
  (`TracerLeakError`) so no host-side metric call can land inside a
  ``torch.compile`` trace or a CUDA-graph capture;
* **tracing** — ``span()`` context managers with per-request trace IDs
  (``trace``/``resume_trace`` carry one ID across threads), recorded in
  a lock-free ring buffer and exported as Chrome ``trace_event`` JSON
  (``dump_trace(path)`` -> chrome://tracing / ui.perfetto.dev);
* **torchprof** — ``named_scope`` (``torch.profiler.record_function``),
  ``compile_region``/``RecompileWatch`` turning the port's compile events
  (nvcc builds, Triton specialisations, dynamo frames) into a
  per-bucketed-shape counter (the ``steady_state_recompiles == 0``
  gate), and opt-in ``torch.profiler`` capture (``profiler_trace``).

Module-level conveniences operate on the process-global defaults;
every component also accepts explicit ``registry=``/buffer instances so
tests can count in isolation. ``set_enabled(False)`` turns the whole
layer into a few attribute loads per call.
"""
from __future__ import annotations

from typing import Optional

from .export import (
    dump_metrics,
    metrics_snapshot,
    observability_report,
    write_chrome_trace,
    write_metrics_jsonl,
)
from .torchprof import (
    COMPILE_SOURCES,
    UNATTRIBUTED,
    RecompileWatch,
    compile_region,
    current_compile_region,
    named_scope,
    profiler_trace,
    recompile_watch,
    report_compile,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    TracerLeakError,
    assert_host_side,
    default_registry,
)
from .tracing import (
    SpanRecord,
    TraceBuffer,
    current_trace_id,
    default_buffer,
    dump_trace,
    new_trace_id,
    resume_trace,
    span,
    trace,
)

__all__ = [
    "COMPILE_SOURCES", "UNATTRIBUTED",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "TracerLeakError",
    "RecompileWatch", "SpanRecord", "TraceBuffer",
    "assert_host_side", "compile_region", "counter",
    "current_compile_region", "current_trace_id", "default_buffer",
    "default_registry", "dump_metrics", "dump_trace", "gauge", "histogram",
    "metrics_snapshot", "named_scope", "new_trace_id",
    "observability_report", "profiler_trace", "recompile_watch",
    "report_compile", "reset",
    "resume_trace", "set_enabled", "span", "trace", "write_chrome_trace",
    "write_metrics_jsonl",
]


def counter(name: str, **labels) -> Counter:
    return default_registry().counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return default_registry().gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return default_registry().histogram(name, **labels)


def set_enabled(on: bool) -> None:
    """Enable/disable the process-default registry AND trace buffer in
    one switch (disabled ops are a couple of attribute loads)."""
    default_registry().enabled = on
    default_buffer().enabled = on


def reset(*, trace_too: bool = True) -> None:
    """Zero the default registry (and clear the default trace buffer):
    the bench calls this at the top so artifacts start from zero."""
    default_registry().reset()
    if trace_too:
        default_buffer().clear()
