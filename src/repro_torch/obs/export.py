"""Exporters + one-call observability snapshots.

Reference: ``repro/obs/export.py``, copied; the recompile census comes
from ``torchprof`` (the port's ``jaxprof``).

The registry/tracing modules own their own serialization
(``MetricsRegistry.write_jsonl``/``dump``, ``TraceBuffer.dump``); this
module is the batteries-included layer the bench, the example, and CI
use: grab *everything* (metrics + recompile census + trace) in one call,
against the process defaults or explicit instances.
"""
from __future__ import annotations

from typing import Optional

from .torchprof import RecompileWatch, recompile_watch
from .metrics import MetricsRegistry, default_registry
from .tracing import TraceBuffer, default_buffer


def metrics_snapshot(registry: Optional[MetricsRegistry] = None) -> dict:
    return (registry or default_registry()).snapshot()


def write_metrics_jsonl(path: str,
                        registry: Optional[MetricsRegistry] = None) -> str:
    (registry or default_registry()).write_jsonl(path)
    return path


def dump_metrics(registry: Optional[MetricsRegistry] = None, stream=None):
    (registry or default_registry()).dump(stream)


def write_chrome_trace(path: str,
                       buffer: Optional[TraceBuffer] = None) -> str:
    return (buffer or default_buffer()).dump(path)


def observability_report(
    registry: Optional[MetricsRegistry] = None,
    watch: Optional[RecompileWatch] = None,
) -> dict:
    """Everything the artifacts embed: the metrics snapshot plus the
    recompile census of the default (or given) watch."""
    w = watch or recompile_watch()
    return {
        "metrics": metrics_snapshot(registry),
        "recompiles_by_key": w.by_key(),
        "recompile_seconds_by_key": {
            k: round(v, 6) for k, v in w.seconds_by_key().items()
        },
    }
