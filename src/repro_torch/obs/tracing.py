"""Span-based request tracing for the serving stack.

Reference: ``repro/obs/tracing.py``, copied: it is framework-free. Its
spans go through the port's guard (``metrics.assert_host_side``).

A *span* is one timed region of host work (``with span("solve", ...)``); a
*trace* is the set of spans sharing one trace ID — one request's journey
through the stack. ``QueryFrontend.query_batch`` opens a trace per request
batch; ``StreamRuntime.submit`` opens one per submitted batch and the
ingest worker re-enters it when it actually ingests/publishes, so a
single trace covers submit -> ingest -> publish even across threads.

Propagation is a ``contextvars.ContextVar``: spans opened anywhere below
``trace()`` on the same thread (or under an explicitly resumed ID, see
``resume_trace``) carry the same 16-hex-digit trace ID in their args.

Storage is a fixed-size ring buffer: records are written at
``next(itertools.count()) % capacity`` — the counter is a C-level atomic
under the GIL, so concurrent writers never lock and never block; under
overload the buffer keeps the newest ``capacity`` spans and drops the
oldest, which is the correct failure mode for always-on tracing.

Export is Chrome ``trace_event`` JSON (``dump(path)`` /
``obs.dump_trace(path)``): open the file at ``chrome://tracing`` or
https://ui.perfetto.dev. Spans are complete events (``"ph": "X"``) with
microsecond timestamps on a shared wall-clock anchor, one row per thread.

Like metrics, spans are host-side only and guarded against leaking into a
``torch.compile`` trace or a CUDA-graph capture (``TracerLeakError``),
and a disabled buffer costs two attribute loads per span.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import threading
import time
import uuid
from typing import Optional

from .metrics import assert_host_side

# wall-clock anchor: perf_counter deltas (monotonic, high-res) mapped onto
# the epoch so trace timestamps from every thread share one axis
_ANCHOR_WALL = time.time()
_ANCHOR_PERF = time.perf_counter()


def now_us() -> float:
    return (_ANCHOR_WALL + (time.perf_counter() - _ANCHOR_PERF)) * 1e6


_trace_id: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "repro_obs_trace_id", default=None
)


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def current_trace_id() -> Optional[str]:
    return _trace_id.get()


@contextlib.contextmanager
def trace(trace_id: Optional[str] = None):
    """Establish a trace ID for every span opened underneath. Re-entrant:
    if a trace is already active and no explicit ID is given, it is
    reused (nested ``query_batch`` style calls join the caller's trace).
    Yields the active ID."""
    cur = _trace_id.get()
    if trace_id is None and cur is not None:
        yield cur
        return
    tid = trace_id if trace_id is not None else new_trace_id()
    token = _trace_id.set(tid)
    try:
        yield tid
    finally:
        _trace_id.reset(token)


@contextlib.contextmanager
def resume_trace(trace_id: Optional[str]):
    """Re-enter an existing trace on another thread (the ingest worker
    resumes the submitting caller's trace). ``None`` is a no-op."""
    if trace_id is None:
        yield None
        return
    token = _trace_id.set(trace_id)
    try:
        yield trace_id
    finally:
        _trace_id.reset(token)


@dataclasses.dataclass
class SpanRecord:
    name: str
    cat: str
    trace_id: Optional[str]
    ts_us: float
    dur_us: float
    tid: int
    args: dict

    def to_chrome(self) -> dict:
        args = {"trace_id": self.trace_id, **self.args}
        return {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": self.ts_us,
            "dur": self.dur_us,
            "pid": os.getpid(),
            "tid": self.tid,
            "args": args,
        }


class TraceBuffer:
    """Lock-free ring buffer of ``SpanRecord``s + Chrome export."""

    def __init__(self, capacity: int = 1 << 16, *, enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._buf: list[Optional[SpanRecord]] = [None] * capacity
        self._next = itertools.count()  # GIL-atomic increment, no lock

    def record(self, rec: SpanRecord) -> None:
        if not self.enabled:
            return
        self._buf[next(self._next) % self.capacity] = rec

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "serve", **args):
        """Time one host-side region; records on exit (exceptions
        included — a span that died still shows its duration)."""
        if not self.enabled:
            yield None
            return
        assert_host_side(f"span({name!r})")
        ts = now_us()
        t0 = time.perf_counter()
        try:
            yield None
        finally:
            self.record(SpanRecord(
                name=name,
                cat=cat,
                trace_id=_trace_id.get(),
                ts_us=ts,
                dur_us=(time.perf_counter() - t0) * 1e6,
                tid=threading.get_ident(),
                args=args,
            ))

    def drain(self) -> list[SpanRecord]:
        """Recorded spans, oldest first (non-destructive). Every record is
        wall-clock stamped, so ring order is recovered by timestamp."""
        out = [r for r in self._buf if r is not None]
        out.sort(key=lambda r: r.ts_us)
        return out

    def clear(self) -> None:
        self._buf = [None] * self.capacity
        self._next = itertools.count()

    def chrome_trace(self) -> dict:
        return {
            "displayTimeUnit": "ms",
            "traceEvents": [r.to_chrome() for r in self.drain()],
        }

    def dump(self, path: str) -> str:
        """Write Chrome ``trace_event`` JSON; open at chrome://tracing."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_default: Optional[TraceBuffer] = None
_default_mu = threading.Lock()


def default_buffer() -> TraceBuffer:
    global _default
    if _default is None:
        with _default_mu:
            if _default is None:
                _default = TraceBuffer()
    return _default


def span(name: str, cat: str = "serve", **args):
    """Span on the process-default buffer (the call sites' spelling)."""
    return default_buffer().span(name, cat, **args)


def dump_trace(path: str) -> str:
    return default_buffer().dump(path)
