"""PyTorch-aware profiling hooks: named scopes, a recompile counter keyed
by bucketed shape, and opt-in ``torch.profiler`` trace capture.

Reference: ``repro/obs/jaxprof.py``, with the same public names. XLA
reports every backend compile through ``jax.monitoring``; eager PyTorch
compiles nothing on its own, so the port defines its compile events:

* ``nvcc``   — each build that ``kernels/_build.library`` runs: a cache
               miss, the hashed library was not on disk (K1, K3–K6);
* ``triton`` — each first compile of a Triton specialisation: a launch
               of K2 after which Triton's cache holds one more kernel;
* ``dynamo`` — each ``torch.compile`` frame compile, through dynamo's
               end-of-compile callback (no module of the port uses
               ``torch.compile`` today).

Every site reports through one hook, ``report_compile``, which
attributes the event to the *compile region* active on the reporting
thread — a ``contextvars`` label the call sites set around their entry
points, carrying the bucketed shape key (``solve[jit_sum B=32 kmax=32
m=327]``). Events with no active region land under ``"unattributed"``
(a build in a worker thread, library warmup). A ``RecompileWatch``
counts them per key, so "did this change introduce steady-state
recompiles?" stays a measurable, gateable quantity; a later CUDA graph
per bucket can report its capture through the same hook.

``named_scope`` is ``torch.profiler.record_function``: it labels the
region in profiler traces (``solver/jit_sum``) and costs nothing when no
profiler runs.

``profiler_trace`` wraps ``torch.profiler.profile`` as an opt-in context
manager (explicit ``enabled=True`` or the ``REPRO_OBS_PROFILE=dir``
environment knob) that exports a Chrome trace and never lets profiler
failures take down the caller.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from pathlib import Path
from typing import Optional

import torch

named_scope = torch.profiler.record_function  # the in-trace annotation

COMPILE_SOURCES = ("nvcc", "triton", "dynamo")
UNATTRIBUTED = "unattributed"
# default capture directory: build/ at the checkout's root (gitignored)
TRACE_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_trace"

_compile_key: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "repro_torch_obs_compile_key", default=None
)


@contextlib.contextmanager
def compile_region(key: str):
    """Attribute any compile event raised inside to ``key`` (use the
    bucketed shape as the key so a counter > 0 names the bucket that
    failed to hold). Nested regions: innermost wins."""
    token = _compile_key.set(key)
    try:
        yield
    finally:
        _compile_key.reset(token)


def current_compile_region() -> Optional[str]:
    return _compile_key.get()


_watches: list["RecompileWatch"] = []
_install_mu = threading.Lock()
_dynamo_t0 = threading.local()


def report_compile(source: str, seconds: float) -> None:
    """One compile event from ``source`` (one of ``COMPILE_SOURCES``),
    attributed to the active compile region. Runs inside build and launch
    paths: never raises."""
    key = _compile_key.get() or UNATTRIBUTED
    for w in tuple(_watches):
        try:
            w._on_compile(key, source, float(seconds))
        except Exception:  # pragma: no cover - defensive
            pass


def _dynamo_start(_args) -> None:
    _dynamo_t0.t = time.perf_counter()


def _dynamo_end(_args) -> None:
    t0 = getattr(_dynamo_t0, "t", None)
    report_compile("dynamo",
                   0.0 if t0 is None else time.perf_counter() - t0)


def _install_dynamo_hook() -> None:
    """Subscribe to dynamo's compile callbacks (the nvcc and Triton sites
    call ``report_compile`` themselves). ``torch._dynamo.reset()`` drops
    every callback; the next watch created subscribes again."""
    from torch._dynamo.callback import callback_handler

    with _install_mu:
        if _dynamo_end not in callback_handler.end_callbacks:
            callback_handler.register_start_callback(_dynamo_start)
            callback_handler.register_end_callback(_dynamo_end)


class RecompileWatch:
    """Counts compile events per compile-region key.

    ``reset()`` opens a measurement window; ``total()`` / ``by_key()``
    read it. Independent watches over the same process stream count
    independently (a never-reset watch for the full-run compile census,
    a windowed one for the steady-state gate)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._counts: dict[str, int] = {}
        self._secs: dict[str, float] = {}
        self._sources: dict[str, int] = {}
        _install_dynamo_hook()
        _watches.append(self)

    def _on_compile(self, key: str, source: str, duration: float) -> None:
        with self._mu:
            self._counts[key] = self._counts.get(key, 0) + 1
            self._secs[key] = self._secs.get(key, 0.0) + duration
            self._sources[source] = self._sources.get(source, 0) + 1

    def total(self, *, include_unattributed: bool = True) -> int:
        with self._mu:
            return sum(
                c for k, c in self._counts.items()
                if include_unattributed or k != UNATTRIBUTED
            )

    def by_key(self) -> dict[str, int]:
        with self._mu:
            return dict(self._counts)

    def seconds_by_key(self) -> dict[str, float]:
        with self._mu:
            return dict(self._secs)

    def by_source(self) -> dict[str, int]:
        """Events per compile source (``COMPILE_SOURCES``)."""
        with self._mu:
            return dict(self._sources)

    def reset(self) -> None:
        with self._mu:
            self._counts.clear()
            self._secs.clear()
            self._sources.clear()

    def close(self) -> None:
        """Stop receiving events (the dynamo callbacks stay registered;
        this watch drops out of the fan-out)."""
        try:
            _watches.remove(self)
        except ValueError:
            pass


_default_watch: Optional[RecompileWatch] = None
_default_watch_mu = threading.Lock()


def recompile_watch() -> RecompileWatch:
    """The process-default watch (created + subscribed on first use)."""
    global _default_watch
    if _default_watch is None:
        with _default_watch_mu:
            if _default_watch is None:
                _default_watch = RecompileWatch()
    return _default_watch


_trace_seq = itertools.count()


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str] = None, *,
                   enabled: Optional[bool] = None):
    """Opt-in ``torch.profiler`` capture around a region, exported as a
    Chrome trace (``<logdir>/trace-<pid>-<n>.json``). Default resolves
    from ``REPRO_OBS_PROFILE``: unset -> disabled; set -> enabled, its
    value the log directory unless ``logdir`` overrides (else
    ``build/repro_torch_trace`` at the checkout's root). Yields True iff
    a capture is running; profiler errors (a profiler already running,
    an unwritable directory) disable the capture rather than failing the
    caller."""
    env = os.environ.get("REPRO_OBS_PROFILE", "")
    on = bool(env) if enabled is None else enabled
    if not on:
        yield False
        return
    where = Path(logdir or env or TRACE_DIR)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=activities)
        prof.start()
    except Exception:
        prof = None
    try:
        yield prof is not None
    finally:
        if prof is not None:
            try:
                prof.stop()
                where.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(
                    str(where / f"trace-{os.getpid()}-{next(_trace_seq)}.json")
                )
            except Exception:  # pragma: no cover - defensive
                pass
