"""Coreset/distance-matrix cache for the diversity serving stack.

Reference: ``repro/serve/diversity/cache.py``. One entry per
``(MatroidSpec, tau, metric)`` key: the compacted, metric-normalized
coreset plus its pairwise distance matrix, built by K1 through
``core.final_solve.coreset_distance_matrix`` on the cache's device. An
entry is keyed additionally by a fingerprint of the coreset: ingestion
that leaves the coreset unchanged keeps the matrix warm.

The entry's ``D`` stays on the device where K1 wrote it; ``D_host`` is
its one copy on the host (pulled once at build), which the host engines
read and the batched engines take back to the device.

Bounds, as in the reference: ``max_entries`` caps the entry count with
least-recently-used eviction and ``ttl_s`` expires entries not rebuilt
within the window; both off by default. The full expiry sweep is lazy: it
runs on insert, and only once the earliest possible expiry deadline has
passed. Under capacity pressure expired entries go before any live entry
is evicted. All public operations are thread-safe; a build runs outside
the lock, so a cold tenant's K1 never blocks a warm tenant's lookup.

``CacheStats`` counts hits, misses, builds, invalidations, evictions,
expirations and sweeps as ``obs`` registry series
(``serve.cache.<field>{cache=cN}``).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ... import obs
from ...core.final_solve import coreset_distance_matrix
from ...core.matroid import MatroidSpec
from ...device import CUDA, DeviceLike, resolve_device


class CacheKey(NamedTuple):
    spec: MatroidSpec
    tau: int
    metric: str


@dataclasses.dataclass
class CoresetEntry:
    """Compacted coreset (valid rows only, buffer order) + its distances."""

    points: np.ndarray  # f32[m, d] metric-normalized (host)
    cats: np.ndarray  # int32[m, gamma]
    src_idx: np.ndarray  # int64[m] global stream indices
    D: torch.Tensor  # f32[m, m] pairwise Euclidean distances, on the device
    D_host: np.ndarray  # the same matrix on the host
    fingerprint: int
    built_at: float = 0.0  # clock() at build time (TTL anchor)
    last_use: float = 0.0  # clock() at last lookup hit (LRU ordering)

    @property
    def size(self) -> int:
        return int(self.src_idx.shape[0])


# each cache's counters live under their own cache=cN label, so a fresh
# cache always starts its series at zero
_cache_seq = itertools.count()


class CacheStats:
    """Per-cache counters backed by ``obs`` registry series
    (``serve.cache.<field>{cache=cN}``): ``stats.hits`` etc. read as plain
    ints, ``snapshot()`` returns a plain dict."""

    FIELDS = (
        "hits",
        "misses",
        "builds",  # pdist matrix constructions (one K1 launch each)
        "invalidations",
        "evictions",  # max_entries LRU evictions
        "expirations",  # TTL expiries
        "sweeps",  # full expiry scans actually run (lazy: deadline-gated)
    )

    def __init__(
        self, registry: Optional[obs.MetricsRegistry] = None, **labels
    ):
        reg = registry if registry is not None else obs.default_registry()
        if "cache" not in labels:
            labels["cache"] = f"c{next(_cache_seq)}"
        self._counters = {
            f: reg.counter(f"serve.cache.{f}", **labels)
            for f in self.FIELDS
        }

    def incr(self, field: str, n: int = 1) -> None:
        self._counters[field].inc(n)

    def __getattr__(self, name: str) -> int:
        c = self.__dict__.get("_counters", {}).get(name)
        if c is None:
            raise AttributeError(name)
        return c.value

    def snapshot(self) -> dict:
        return {f: c.value for f, c in self._counters.items()}


def coreset_fingerprint(valid: np.ndarray, src_idx: np.ndarray) -> int:
    """Host content hash of a coreset: it is determined by (valid,
    src_idx). The runtime fingerprints on the device instead
    (``core.streaming.epoch_fingerprint``)."""
    return hash((valid.tobytes(), src_idx.tobytes()))


class DistanceCache:
    """Maps CacheKey -> CoresetEntry, invalidating on fingerprint change,
    with optional max-entries LRU eviction and per-entry TTL expiry.

    ``build_fn(points)`` returns the (m, m) matrix; the default is K1 on
    ``device`` (``coreset_distance_matrix(..., host=False)``). Whatever it
    returns is kept on ``device``.
    """

    def __init__(
        self,
        build_fn: Optional[Callable] = None,
        *,
        max_entries: Optional[int] = None,
        ttl_s: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[obs.MetricsRegistry] = None,
        device: DeviceLike = CUDA,
    ):
        if max_entries is not None and max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.device = resolve_device(device)
        self._build_fn = build_fn if build_fn is not None else (
            functools.partial(coreset_distance_matrix, device=self.device,
                              host=False))
        self._entries: dict[CacheKey, CoresetEntry] = {}
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self._clock = clock
        self._mu = threading.RLock()
        # earliest instant at which any entry can expire: a sweep before
        # it is a no-op, so inserts skip it (lazy sweep)
        self._next_sweep = math.inf
        self.stats = CacheStats(registry)

    def _expired(self, e: CoresetEntry) -> bool:
        return (
            self.ttl_s is not None
            and self._clock() - e.built_at > self.ttl_s
        )

    def _sweep_expired(self) -> None:
        """Drop every expired entry (abandoned tenants' matrices too);
        callers consult ``_next_sweep`` first."""
        if self.ttl_s is None:
            return
        self.stats.incr("sweeps")
        for k in [k for k, e in self._entries.items() if self._expired(e)]:
            del self._entries[k]
            self.stats.incr("expirations")
        self._next_sweep = (
            min(e.built_at for e in self._entries.values()) + self.ttl_s
            if self._entries
            else math.inf
        )

    def lookup(self, key: CacheKey, fingerprint: int) -> Optional[CoresetEntry]:
        with self._mu:
            e = self._entries.get(key)
            if e is not None and self._expired(e):
                self.stats.incr("expirations")
                del self._entries[key]
                e = None
            if e is not None and e.fingerprint == fingerprint:
                self.stats.incr("hits")
                e.last_use = self._clock()
                return e
            if e is not None:
                self.stats.incr("invalidations")
                del self._entries[key]
            self.stats.incr("misses")
            return None

    def build(
        self,
        key: CacheKey,
        points,
        cats: np.ndarray,
        src_idx: np.ndarray,
        fingerprint: int,
    ) -> CoresetEntry:
        """Build (outside the lock) and insert one entry. ``points`` is a
        host array or a tensor; the entry keeps a host copy. Two threads
        racing one (key, fingerprint) both build and the later insert wins
        (same inputs, same matrix; both builds counted)."""
        D = torch.as_tensor(self._build_fn(points), device=self.device)
        D_host = D.cpu().numpy()
        pts = (points.cpu().numpy() if torch.is_tensor(points)
               else np.asarray(points))
        with self._mu:
            self.stats.incr("builds")
            now = self._clock()
            if now >= self._next_sweep:
                self._sweep_expired()
            e = CoresetEntry(
                points=pts, cats=cats, src_idx=src_idx, D=D, D_host=D_host,
                fingerprint=fingerprint, built_at=now, last_use=now,
            )
            self._entries[key] = e
            if self.ttl_s is not None:
                self._next_sweep = min(self._next_sweep, now + self.ttl_s)
            if self.max_entries is not None:
                if len(self._entries) > self.max_entries:
                    # capacity pressure: reclaim dead entries before
                    # evicting a live tenant's matrix
                    self._sweep_expired()
                while len(self._entries) > self.max_entries:
                    lru = min(
                        self._entries, key=lambda k: self._entries[k].last_use
                    )
                    del self._entries[lru]
                    self.stats.incr("evictions")
            return e

    def invalidate(self, key: CacheKey) -> None:
        with self._mu:
            if key in self._entries:
                del self._entries[key]
                self.stats.incr("invalidations")

    def __len__(self) -> int:
        return len(self._entries)
