"""Tenant registry: many logical serving configurations over ONE stream.

Reference: ``repro/serve/diversity/tenants.py`` (numpy and threading
only; the port keeps its own copy).

The paper's §3 composability says the coreset is a *substrate*: any
``(matroid, tau, metric)`` view can be solved on it. The registry turns
that into serving fan-out — one physical scan feeds N tenants, each of
which owns

* a ``CacheKey`` (its ``(MatroidSpec, tau, metric)`` triple) naming its
  private ``DistanceCache`` entry — its own pdist matrix, invalidated only
  when the shared stream publishes a changed epoch;
* its own solver eligibility: the matroid spec/caps/oracle its queries are
  constrained by, dispatched through the ``core.solvers`` registry exactly
  like a single-tenant service.

Tenants with *identical* keys share one cache entry (the matrix depends
only on the coreset and the metric); tenants with different metrics get a
re-normalized copy of the epoch's points. Registering a tenant costs
nothing until its first query builds its entry — fan-out is cache-shaped,
not stream-shaped.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from ...core import geometry
from ...core.matroid import MatroidSpec
from .cache import CacheKey

DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One logical serving configuration over the shared stream."""

    name: str
    spec: MatroidSpec
    tau: int
    metric: str
    caps: Optional[np.ndarray]
    oracle: object = None

    @property
    def key(self) -> CacheKey:
        return CacheKey(spec=self.spec, tau=self.tau, metric=self.metric)


class TenantRegistry:
    """Name -> ``Tenant`` map with the same admission rules as a
    single-tenant service (partition needs caps, general needs an
    oracle). Thread-safe; re-registering an identical configuration is a
    no-op, a conflicting one raises."""

    def __init__(self):
        self._tenants: dict[str, Tenant] = {}
        self._mu = threading.Lock()

    def register(
        self,
        name: str,
        *,
        spec: MatroidSpec,
        tau: int,
        metric: geometry.Metric,
        caps: Optional[np.ndarray] = None,
        oracle=None,
    ) -> Tenant:
        if spec.kind == "general" and oracle is None:
            raise ValueError(f"general-matroid tenant {name!r} needs an oracle")
        if spec.kind == "partition" and caps is None:
            raise ValueError(
                f"partition tenant {name!r} needs per-category caps"
            )
        t = Tenant(
            name=name,
            spec=spec,
            tau=int(tau),
            metric=str(metric),
            caps=None if caps is None else np.asarray(caps, np.int32),
            oracle=oracle,
        )
        with self._mu:
            old = self._tenants.get(name)
            if old is not None:
                same = (
                    old.spec == t.spec
                    and old.tau == t.tau
                    and old.metric == t.metric
                    and old.oracle is t.oracle
                    and (
                        (old.caps is None and t.caps is None)
                        or (
                            old.caps is not None
                            and t.caps is not None
                            and np.array_equal(old.caps, t.caps)
                        )
                    )
                )
                if same:
                    return old
                raise ValueError(
                    f"tenant {name!r} already registered with a different "
                    f"configuration"
                )
            self._tenants[name] = t
            return t

    def get(self, name: str) -> Tenant:
        with self._mu:
            try:
                return self._tenants[name]
            except KeyError:
                raise KeyError(
                    f"unknown tenant {name!r}; registered: "
                    f"{sorted(self._tenants)}"
                ) from None

    def names(self) -> list[str]:
        with self._mu:
            return sorted(self._tenants)

    def __len__(self) -> int:
        return len(self._tenants)

    def __contains__(self, name: str) -> bool:
        return name in self._tenants
