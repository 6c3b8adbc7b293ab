"""Pluggable final-stage solver engines (§4.4 behind one seam).

Reference: ``repro/core/solvers/__init__.py``. Importing this package
registers the host reference engines:

    host_local_search AMT local search, sum under any matroid (reference)
    host_exhaustive   exact DFS, non-sum variants under any matroid
                      (reference)

The batched engines (``jit_sum``, ``jit_greedy``, ``stacked``,
``matching``) and the ``cost_model`` come in a later slice.
"""
from .base import (
    MATROID_KINDS,
    EngineSolution,
    SolveContext,
    SolveSpec,
    SolverEngine,
    coverage_matrix,
    get_engine,
    register_engine,
    registered_engines,
    resolve_engine,
    select_engine,
    selection_value,
)
from .exhaustive import exhaustive_best
from .host import HostExhaustiveEngine, HostLocalSearchEngine
from .local_search import greedy_init, local_search_sum

HOST_LOCAL_SEARCH = register_engine(HostLocalSearchEngine())
HOST_EXHAUSTIVE = register_engine(HostExhaustiveEngine())

__all__ = [
    "MATROID_KINDS", "EngineSolution", "SolveContext", "SolveSpec",
    "SolverEngine", "coverage_matrix", "get_engine", "register_engine",
    "registered_engines", "resolve_engine", "select_engine",
    "selection_value", "HostExhaustiveEngine", "HostLocalSearchEngine",
    "exhaustive_best", "greedy_init", "local_search_sum",
]
