"""Pluggable final-stage solver engines (§4.4 behind one seam).

Reference: ``repro/core/solvers/__init__.py``. Importing this package
registers the built-in engines:

    jit_sum           batched sum solver — uniform/partition/
                      transversal matroids; host-parity
    jit_greedy        batched star/tree greedy — approximate,
                      explicit opt-in only (engine=/hint=)
    host_local_search AMT local search, sum under any matroid (reference)
    host_exhaustive   exact DFS, non-sum variants under any matroid
                      (reference)

The batched engines keep the reference's names; they run on
``SolveContext.device`` (the card by default). ``select_engine``
implements ``engine="auto"`` (fastest eligible engine with the
host-parity guarantee); ``register_engine`` accepts custom engines.
"""
from .base import (
    MATROID_KINDS,
    EngineSolution,
    SolveContext,
    SolveSpec,
    SolverEngine,
    coverage_matrix,
    get_engine,
    partition_by_engine,
    register_engine,
    registered_engines,
    resolve_engine,
    select_engine,
    selection_value,
)
from .cost_model import CostModel, EngineSeed, default_cost_model
from .exhaustive import exhaustive_best
from .host import HostExhaustiveEngine, HostLocalSearchEngine
from .jit_greedy import (
    JitGreedyBatchEngine,
    solve_greedy_batch,
    solve_greedy_batch_transversal,
)
from .jit_sum import (
    JitSumBatchEngine,
    bucket_pow2,
    solve_sum_batch,
    solve_sum_batch_transversal,
)
from .local_search import greedy_init, local_search_sum
from .stacked import (
    counts_stack_eligible,
    solve_stacked,
    solve_sum_batch_stacked,
)

HOST_LOCAL_SEARCH = register_engine(HostLocalSearchEngine())
HOST_EXHAUSTIVE = register_engine(HostExhaustiveEngine())
JIT_SUM = register_engine(JitSumBatchEngine())
JIT_GREEDY = register_engine(JitGreedyBatchEngine())

__all__ = [
    "MATROID_KINDS", "EngineSolution", "SolveContext", "SolveSpec",
    "SolverEngine", "coverage_matrix", "get_engine", "partition_by_engine",
    "register_engine", "registered_engines", "resolve_engine",
    "select_engine", "selection_value",
    "CostModel", "EngineSeed", "default_cost_model",
    "HostExhaustiveEngine", "HostLocalSearchEngine",
    "JitGreedyBatchEngine", "JitSumBatchEngine",
    "bucket_pow2", "solve_sum_batch", "solve_sum_batch_transversal",
    "solve_greedy_batch", "solve_greedy_batch_transversal",
    "counts_stack_eligible", "solve_stacked", "solve_sum_batch_stacked",
    "exhaustive_best", "greedy_init", "local_search_sum",
]
