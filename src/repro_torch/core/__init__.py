"""Core library of the PyTorch port: the sequential setting end to end.

Reference: ``repro/core/__init__.py``. Ported so far:
    MatroidSpec, make_host_matroid          -- matroid representations
    gmm, gmm_fixed, gmm_radius              -- Gonzalez clustering (K2)
    seq_coreset_host, extract_host          -- sequential construction (Alg. 1)
    coreset_distance_matrix, final_solve    -- final stage (K1 + host solvers)
    local_search_sum, exhaustive_best       -- final-stage solvers (4.4)
    SolverEngine, register_engine, ...      -- solver-engine registry
    solve_dmmc                              -- end-to-end driver (sequential)
    diversity, VARIANTS                     -- Table-1 objectives (host)
"""
from .coreset import Coreset, default_capacity, extract_host, seq_coreset_host
from .diversity import (
    VARIANTS,
    Variant,
    diversity,
    diversity_of_points,
    f_of_k,
    farness_lower_bound,
)
from .final_solve import SubsetMatroidView, coreset_distance_matrix, final_solve
from .gmm import GMMResult, gmm, gmm_fixed, gmm_radius
from .matroid import (
    GeneralMatroid,
    Matroid,
    MatroidSpec,
    PartitionMatroid,
    TransversalMatroid,
    UniformMatroid,
    make_host_matroid,
)
from .solve import DMMCSolution, solve_dmmc
from .solvers import (
    SolveContext,
    SolveSpec,
    SolverEngine,
    coverage_matrix,
    exhaustive_best,
    get_engine,
    greedy_init,
    local_search_sum,
    register_engine,
    registered_engines,
    select_engine,
    selection_value,
)

__all__ = [
    "Coreset", "default_capacity", "extract_host", "seq_coreset_host",
    "VARIANTS", "Variant", "diversity", "diversity_of_points", "f_of_k",
    "farness_lower_bound", "SubsetMatroidView", "coreset_distance_matrix",
    "final_solve", "GMMResult", "gmm", "gmm_fixed", "gmm_radius",
    "GeneralMatroid", "Matroid", "MatroidSpec", "PartitionMatroid",
    "TransversalMatroid", "UniformMatroid", "make_host_matroid",
    "DMMCSolution", "solve_dmmc", "SolveContext", "SolveSpec",
    "SolverEngine", "coverage_matrix", "exhaustive_best", "get_engine",
    "greedy_init", "local_search_sum", "register_engine",
    "registered_engines", "select_engine", "selection_value",
]
