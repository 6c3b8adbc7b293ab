"""Core library of the PyTorch port: the sequential and streaming settings.

Reference: ``repro/core/__init__.py``. Ported so far:
    MatroidSpec, make_host_matroid          -- matroid representations
    gmm, gmm_fixed, gmm_radius              -- Gonzalez clustering (K2)
    seq_coreset_host, extract_host          -- sequential construction (Alg. 1)
    seq_coreset, extraction_mask, compress  -- SeqCoreset on the device
    rank_in_group, partition_extract_mask   -- device EXTRACT masks
    coreset_distance_matrix, final_solve    -- final stage (K1 + host solvers)
    local_search_sum, exhaustive_best       -- final-stage solvers (4.4)
    SolverEngine, register_engine, ...      -- solver-engine registry
    init_stream_state, ingest_batch, ...    -- streaming scan (Alg. 2, K3)
    solve_dmmc                              -- end-to-end entry point
                                               (sequential, streaming)
    diversity, VARIANTS                     -- Table-1 objectives (host)
"""
from .coreset import (
    Coreset,
    compress,
    default_capacity,
    extract_host,
    extraction_mask,
    seq_coreset,
    seq_coreset_host,
)
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
    partition_extract_mask,
    rank_in_group,
)
from .solve import DMMCSolution, solve_dmmc
from .streaming import (
    STEP_IMPLS,
    StreamState,
    default_slot_cap,
    epoch_fingerprint,
    epoch_stats,
    ingest_batch,
    ingest_batch_donated,
    init_stream_state,
    snapshot_coreset,
    state_from_arrays,
    state_to_arrays,
    stream_coreset,
    stream_coreset_host,
)
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
    "Coreset", "compress", "default_capacity", "extract_host",
    "extraction_mask", "seq_coreset", "seq_coreset_host",
    "partition_extract_mask", "rank_in_group",
    "VARIANTS", "Variant", "diversity", "diversity_of_points", "f_of_k",
    "farness_lower_bound", "SubsetMatroidView", "coreset_distance_matrix",
    "final_solve", "GMMResult", "gmm", "gmm_fixed", "gmm_radius",
    "GeneralMatroid", "Matroid", "MatroidSpec", "PartitionMatroid",
    "TransversalMatroid", "UniformMatroid", "make_host_matroid",
    "DMMCSolution", "solve_dmmc", "STEP_IMPLS", "StreamState",
    "default_slot_cap", "epoch_fingerprint", "epoch_stats", "ingest_batch",
    "ingest_batch_donated", "init_stream_state", "snapshot_coreset",
    "state_from_arrays", "state_to_arrays", "stream_coreset",
    "stream_coreset_host", "SolveContext", "SolveSpec",
    "SolverEngine", "coverage_matrix", "exhaustive_best", "get_engine",
    "greedy_init", "local_search_sum", "register_engine",
    "registered_engines", "select_engine", "selection_value",
]
