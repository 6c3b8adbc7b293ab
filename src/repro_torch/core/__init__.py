"""Core library of the PyTorch port: the sequential, streaming and
MapReduce settings.

Reference: ``repro/core/__init__.py``:
    MatroidSpec, make_host_matroid          -- matroid representations
    gmm, gmm_fixed, gmm_radius              -- Gonzalez clustering (K2)
    seq_coreset_host, extract_host          -- sequential construction (Alg. 1)
    seq_coreset, extraction_mask, compress  -- SeqCoreset on the device
    concat_coresets                         -- union of coreset buffers
    rank_in_group, partition_extract_mask,  -- device EXTRACT masks
    transversal_extract_mask
    coreset_distance_matrix, final_solve    -- final stage (K1 + engines)
    local_search_sum, exhaustive_best       -- final-stage solvers (4.4)
    SolverEngine, register_engine, ...      -- solver-engine registry (host
                                               and batched engines)
    init_stream_state, ingest_batch, ...    -- streaming scan (Alg. 2, K3)
    init_sharded_states, ingest_batch_sharded, resolve_placement,
    ingest_batch_sharded_mapped             -- sharded drives (vmap,
                                               pipeline, shard_map)
    mapreduce_coreset                       -- MR construction over a
                                               launch.mesh (4.2)
    distributed_coreset                     -- one global GMM traversal
                                               over a mesh
    union_coresets, snapshot_at_epoch, ...  -- composition (§3)
    solve_dmmc                              -- end-to-end entry point
                                               (sequential, streaming,
                                               mapreduce)
    diversity, torch_diversity, VARIANTS    -- Table-1 objectives
"""
from .coreset import (
    Coreset,
    compress,
    concat_coresets,
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
    torch_diversity,
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
    partition_counts_ok,
    partition_extract_mask,
    rank_in_group,
    transversal_extract_mask,
)
from .mapreduce import mapreduce_coreset
from .distributed_gmm import distributed_coreset
from .solve import DMMCSolution, solve_dmmc
from .streaming import (
    PLACEMENTS,
    STEP_IMPLS,
    StreamState,
    default_slot_cap,
    epoch_fingerprint,
    epoch_stats,
    ingest_batch,
    ingest_batch_donated,
    ingest_batch_sharded,
    ingest_batch_sharded_donated,
    ingest_batch_sharded_mapped,
    init_sharded_states,
    init_stream_state,
    mesh_device_count,
    resolve_placement,
    snapshot_coreset,
    state_from_arrays,
    state_to_arrays,
    stream_coreset,
    stream_coreset_host,
)
from .compose import (
    compact_coreset,
    merge_stream_states,
    snapshot_at_epoch,
    snapshot_shards,
    union_coresets,
    unstack_shards,
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
    "Coreset", "compress", "concat_coresets", "default_capacity",
    "extract_host", "extraction_mask", "seq_coreset", "seq_coreset_host",
    "partition_counts_ok", "partition_extract_mask", "rank_in_group",
    "transversal_extract_mask", "mapreduce_coreset", "distributed_coreset",
    "VARIANTS", "Variant", "diversity", "diversity_of_points", "f_of_k",
    "farness_lower_bound", "torch_diversity", "SubsetMatroidView", "coreset_distance_matrix",
    "final_solve", "GMMResult", "gmm", "gmm_fixed", "gmm_radius",
    "GeneralMatroid", "Matroid", "MatroidSpec", "PartitionMatroid",
    "TransversalMatroid", "UniformMatroid", "make_host_matroid",
    "DMMCSolution", "solve_dmmc", "STEP_IMPLS", "StreamState",
    "default_slot_cap", "epoch_fingerprint", "epoch_stats", "ingest_batch",
    "ingest_batch_donated", "init_stream_state", "snapshot_coreset",
    "state_from_arrays", "state_to_arrays", "stream_coreset",
    "stream_coreset_host", "PLACEMENTS", "ingest_batch_sharded",
    "ingest_batch_sharded_donated", "ingest_batch_sharded_mapped",
    "init_sharded_states",
    "mesh_device_count", "resolve_placement", "compact_coreset",
    "merge_stream_states", "snapshot_at_epoch", "snapshot_shards",
    "union_coresets", "unstack_shards", "SolveContext", "SolveSpec",
    "SolverEngine", "coverage_matrix", "exhaustive_best", "get_engine",
    "greedy_init", "local_search_sum", "register_engine",
    "registered_engines", "select_engine", "selection_value",
]
