"""End-to-end DMMC driver: coreset construction + final-stage solver.

Reference: ``repro/core/solve.py`` (``solve_dmmc`` :78), in its three
settings:

1. build a coreset: sequential = GMM on the device and the host EXTRACT
   (Alg. 1, eps- or tau-driven); streaming = the Alg.-2 blocked scan of
   ``core.streaming`` (tau-driven), whose coreset indices stay in buffer
   order, as in the reference; mapreduce = ``core.mapreduce`` over a
   ``launch.mesh`` (each shard's SeqCoreset on its position's device,
   the union of their buffers, optionally a second round), tau-driven;
2. run the final solver on the coreset only:
   - sum       -> AMT local search (gamma=0), the paper's choice;
   - others    -> exhaustive search (exact on the coreset).

The reference round-trips the whole normalised matrix to the host; here
the points stay on the device. Only the cluster assignment (n int32) or
the scan's decisions cross to the host, the coreset rows are gathered on
the device, and only the coreset's (m, m) distance matrix comes back. In
the mapreduce setting the shards are views of the normalised matrix;
only a shard that padding completes is copied.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import CUDA, DeviceLike, disable_tf32, resolve_device
from . import geometry
from .coreset import seq_coreset_host
from .diversity import Variant
from .final_solve import SubsetMatroidView, coreset_distance_matrix, final_solve
from .mapreduce import mapreduce_coreset
from .matroid import MatroidSpec, make_host_matroid
from .streaming import stream_coreset


@dataclasses.dataclass
class DMMCSolution:
    indices: np.ndarray  # selected point indices into S
    diversity: float
    coreset_indices: np.ndarray
    coreset_size: int
    timings: dict
    info: dict


def _final_solve(
    pts_norm: torch.Tensor,
    cats: Optional[np.ndarray],
    spec: MatroidSpec,
    caps: Optional[np.ndarray],
    k: int,
    coreset_idx: np.ndarray,
    variant: Variant,
    oracle=None,
    gamma: float = 0.0,
    engine: str = "host",
    force: Optional[str] = None,
) -> tuple[list[int], float]:
    n = pts_norm.shape[0]
    matroid = make_host_matroid(spec, cats, caps, n, k, oracle)
    sub = np.asarray(coreset_idx, np.int64)
    # distance matrix over coreset only (never over S); rows gathered on
    # the device
    rows = pts_norm.index_select(
        0, torch.as_tensor(sub, device=pts_norm.device)
    )
    Dsub = coreset_distance_matrix(rows, force=force, device=pts_norm.device)
    view = SubsetMatroidView(matroid, sub)
    X, val = final_solve(
        Dsub, view, k, variant, gamma=gamma, engine=engine,
        cats=None if cats is None else np.asarray(cats)[sub], caps=caps,
        device=pts_norm.device,
    )
    return [int(sub[i]) for i in X], val


def _padded_shards(arrays, shards: int) -> list[list[torch.Tensor]]:
    """Each (n, ...) array as ``shards`` blocks of n_local = ceil(n /
    shards) rows: views where the rows exist, the last blocks completed
    with zero rows (zero ``valid`` marks them invalid)."""
    n = arrays[0].shape[0]
    n_local = -(-n // shards)
    out = []
    for x in arrays:
        blocks = []
        for s in range(shards):
            b = x[min(s * n_local, n):min((s + 1) * n_local, n)]
            if b.shape[0] < n_local:
                pad = torch.zeros((n_local - b.shape[0],) + tuple(x.shape[1:]),
                                  dtype=x.dtype, device=x.device)
                b = torch.cat([b, pad])
            blocks.append(b)
        out.append(blocks)
    return out


def solve_dmmc(
    points,
    k: int,
    spec: MatroidSpec,
    *,
    cats: Optional[np.ndarray] = None,
    caps: Optional[np.ndarray] = None,
    variant: Variant = "sum",
    eps: Optional[float] = None,
    tau: Optional[int] = None,
    setting: str = "sequential",  # sequential | streaming | mapreduce
    metric: geometry.Metric = "euclidean",
    mesh=None,
    data_axes: Sequence[str] = ("data",),
    round2_tau: Optional[int] = None,
    oracle=None,
    gamma: float = 0.0,
    engine: str = "host",
    force: Optional[str] = None,
    device: DeviceLike = CUDA,
) -> DMMCSolution:
    """Solve a DMMC instance end to end. Exactly one of eps/tau.

    ``points`` may be a numpy array or a tensor; it is moved to ``device``
    (no copy if it is already there). ``engine`` names a ``core.solvers``
    registry engine for the final stage ("host" = the paper's dispatch;
    "auto" = the parity engine of highest static priority, ``jit_sum``
    for the sum variant, which runs on ``device`` too).
    On the card ``auto`` is slower than ``"host"`` until a sweep is
    captured as a CUDA graph or made a kernel: on the songs-sim coreset
    (m = 327, k = 22, one H100) ``jit_sum`` took 0.92–0.96 s for one query
    against ~0.03 s for the host engine, and 0.82–1.22 s for 32 queries
    against the host's 0.89–1.02 s (``PERF.md`` §5).
    ``force="ref"`` runs the plain PyTorch versions of the kernels.
    ``setting="streaming"`` takes ``tau`` and the uniform, partition and
    transversal matroids. ``setting="mapreduce"`` takes ``tau`` and a
    ``launch.mesh`` (``make_mesh((8,), ("data",), devices=["cuda"] * 8)``
    runs 8 shards in turn on one card); the points are padded with
    invalid rows to a multiple of the shard count over ``data_axes``,
    each shard gets ``tau // shards`` centers (at least 1), and
    ``round2_tau`` re-cores the union. ``info`` then holds ``tau``,
    ``shards``, ``size`` and ``overflow``.
    """
    if setting not in ("sequential", "streaming", "mapreduce"):
        raise ValueError(setting)
    if (eps is None) == (tau is None):
        raise ValueError("give exactly one of eps / tau")
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    t0 = time.perf_counter()
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n = pts.shape[0]
    cats_arr = (
        np.zeros((n, 1), np.int32)
        if cats is None
        else np.asarray(cats, np.int32).reshape(n, -1)
    )
    pts_norm = geometry.normalize_for_metric(pts, metric)

    if setting == "sequential":
        idx, info = seq_coreset_host(
            pts_norm, cats_arr, spec, caps, k, eps=eps, tau=tau,
            metric="euclidean",  # already normalized
            oracle=oracle, force=force, device=dev,
        )
    elif setting == "mapreduce":
        if mesh is None or tau is None:
            raise ValueError("mapreduce needs a mesh and tau")
        shards = int(np.prod([mesh.shape[a] for a in data_axes]))
        tau_local = max(1, tau // shards)
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
        cs, ovf = mapreduce_coreset(
            mesh, *_padded_shards(
                (pts_norm, torch.as_tensor(cats_arr, device=dev), valid),
                shards),
            spec, caps, k, tau_local, data_axes=data_axes,
            round2_tau=round2_tau, force=force,
        )
        idx = np.unique(cs.src_idx[cs.valid].cpu().numpy())
        idx = idx[(idx >= 0) & (idx < n)]  # drop padding artifacts
        info = dict(tau=tau, shards=shards, size=int(idx.size),
                    overflow=int(ovf))
    else:
        if tau is None:
            raise ValueError("streaming is parameterized by tau (§5.2)")
        cs, _st = stream_coreset(
            pts_norm, cats_arr, np.ones(n, bool), spec, caps, k, tau,
            force=force, device=dev,
        )
        idx = cs.src_idx[cs.valid].cpu().numpy()
        info = dict(tau=tau, size=int(idx.size))

    t1 = time.perf_counter()
    sol_idx, val = _final_solve(
        pts_norm, cats_arr, spec, caps, k, idx, variant, oracle, gamma,
        engine, force,
    )
    t2 = time.perf_counter()

    return DMMCSolution(
        indices=np.asarray(sol_idx, np.int64),
        diversity=val,
        coreset_indices=np.asarray(idx, np.int64),
        coreset_size=int(idx.size),
        timings=dict(coreset_s=t1 - t0, solver_s=t2 - t1, total_s=t2 - t0),
        info=info,
    )
