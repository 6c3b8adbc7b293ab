"""MapReduce coreset construction (paper §4.2) over a ``launch.mesh``.

Reference: ``repro/core/mapreduce.py`` (``local_coreset_and_gather`` :42,
``mapreduce_coreset`` :77). The paper's one-round MR scheme: partition S
into ell shards, run SeqCoreset on each shard (local delta_i, local GMM
on K2), union the local coresets. Composability (§3) makes the union a
coreset of S.

* a "reducer" is a position along the data axes of the mesh; shard s
  holds rows [s * n_local, (s + 1) * n_local) and its coreset's
  ``src_idx`` are offset by ``s * n_local``;
* the union is the shard-major concatenation of the fixed-capacity
  coreset buffers, as the reference's ``all_gather(tiled=True)`` gives
  it, and the overflow is the max over shards;
* the optional second round re-runs SeqCoreset on the union (on every
  rank of a multi-rank mesh: identical inputs give identical outputs),
  its ``src_idx`` chained through round 1's.

On an in-process mesh (``launch.mesh``) the shards run one after
another, each on its position's device; on a multi-rank mesh each rank
runs its own and the union is one ``dist.all_gather`` and one
``dist.all_reduce(MAX)``. Both give the same union bit for bit.

Fault tolerance, as the reference notes: the union of ANY subset of
shard coresets is a coreset of the points those shards hold, so a shard
whose ``valid`` lanes are zeroed degrades coverage instead of poisoning
the result.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .coreset import Coreset, default_capacity, seq_coreset
from .matroid import MatroidSpec

Rows = Union[torch.Tensor, np.ndarray, Sequence]


def shard_rows(x: Rows, s: int, shards: int, device) -> torch.Tensor:
    """Shard ``s`` of ``x`` on ``device``: a view of rows [s * n_local,
    (s + 1) * n_local) of a global (n, ...) array, or entry ``s`` of a
    list of per-shard blocks (``solve_dmmc`` passes views, and copies only
    a shard that padding completes)."""
    if isinstance(x, (list, tuple)):
        if len(x) != shards:
            raise ValueError(f"{len(x)} shard blocks for {shards} shards")
        return torch.as_tensor(x[s], device=device)
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % shards:
        raise ValueError(f"n={n} is not divisible by {shards} shards; pad "
                         f"with invalid rows (solve_dmmc does)")
    n_local = n // shards
    return x[s * n_local:(s + 1) * n_local].to(device)


def local_coreset_and_gather(
    mesh,
    pts: Sequence[torch.Tensor],  # this process's shards, (n_local, d) each
    cats: Sequence[torch.Tensor],  # (n_local, gamma) each
    valid: Sequence[torch.Tensor],  # (n_local,) each
    spec: MatroidSpec,
    caps,
    k: int,
    tau_local: int,
    axis_names: Sequence[str],
    *,
    eps: float = 0.0,
    use_radius_target: bool = False,
    cap_local: Optional[int] = None,
    force: Optional[str] = None,
) -> tuple[Coreset, torch.Tensor]:
    """SeqCoreset on each local shard (``mesh.local_shards(axis_names)``
    order), then the gather. Returns the union coreset (the same on
    every rank) and the max overflow, both on the first local device."""
    axis_names = tuple(axis_names)
    local = mesh.local_shards(axis_names)
    parts, ovfs = [], []
    for (s, dev), p, c, v in zip(local, pts, cats, valid):
        n_local = p.shape[0]
        cs, _res, ovf = seq_coreset(
            p, c, v, spec, caps, k, tau_local, eps=eps,
            use_radius_target=use_radius_target, cap=cap_local,
            base_index=s * n_local, force=force, device=dev,
        )
        parts.append(cs)
        ovfs.append(ovf)
    gathered = Coreset(*(mesh.all_gather(list(leaf), axis_names)
                         for leaf in zip(*parts)))
    ovf = mesh.pmax(ovfs, axis_names)[0].to(gathered.valid.device)
    return gathered, ovf


def mapreduce_coreset(
    mesh,
    points: Rows,  # (n, d) global, n divisible by #shards, or shard blocks
    cats: Rows,  # (n, gamma)
    valid: Rows,  # (n,)
    spec: MatroidSpec,
    caps,
    k: int,
    tau_local: int,
    *,
    data_axes: Sequence[str] = ("data",),
    eps: float = 0.0,
    use_radius_target: bool = False,
    round2_tau: Optional[int] = None,
    force: Optional[str] = None,
) -> tuple[Coreset, torch.Tensor]:
    """One (optionally two) MR round(s). Returns (coreset, overflow), the
    same on every rank.

    ``points``, ``cats`` and ``valid`` are the reference's global arrays
    (every rank of a multi-rank mesh passes them and takes its own
    shard), or the lists of the shards' blocks in shard order. Each shard
    runs on its position's device (K2 for its GMM).

    round2_tau: if given, apply the sequential construction once more to
    the gathered union (paper: makes |T| independent of ell at the cost
    of an extra (1-eps) factor).
    """
    data_axes = tuple(data_axes)
    shards = mesh.axis_size(data_axes)
    local = mesh.local_shards(data_axes)
    pts = [shard_rows(points, s, shards, dev).to(torch.float32)
           for s, dev in local]
    cts = [shard_rows(cats, s, shards, dev) for s, dev in local]
    vld = [shard_rows(valid, s, shards, dev).to(torch.bool)
           for s, dev in local]
    cs, ovf = local_coreset_and_gather(
        mesh, pts, cts, vld, spec, caps, k, tau_local, data_axes, eps=eps,
        use_radius_target=use_radius_target, force=force,
    )
    if round2_tau is not None:
        cap2 = default_capacity(spec, k, round2_tau)
        dev = cs.valid.device
        cs2, _res2, ovf2 = seq_coreset(
            cs.points, cs.cats, cs.valid, spec, caps, k, round2_tau,
            cap=cap2, force=force, device=dev,
        )
        # src_idx of round-2 points chains through round 1's mapping
        safe = torch.clamp_min(cs2.src_idx, 0).to(torch.int64)
        chained = torch.where(cs2.valid, cs.src_idx[safe], -1)
        cs = cs2._replace(src_idx=chained.to(torch.int32))
        ovf = torch.maximum(ovf, ovf2)
    return cs, ovf
