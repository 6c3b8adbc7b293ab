"""Distributed (global) GMM farthest-first traversal over a ``launch.mesh``.

Reference: ``repro/core/distributed_gmm.py`` (``_global_gmm_shard`` :37,
``distributed_coreset`` :101). The paper's MR construction runs GMM
independently per shard; this runs ONE Gonzalez traversal over the
sharded dataset:

  per iteration every shard folds the new center into its local
  min-distance vector with one K2 launch (``kernels.ops.gmm_update``),
  and the global argmax is reached by the reference's two-round owner
  election: the max over shards, then the lowest shard index holding it
  (within it the first index, K2's own tie rule), whose point becomes
  the next center.

So the result is the first-index argmax traversal of single-machine GMM
on the concatenation (``core.gmm.gmm_fixed``): the same centers, radius
and delta. On an in-process mesh the election is a stack and a max on
the first shard's device, with no read to the host, so the loop never
waits for the card; on a multi-rank mesh it is ``dist.all_reduce(MAX)``
calls, as the reference's ``pmax``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..kernels import ops
from .coreset import Coreset, compress, default_capacity, extraction_mask
from .mapreduce import shard_rows
from .matroid import MatroidSpec


def _global_gmm_shard(mesh, pts: Sequence[torch.Tensor],
                      valid: Sequence[torch.Tensor], tau: int,
                      axes: Sequence[str], *,
                      force: Optional[str] = None):
    """The traversal over this process's shards (``mesh.local_shards``
    order). Returns (assign per shard (n_local,), min_dist per shard,
    centers (tau, d), center_idx int64 (tau,) global row indices, delta,
    radius); the last four on the first local device."""
    axes = tuple(axes)
    local = mesh.local_shards(axes)
    neg_inf = -torch.inf

    def pmax(parts):
        return mesh.pmax(parts, axes)

    def elect(best, li, has):
        """Owner of the global max among the shards where ``has``: the
        global max value, the owner's point and its global index."""
        gbest = pmax(best)
        contends = [(b >= g) & h for b, g, h in zip(best, gbest, has)]
        tag = [torch.where(c, -float(s), neg_inf)
               for c, (s, _) in zip(contends, local)]
        owner = pmax(tag)
        is_owner = [c & (t >= o) for c, t, o in zip(contends, tag, owner)]
        cand = [torch.where(w, p.index_select(0, i.view(1)).view(-1),
                            neg_inf)
                for w, p, i in zip(is_owner, pts, li)]
        gidx = [torch.where(w, s * p.shape[0] + i.to(torch.int64), -1)
                for w, p, i, (s, _) in zip(is_owner, pts, li, local)]
        return gbest, pmax(cand), pmax(gidx)

    def pick(res):
        # K2 gives each shard's max of the masked min-distances (invalid
        # rows count as -1) and its first index
        best = [r[2] for r in res]
        li = [r[1].to(torch.int64) for r in res]
        has = [torch.ones((), dtype=torch.bool, device=b.device)
               for b in best]
        return elect(best, li, has)

    # anchor: the globally first valid point
    has = [torch.any(v) for v in valid]
    first = [torch.argmax(v.to(torch.int32)).to(torch.int64) for v in valid]
    zero = [torch.zeros((), dtype=torch.float32, device=v.device)
            for v in valid]
    _, anchor, anchor_idx = elect(zero, first, has)

    res = [ops.gmm_update(p, a, torch.full((p.shape[0],), torch.inf,
                                           dtype=torch.float32,
                                           device=p.device), v,
                          force=force, device=p.device)
           for p, a, v in zip(pts, anchor, valid)]
    md = [r[0] for r in res]
    delta, nxt, nxt_idx = pick(res)

    dev0 = pts[0].device
    centers = torch.zeros((tau, pts[0].shape[1]), dtype=pts[0].dtype,
                          device=dev0)
    center_idx = torch.full((tau,), -1, dtype=torch.int64, device=dev0)
    centers[0] = anchor[0]
    center_idx[:1] = anchor_idx[0]
    assign = [torch.zeros((p.shape[0],), dtype=torch.int32, device=p.device)
              for p in pts]
    for t in range(1, tau):
        centers[t] = nxt[0]
        center_idx[t:t + 1] = nxt_idx[0]
        res = [ops.gmm_update(p, z, m, v, force=force, device=p.device)
               for p, z, m, v in zip(pts, nxt, md, valid)]
        for a, r, m in zip(assign, res, md):
            a.masked_fill_(r[0] < m, t)  # strict, as the reference
        md = [r[0] for r in res]
        _, nxt, nxt_idx = pick(res)
    radius = pmax([torch.amax(torch.where(v, m, 0.0))
                   for v, m in zip(valid, md)])
    return (assign, md, centers, center_idx, delta[0].to(dev0),
            radius[0].to(dev0))


def distributed_coreset(
    mesh,
    points,  # (n, d) global, n divisible by #shards, or shard blocks
    cats,
    valid,
    spec: MatroidSpec,
    caps,
    k: int,
    tau: int,
    *,
    data_axes: Sequence[str] = ("data",),
    force: Optional[str] = None,
):
    """Global-GMM coreset: one traversal over all shards, then the same
    EXTRACT masks as ``seq_coreset`` evaluated shard-locally, gathered.

    Returns (coreset, radius, delta), the same on every rank. The
    centers' global row indices are ``_global_gmm_shard``'s.
    """
    data_axes = tuple(data_axes)
    shards = mesh.axis_size(data_axes)
    local = mesh.local_shards(data_axes)
    cap = default_capacity(spec, k, tau)
    pts = [shard_rows(points, s, shards, dev).to(torch.float32)
           for s, dev in local]
    cts = [shard_rows(cats, s, shards, dev) for s, dev in local]
    vld = [shard_rows(valid, s, shards, dev).to(torch.bool)
           for s, dev in local]
    assign, _md, _centers, _center_idx, delta, radius = _global_gmm_shard(
        mesh, pts, vld, tau, data_axes, force=force)
    parts = []
    for (s, dev), p, c, v, a in zip(local, pts, cts, vld, assign):
        c_caps = None if caps is None else torch.as_tensor(caps, device=dev)
        mask = extraction_mask(spec, a, c, c_caps, v, k, tau)
        parts.append(compress(p, c, mask, cap, base_index=s * p.shape[0]))
    gathered = Coreset(*(mesh.all_gather(list(leaf), data_axes)
                         for leaf in zip(*parts)))
    return gathered, radius, delta
