"""Coreset composition (paper §3: composability under union).

Reference: ``repro/core/compose.py``. If S_1, ..., S_m partition S and
T_i is an (eps, k)-coreset of S_i, then U_i T_i is an (eps, k)-coreset
of S. Any partition qualifies: the row-by-row deal of the ``vmap`` drive
(``core.streaming.ingest_batch_sharded``) and the batch-by-batch deal of
the serving layer's ``pipeline`` placement alike.

``union_coresets``       plain buffer concatenation: the exact union;
``snapshot_shards``      the union of a stacked per-shard ``StreamState``'s
                         coresets, shard-major;
``snapshot_at_epoch``    the union of whatever state collection a drive
                         owns (single, stacked or a list);
``compact_coreset``      the valid rows on the host (gathered on the
                         device first, so only they cross);
``merge_stream_states``  the union re-ingested through the tau-controlled
                         scan, back to one <= tau-center state, with the
                         delegates' global ``src_idx`` kept.

As in the reference, the union is ``core.coreset.concat_coresets``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .coreset import Coreset, concat_coresets
from .matroid import MatroidSpec
from .streaming import (
    StreamState,
    ingest_batch_donated,
    init_stream_state,
    shard_lane,
    snapshot_coreset,
)


def union_coresets(coresets: Sequence[Coreset]) -> Coreset:
    """Union of coresets of a partition = coreset of the whole (§3)."""
    return concat_coresets(list(coresets))


def unstack_shards(sts: StreamState) -> list[StreamState]:
    """Split a stacked per-shard state (leading shard axis) into a list of
    independent copies (later ingests into ``sts`` do not reach them)."""
    return [StreamState(*(t.clone() for t in shard_lane(sts, s)))
            for s in range(sts.cvalid.shape[0])]


def snapshot_shards(sts: StreamState) -> Coreset:
    """Union coreset of a stacked per-shard ``StreamState``.

    Rows are shard-major (shard 0's buffer order, then shard 1's, ...):
    the same order as ``union_coresets([snapshot_coreset(s) for s in
    shards])``.
    """
    d, gamma = sts.dp.shape[-1], sts.dc.shape[-1]
    valid = (sts.dv & sts.cvalid[..., None]).reshape(-1)
    return Coreset(
        points=sts.dp.reshape(-1, d),
        cats=sts.dc.reshape(-1, gamma),
        valid=valid,
        src_idx=torch.where(valid, sts.ds.reshape(-1), -1),
    )


def snapshot_at_epoch(
    states: Union[StreamState, Sequence[StreamState]],
) -> Coreset:
    """Union coreset of a drive's states: one ``StreamState``, a stacked
    one (leading shard axis, the ``vmap`` drive) or a list of per-shard
    states (the ``pipeline`` placement). Rows are shard-major in every
    case, so epochs of different drives of one deal compare row for row.
    """
    if isinstance(states, StreamState):
        if states.cvalid.dim() == 2:
            return snapshot_shards(states)
        return snapshot_coreset(states)
    return union_coresets([snapshot_coreset(s) for s in states])


def compact_coreset(cs: Coreset) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host (points, cats, src_idx int64) of the valid rows, buffer order;
    the rows are gathered on their device before the copy."""
    valid = cs.valid
    return (
        cs.points[valid].cpu().numpy(),
        cs.cats[valid].cpu().numpy(),
        cs.src_idx[valid].cpu().numpy().astype(np.int64),
    )


def merge_stream_states(
    states: Union[StreamState, Sequence[StreamState]],
    spec: MatroidSpec,
    caps,
    k: int,
    tau: int,
    *,
    variant: str = "radius",
    eps: float = 0.5,
    c_const: int = 32,
    slot_cap: Optional[int] = None,
    block_size: int = 1,
) -> StreamState:
    """Merge per-shard stream states into one <= tau-center state on their
    device: the union of the shards' delegates (a coreset of the whole
    stream, §3) streamed through the tau-controlled scan. ``states`` is a
    list of per-shard states or a stacked state."""
    if isinstance(states, StreamState):
        states = (unstack_shards(states) if states.cvalid.dim() == 2
                  else [states])
    union = union_coresets([snapshot_coreset(st) for st in states])
    v = union.valid
    P, C, S = union.points[v], union.cats[v], union.src_idx[v]
    if slot_cap is None:
        slot_cap = states[0].dv.shape[1]
    dev = states[0].centers.device
    st = init_stream_state(P.shape[1], C.shape[1], spec, k, tau,
                           slot_cap=slot_cap, device=dev)
    return ingest_batch_donated(
        st, P, C, np.ones(P.shape[0], bool), spec, caps, k, tau, src=S,
        variant=variant, eps=eps, c_const=c_const, block_size=block_size,
    )
