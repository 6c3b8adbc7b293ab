"""The port's composition (§3) and single-card sharded drives on the CPU
against the JAX package's ``repro.core.compose`` and
``repro.core.streaming`` sharded drives.

The same numpy shards go through both. On tie-free data the discrete
state must be equal across the frameworks (cells, stream rows, counts, the
epoch triple), ``centers``/``dp``/``x1`` too (copies of input rows), ``R``
within 1e-6 relative. Inside the port, every lane of the stacked drive
must equal ``ingest_batch`` on that shard's sub-stream bit for bit.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import make_clustered_points
from repro.core import compose as jcompose
from repro.core import streaming as jstream
from repro.core.matroid import MatroidSpec as JSpec
from repro_torch import convert
from repro_torch.core import compose, streaming
from repro_torch.core.matroid import MatroidSpec, PartitionMatroid

CPU = "cpu"
DISCRETE = ("n_seen", "cvalid", "dv", "dc", "ds", "overflow")
KINDS = ["uniform", "partition", "transversal"]


def _instance(kind, seed=0, n=400, h=4, k=4):
    rng = np.random.default_rng(seed)
    P = make_clustered_points(rng, n=n)
    if kind == "uniform":
        return P, np.zeros((n, 1), np.int32), None, ("uniform", 0, 1), k
    if kind == "partition":
        cats = rng.integers(0, h, (n, 1)).astype(np.int32)
        return P, cats, np.full(h, 2, np.int32), ("partition", h, 1), k
    cats = np.full((n, 2), -1, np.int32)
    cats[:, 0] = rng.integers(0, h, n)
    extra = rng.random(n) < 0.4
    cats[extra, 1] = rng.integers(0, h, extra.sum())
    return P, cats, None, ("transversal", h, 2), 3


def _deal(P, cats, S, off=0):
    """Round-robin rows over S shards, padded with invalid rows."""
    n, d = P.shape
    gamma = cats.shape[1]
    mm = -(-n // S)
    Pb = np.zeros((S, mm, d), np.float32)
    Cb = np.full((S, mm, gamma), -1, np.int32)
    Vb = np.zeros((S, mm), bool)
    Sb = np.full((S, mm), -1, np.int32)
    for s in range(S):
        rows = np.arange(s, n, S)
        r = len(rows)
        Pb[s, :r] = P[rows]
        Cb[s, :r] = cats[rows]
        Vb[s, :r] = True
        Sb[s, :r] = off + rows
    return Pb, Cb, Vb, Sb


def _jax_sharded(P, cats, caps, sp, k, tau, S, parts, block_size=32):
    spec = JSpec(*sp)
    capj = None if caps is None else jnp.asarray(caps)
    sts = jstream.init_sharded_states(S, P.shape[1], cats.shape[1], spec,
                                      k, tau)
    off = 0
    for b in parts:
        arrs = _deal(P[off:off + b], cats[off:off + b], S, off)
        sts = jstream.ingest_batch_sharded(
            sts, *(jnp.asarray(a) for a in arrs), spec, capj, k, tau,
            block_size=block_size)
        off += b
    return sts


def _port_sharded(P, cats, caps, sp, k, tau, S, parts, block_size=32,
                  sts=None, off=0):
    spec = MatroidSpec(*sp)
    if sts is None:
        sts = streaming.init_sharded_states(S, P.shape[1], cats.shape[1],
                                            spec, k, tau, device=CPU)
    for b in parts:
        arrs = _deal(P[off:off + b], cats[off:off + b], S, off)
        sts = streaming.ingest_batch_sharded(sts, *arrs, spec, caps, k, tau,
                                             block_size=block_size)
        off += b
    return sts


def _assert_matches_jax(st, jst):
    got = streaming.state_to_arrays(st)
    want = jstream.state_to_arrays(jst)
    for f in DISCRETE + ("centers", "dp", "x1"):
        assert got[f].dtype == want[f].dtype, f
        assert np.array_equal(got[f], want[f]), f"field {f} differs"
    np.testing.assert_allclose(got["R"], want["R"], rtol=1e-6)
    assert ([int(v) for v in streaming.epoch_stats(st)]
            == [int(v) for v in jstream.epoch_stats(jst)])
    assert streaming.epoch_fingerprint(st) == jstream.epoch_fingerprint(jst)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_drive_matches_jax_and_per_shard_scans(kind):
    P, cats, caps, sp, k = _instance(kind)
    n, tau, S = P.shape[0], 10, 4
    jsts = _jax_sharded(P, cats, caps, sp, k, tau, S, [n])
    sts = _port_sharded(P, cats, caps, sp, k, tau, S, [n])
    _assert_matches_jax(sts, jsts)
    # each lane is the plain scan of its sub-stream alone
    spec = MatroidSpec(*sp)
    for s, lane in enumerate(compose.unstack_shards(sts)):
        rows = np.arange(s, n, S)
        ref = streaming.init_stream_state(P.shape[1], cats.shape[1], spec,
                                          k, tau, device=CPU)
        ref = streaming.ingest_batch(
            ref, P[rows], cats[rows], np.ones(len(rows), bool), spec, caps,
            k, tau, src=rows, block_size=1)
        for f in streaming.StreamState._fields:
            assert torch.equal(getattr(ref, f), getattr(lane, f)), (s, f)


def test_sharded_drive_consumes_only_the_donated_state():
    P, cats, caps, sp, k = _instance("partition")
    spec = MatroidSpec(*sp)
    sts0 = streaming.init_sharded_states(3, P.shape[1], 1, spec, k, 10,
                                         device=CPU)
    before = [t.clone() for t in sts0]
    arrs = _deal(P, cats, 3)
    out = streaming.ingest_batch_sharded(sts0, *arrs, spec, caps, k, 10)
    for a, b in zip(sts0, before):
        assert torch.equal(a, b)  # the non-donated call copies
    don = streaming.ingest_batch_sharded_donated(sts0, *arrs, spec, caps, k,
                                                 10)
    assert don.dp.data_ptr() == sts0.dp.data_ptr()  # updated in place
    for a, b in zip(don, out):
        assert torch.equal(a, b)


def test_snapshot_shards_is_union_and_matches_jax():
    P, cats, caps, sp, k = _instance("partition")
    tau, S = 10, 3
    sts = _port_sharded(P, cats, caps, sp, k, tau, S, [P.shape[0]])
    jsts = _jax_sharded(P, cats, caps, sp, k, tau, S, [P.shape[0]])
    union = compose.snapshot_shards(sts)
    manual = compose.union_coresets(
        [streaming.snapshot_coreset(st) for st in compose.unstack_shards(sts)])
    for f in union._fields:
        assert torch.equal(getattr(union, f), getattr(manual, f)), f
    pts, cts, src = compose.compact_coreset(union)
    jpts, jcts, jsrc = jcompose.compact_coreset(jcompose.snapshot_shards(jsts))
    assert np.array_equal(src, jsrc) and src.dtype == np.int64
    assert np.array_equal(cts, jcts) and np.array_equal(pts, jpts)
    assert len(set(src.tolist())) == len(src)  # shards partition the stream
    # snapshot_at_epoch dispatches on the layout: stacked, list, single
    for states in (sts, compose.unstack_shards(sts)):
        got = compose.compact_coreset(compose.snapshot_at_epoch(states))
        assert np.array_equal(got[2], src)
    lane = compose.unstack_shards(sts)[1]
    single = compose.compact_coreset(compose.snapshot_at_epoch(lane))
    want = jcompose.compact_coreset(jcompose.snapshot_at_epoch(
        jcompose.unstack_shards(jsts)[1]))
    assert np.array_equal(single[2], want[2])


def test_merge_refilters_to_tau_centers_as_jax():
    P, cats, caps, sp, k = _instance("partition", n=600)
    tau, S = 8, 4
    sts = _port_sharded(P, cats, caps, sp, k, tau, S, [P.shape[0]])
    jsts = _jax_sharded(P, cats, caps, sp, k, tau, S, [P.shape[0]])
    merged = compose.merge_stream_states(sts, MatroidSpec(*sp), caps, k, tau)
    jmerged = jcompose.merge_stream_states(jsts, JSpec(*sp),
                                           jnp.asarray(caps), k, tau)
    _assert_matches_jax(merged, jmerged)
    assert int(merged.cvalid.sum()) <= tau
    pts_m, cats_m, src_m = compose.compact_coreset(
        streaming.snapshot_coreset(merged))
    assert set(src_m.tolist()) <= set(range(P.shape[0]))
    assert np.allclose(pts_m, P[src_m], atol=1e-6)
    assert np.array_equal(cats_m, cats[src_m])
    m = PartitionMatroid(cats[:, 0], caps)
    assert len(m.greedy_independent([int(s) for s in src_m], k)) == k


def test_merge_accepts_list_of_states():
    P, cats, caps, sp, k = _instance("partition", n=300)
    spec = MatroidSpec(*sp)
    tau = 8
    halves = []
    for rows in (np.arange(0, 150), np.arange(150, 300)):
        st = streaming.init_stream_state(P.shape[1], 1, spec, k, tau,
                                         device=CPU)
        halves.append(streaming.ingest_batch(
            st, P[rows], cats[rows], np.ones(len(rows), bool), spec, caps,
            k, tau, src=rows))
    merged = compose.merge_stream_states(halves, spec, caps, k, tau)
    assert int(merged.cvalid.sum()) <= tau
    _, _, src_m = compose.compact_coreset(streaming.snapshot_coreset(merged))
    assert len(src_m) > 0
    solo = compose.merge_stream_states(halves[0], spec, caps, k, tau)
    assert int(solo.cvalid.sum()) <= tau


def test_placement_resolution_and_mesh_count():
    for pl in ("vmap", "pipeline"):
        assert streaming.resolve_placement(pl, 2, CPU) == pl
    assert streaming.resolve_placement("auto", 1, CPU) == "vmap"
    assert streaming.resolve_placement("auto", 3, CPU) == "pipeline"
    assert streaming.resolve_placement("auto", 3, "cuda") == "vmap"
    assert streaming.resolve_placement("shard_map", 2, CPU) == "shard_map"
    with pytest.raises(ValueError, match="placement"):
        streaming.resolve_placement("nope", 2, CPU)
    for S in (1, 2, 3, 4, 6, 8, 12):
        for nd in (1, 2, 3, 4, 8):
            assert (streaming.mesh_device_count(S, nd)
                    == jstream.mesh_device_count(S, nd)), (S, nd)


@pytest.mark.parametrize("kind", ["partition", "transversal"])
def test_reference_stacked_state_continues_in_the_port(kind):
    """A JAX stacked shard state after some batches, carried over with
    ``convert.stream_state_from_arrays``, continues to the state the
    reference reaches."""
    P, cats, caps, sp, k = _instance(kind, seed=3)
    tau, S = 10, 3
    jmid = _jax_sharded(P, cats, caps, sp, k, tau, S, [150])
    jend = _jax_sharded(P, cats, caps, sp, k, tau, S, [150, 250])
    sts = convert.stream_state_from_arrays(jstream.state_to_arrays(jmid),
                                           device=CPU)
    assert sts.cvalid.shape[0] == S
    sts = _port_sharded(P, cats, caps, sp, k, tau, S, [250], sts=sts,
                        off=150)
    _assert_matches_jax(sts, jend)
