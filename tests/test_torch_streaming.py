"""The port's streaming setting (Alg. 2 scan) on the CPU against the JAX
package's ``repro.core.streaming``.

Inputs are numpy arrays from a seed, fed to both. The instances are
tie-free, so the discrete state must be equal across the frameworks
(cells, stream rows, counts, the epoch triple); ``centers`` and ``dp`` are
copies of input rows and must be equal too, and ``R`` within 1e-6
relative (the frameworks sum distances in other orders). Inside the port,
the blocked scan must equal the per-point scan bit for bit.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core as jcore
from conftest import make_clustered_points
from repro.core import streaming as jstream
from repro.core.matroid import MatroidSpec as JSpec
from repro.core.solvers.matching import (
    cats_onehot as j_cats_onehot,
    greedy_matching_slots as j_greedy,
)
from repro_torch import convert, core
from repro_torch.core import streaming
from repro_torch.core.matroid import MatroidSpec, PartitionMatroid
from repro_torch.core.solvers import matching

CPU = "cpu"
KINDS = ["uniform", "partition", "transversal"]
DISCRETE = ("n_seen", "cvalid", "dv", "dc", "ds", "overflow")


def _instance(kind, seed, n, centers=12, spread=0.4, d=6):
    """tests/test_blocked_ingest.py's three matroid kinds on clustered
    points; more clusters than tau, so restructures run."""
    rng = np.random.default_rng(seed)
    P = make_clustered_points(rng, n=n, d=d, centers=centers, spread=spread)
    if kind == "uniform":
        return P, np.zeros((n, 1), np.int32), None, ("uniform", 0, 1), 3
    if kind == "partition":
        cats = rng.integers(0, 3, (n, 1)).astype(np.int32)
        return P, cats, np.full(3, 2, np.int32), ("partition", 3, 1), 3
    cats = np.full((n, 2), -1, np.int32)
    cats[:, 0] = rng.integers(0, 3, n)
    extra = rng.random(n) < 0.5
    cats[extra, 1] = rng.integers(0, 3, extra.sum())
    return P, cats, None, ("transversal", 3, 2), 2


def _jax_ingest(P, cats, caps, sp, k, tau, splits, **kw):
    spec = JSpec(*sp)
    capj = None if caps is None else jnp.asarray(caps)
    st = jstream.init_stream_state(P.shape[1], cats.shape[1], spec, k, tau,
                                   slot_cap=kw.pop("slot_cap", None))
    off = 0
    for b in splits:
        st = jstream.ingest_batch(
            st, jnp.asarray(P[off:off + b]), jnp.asarray(cats[off:off + b]),
            jnp.ones((b,), bool), spec, capj, k, tau, base_index=off, **kw)
        off += b
    return st


def _port_ingest(P, cats, caps, sp, k, tau, splits, st=None, off=0, **kw):
    spec = MatroidSpec(*sp)
    if st is None:
        st = streaming.init_stream_state(
            P.shape[1], cats.shape[1], spec, k, tau,
            slot_cap=kw.pop("slot_cap", None), device=CPU)
    for b in splits:
        st = streaming.ingest_batch(
            st, P[off:off + b], cats[off:off + b], np.ones(b, bool), spec,
            caps, k, tau, base_index=off, **kw)
        off += b
    return st


def _assert_matches_jax(st, jst):
    got = streaming.state_to_arrays(st)
    want = jstream.state_to_arrays(jst)
    assert set(got) == set(want)
    for f in DISCRETE + ("centers", "dp", "x1"):
        assert got[f].dtype == want[f].dtype, f
        assert np.array_equal(got[f], want[f]), f"field {f} differs"
    np.testing.assert_allclose(got["R"], want["R"], rtol=1e-6)
    assert ([int(v) for v in streaming.epoch_stats(st)]
            == [int(v) for v in jstream.epoch_stats(jst)])
    assert streaming.epoch_fingerprint(st) == jstream.epoch_fingerprint(jst)


def _assert_same_state(a, b, label):
    for f in streaming.StreamState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{label}: {f}"


@pytest.mark.parametrize("variant", ["radius", "diameter"])
@pytest.mark.parametrize("kind", KINDS)
def test_scan_matches_jax(kind, variant):
    n, tau = 300, 4
    P, cats, caps, sp, k = _instance(kind, 0, n)
    jst = _jax_ingest(P, cats, caps, sp, k, tau, [n], variant=variant,
                      block_size=1)
    streaming.reset_scan_counts()
    st = _port_ingest(P, cats, caps, sp, k, tau, [n], variant=variant)
    _assert_matches_jax(st, jst)
    counts = streaming.scan_counts()
    assert counts["blocks"] == -(-n // 128)
    if variant == "radius":
        assert counts["restructures"] > 0  # the merge path ran


@pytest.mark.parametrize("variant", ["radius", "diameter"])
@pytest.mark.parametrize("kind", KINDS)
def test_blocked_equals_per_point(kind, variant):
    n, tau = 150, 4
    P, cats, caps, sp, k = _instance(kind, 1, n)
    per_point = _port_ingest(P, cats, caps, sp, k, tau, [n], block_size=1,
                             variant=variant)
    for bs in (3, 16, 50):
        st = _port_ingest(P, cats, caps, sp, k, tau, [n], block_size=bs,
                          variant=variant)
        _assert_same_state(per_point, st, f"block={bs}")
    ragged = _port_ingest(P, cats, caps, sp, k, tau, [47, 30, 73],
                          block_size=16, variant=variant)
    _assert_same_state(per_point, ragged, "ragged [47, 30, 73]")


@pytest.mark.parametrize("variant", ["radius", "diameter"])
def test_restructure_and_overflow_paths_match_jax(variant):
    """A stream sorted by distance from its first point (the diameter
    estimate keeps growing, so R updates and restructures run) under a
    transversal matroid with two slots per center (forced discards)."""
    n, tau = 300, 4
    P, cats, caps, sp, k = _instance("transversal", 5, n)
    P = P[np.argsort(np.linalg.norm(P - P[0], axis=1), kind="stable")]
    kw = dict(variant=variant, eps=0.9, c_const=1, slot_cap=2)
    jst = _jax_ingest(P, cats, caps, sp, k, tau, [n], block_size=1,
                      **dict(kw))
    streaming.reset_scan_counts()
    st = _port_ingest(P, cats, caps, sp, k, tau, [n], block_size=16,
                      **dict(kw))
    _assert_matches_jax(st, jst)
    assert int(st.overflow) > 0
    assert streaming.scan_counts()["restructures"] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_state_carried_from_jax(kind):
    """JAX ingests the first 70 points, the port the rest: the same state
    as JAX ingesting all of it."""
    n, tau = 200, 4
    P, cats, caps, sp, k = _instance(kind, 2, n)
    j70 = _jax_ingest(P[:70], cats[:70], caps, sp, k, tau, [70])
    st = convert.stream_state_from_arrays(jstream.state_to_arrays(j70),
                                          device=CPU)
    st = _port_ingest(P, cats, caps, sp, k, tau, [n - 70], st=st, off=70)
    _assert_matches_jax(st, _jax_ingest(P, cats, caps, sp, k, tau, [n]))


def test_ingest_batch_keeps_the_callers_state_and_donated_consumes_it():
    n, tau = 100, 4
    P, cats, caps, sp, k = _instance("partition", 3, n)
    spec = MatroidSpec(*sp)
    st0 = streaming.init_stream_state(6, 1, spec, k, tau, device=CPU)
    before = streaming.state_to_arrays(st0)
    st1 = streaming.ingest_batch(st0, P, cats, np.ones(n, bool), spec, caps,
                                 k, tau)
    for f, v in streaming.state_to_arrays(st0).items():
        assert np.array_equal(v, before[f]), f
    st2 = streaming.ingest_batch_donated(st0, P, cats, np.ones(n, bool),
                                         spec, caps, k, tau)
    assert st2.dp is st0.dp
    _assert_same_state(st1, st2, "donated")


def test_invalid_rows_and_step_impls():
    """Invalid rows are skipped without counting; both step names give the
    same state; an unknown name raises."""
    n, tau = 120, 4
    P, cats, caps, sp, k = _instance("partition", 4, n)
    spec = MatroidSpec(*sp)
    valid = np.random.default_rng(0).random(n) > 0.3
    states = []
    for impl, bs in (("branchless", 16), ("reference", 16),
                     ("branchless", 1)):
        st = streaming.init_stream_state(6, 1, spec, k, tau, device=CPU)
        states.append(streaming.ingest_batch(
            st, P, cats, valid, spec, caps, k, tau, block_size=bs,
            step_impl=impl))
    for st in states[1:]:
        _assert_same_state(states[0], st, "step_impl")
    assert int(states[0].n_seen) == valid.sum()
    jst = jstream.ingest_batch(
        jstream.init_stream_state(6, 1, JSpec(*sp), k, tau), jnp.asarray(P),
        jnp.asarray(cats), jnp.asarray(valid), JSpec(*sp), jnp.asarray(caps),
        k, tau)
    _assert_matches_jax(states[0], jst)
    with pytest.raises(ValueError, match="step_impl"):
        streaming.ingest_batch(states[0], P, cats, valid, spec, caps, k, tau,
                               step_impl="masked")


@pytest.mark.parametrize("force", [None, "ref", "exact"])
def test_precheck_paths_give_the_same_state(force):
    n, tau = 150, 4
    P, cats, caps, sp, k = _instance("uniform", 6, n)
    base = _port_ingest(P, cats, caps, sp, k, tau, [n], block_size=1)
    st = _port_ingest(P, cats, caps, sp, k, tau, [n], block_size=32,
                      force=force)
    _assert_same_state(base, st, f"force={force}")


def test_snapshot_and_stream_coreset_match_jax():
    n, tau = 200, 4
    P, cats, caps, sp, k = _instance("partition", 7, n)
    cs, st = streaming.stream_coreset(P, cats, np.ones(n, bool),
                                      MatroidSpec(*sp), caps, k, tau,
                                      device=CPU)
    jcs, _ = jstream.stream_coreset(jnp.asarray(P), jnp.asarray(cats),
                                    jnp.ones(n, bool), JSpec(*sp),
                                    jnp.asarray(caps), k, tau)
    for f in ("cats", "valid", "src_idx", "points"):
        assert np.array_equal(getattr(cs, f).numpy(),
                              np.asarray(getattr(jcs, f))), f
    assert int(cs.size()) == int(st.dv.sum())


def test_greedy_matching_and_onehot_match_jax():
    rng = np.random.default_rng(8)
    for _ in range(20):
        cats = rng.integers(-1, 5, size=(12, 3)).astype(np.int32)
        valid = rng.random(12) > 0.3
        used, matched = matching.greedy_matching_slots(cats, valid, 4)
        j_used, j_matched = j_greedy(jnp.asarray(cats), jnp.asarray(valid), 4)
        assert np.array_equal(used, np.asarray(j_used))
        assert np.array_equal(matched, np.asarray(j_matched))
        assert np.array_equal(matching.cats_onehot(np.clip(cats, -1, 3), 4),
                              j_cats_onehot(np.clip(cats, -1, 3), 4))


def test_stream_coreset_host_matches_jax():
    rng = np.random.default_rng(9)
    n, h = 120, 3
    P = make_clustered_points(rng, n=n, d=4, centers=8, spread=0.3)
    cats = rng.integers(0, h, n)
    caps = np.full(h, 2)
    got = streaming.stream_coreset_host(P, cats[:, None],
                                        PartitionMatroid(cats, caps), 3, 4)
    want = jstream.stream_coreset_host(
        P, cats[:, None], jcore.PartitionMatroid(cats, caps), 3, 4)
    assert np.array_equal(got, want)


def test_init_stream_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        streaming.init_stream_state(4, 1, MatroidSpec("uniform"), 3, 4)
    with pytest.raises(ValueError, match="tau"):
        streaming.init_stream_state(4, 1, MatroidSpec("uniform"), 3, 1,
                                    device=CPU)


def _streaming_value(sol, P, cdm, metric):
    """The sum value of a solution over its coreset matrix with the
    diagonal taken out (the coreset is in buffer order here)."""
    from repro.core.geometry import normalize_for_metric
    from repro.core.solvers import selection_value

    rows = np.array(normalize_for_metric(jnp.asarray(P), metric))
    D = np.array(cdm(rows[sol.coreset_indices]))
    np.fill_diagonal(D, 0.0)
    pos = {int(v): i for i, v in enumerate(sol.coreset_indices)}
    return selection_value(D, [pos[int(i)] for i in sol.indices], "sum")


@pytest.mark.parametrize("data", ["system", "songs_like"])
def test_streaming_solve_matches_jax(data):
    from test_torch_solve import songs_like

    if data == "system":
        rng = np.random.default_rng(11)
        n, h, k, tau, metric = 1500, 5, 5, 16, "euclidean"
        P = make_clustered_points(rng, n=n, d=8, centers=7, spread=0.05)
        cats = rng.integers(0, h, (n, 1)).astype(np.int32)
        caps = np.full(h, 2, np.int32)
    else:
        P, cats, caps, h = songs_like(2000)
        k, tau, metric = 22, 32, "cosine"
    kw = dict(cats=cats, caps=caps, tau=tau, setting="streaming",
              metric=metric)
    got = core.solve_dmmc(P, k, MatroidSpec("partition", h, 1), device=CPU,
                          **kw)
    want = jcore.solve_dmmc(P, k, jcore.MatroidSpec("partition", h, 1), **kw)
    np.testing.assert_array_equal(got.coreset_indices, want.coreset_indices)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.coreset_size == want.coreset_size
    assert got.info == want.info
    mine = _streaming_value(
        got, P, lambda r: core.coreset_distance_matrix(r, device=CPU), metric)
    ref = _streaming_value(want, P, jcore.coreset_distance_matrix, metric)
    np.testing.assert_allclose(mine, ref, rtol=1e-6)
