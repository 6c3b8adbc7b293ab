"""``solve_dmmc(setting="sequential")`` of the port against the JAX package.

The instances are tie-free, so the discrete outputs (selected indices and
coreset) must be equal, and the diversity within 1e-6 relative (the two
frameworks sum the coreset distance matrix in different orders). Both
coreset matrices carry matmul-form cancellation noise on the diagonal
(up to ~1e-3 after the sqrt), and the host solvers' sum and star values
include it, so the values are compared with each side's diagonal taken
out, and the diagonals held to the reference's own pdist margin.
"""
import numpy as np
import pytest
import jax.numpy as jnp

import repro.core as jcore
from conftest import make_clustered_points
from repro.core.geometry import normalize_for_metric
from repro.core.solvers import selection_value
from repro_torch import core

CPU = "cpu"


@pytest.fixture(scope="module")
def instance():
    """The tests/test_system.py instance."""
    rng = np.random.default_rng(11)
    n, h, k = 1500, 5, 5
    P = make_clustered_points(rng, n=n, d=8, centers=7, spread=0.05)
    cats = rng.integers(0, h, (n, 1)).astype(np.int32)
    caps = np.full(h, 2, np.int32)
    return P, cats, caps, h, k


def songs_like(n: int, seed: int = 0):
    """benchmarks/common.py's songs_like structure: 16 genres of Dirichlet
    sizes, 5-d latent centres, partition caps proportional to frequency."""
    rng = np.random.default_rng(seed + 1)
    h = 16
    sizes = rng.dirichlet(np.ones(h) * 0.5)
    genre = rng.choice(h, n, p=sizes)
    basis = rng.normal(size=(5, 100))
    centers = rng.normal(size=(h, 5)) * 2
    P = centers[genre] @ basis + 1.2 * rng.normal(size=(n, 100))
    counts = np.bincount(genre, minlength=h)
    caps = np.maximum(1, (counts / counts.sum() * 89)).astype(np.int32)
    return P.astype(np.float32), genre[:, None].astype(np.int32), caps, h


def _both(P, k, kind, h, **kw):
    got = core.solve_dmmc(P, k, core.MatroidSpec(kind, h, 1), device=CPU,
                          **kw)
    want = jcore.solve_dmmc(P, k, jcore.MatroidSpec(kind, h, 1), **kw)
    return got, want


def _value_without_diagonal(cdm, P, sol, metric, variant):
    """A solution's value over its coreset matrix with the diagonal taken
    out, after holding the diagonal to the 1e-5 x norms margin of the
    reference's kernels/ops._pdist_e2."""
    pts = np.array(normalize_for_metric(jnp.asarray(P), metric))
    rows = pts[sol.coreset_indices]
    D = np.array(cdm(rows))
    e2 = 1e-5 * 2 * np.sum(rows.astype(np.float64) ** 2, axis=1)
    assert np.all(np.diag(D).astype(np.float64) ** 2 <= e2)
    np.fill_diagonal(D, 0.0)
    local = np.searchsorted(sol.coreset_indices, sol.indices)
    return selection_value(D, local, variant)


def _assert_same(got, want, P, metric="euclidean", variant="sum"):
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.coreset_indices, want.coreset_indices)
    assert got.coreset_size == want.coreset_size
    mine = _value_without_diagonal(
        lambda r: core.coreset_distance_matrix(r, device=CPU), P, got,
        metric, variant)
    ref = _value_without_diagonal(jcore.coreset_distance_matrix, P, want,
                                  metric, variant)
    np.testing.assert_allclose(mine, ref, rtol=1e-6)
    for key in ("tau", "size"):
        assert got.info[key] == want.info[key]
    np.testing.assert_allclose(got.info["radius"], want.info["radius"],
                               rtol=1e-5)
    if variant not in ("sum", "star"):  # the diagonal is not in the value
        np.testing.assert_allclose(got.diversity, want.diversity, rtol=1e-6)
@pytest.mark.parametrize("tau,metric", [(64, "euclidean"), (32, "cosine")])
def test_sequential_matches_jax(instance, tau, metric):
    P, cats, caps, h, k = instance
    got, want = _both(P, k, "partition", h, cats=cats, caps=caps, tau=tau,
                      setting="sequential", metric=metric)
    _assert_same(got, want, P, metric)
    assert set(got.timings) == {"coreset_s", "solver_s", "total_s"}


@pytest.mark.parametrize("variant", ["sum", "star", "tree", "cycle",
                                     "bipartition"])
def test_all_variants_match_jax(instance, variant):
    P, cats, caps, h, _k = instance
    got, want = _both(P[:300], 4, "partition", h, cats=cats[:300], caps=caps,
                      tau=8, variant=variant, setting="sequential")
    _assert_same(got, want, P[:300], variant=variant)


def test_songs_like_matches_jax():
    P, cats, caps, h = songs_like(2000)
    got, want = _both(P, 22, "partition", h, cats=cats, caps=caps, tau=32,
                      metric="cosine")
    _assert_same(got, want, P, "cosine")


def test_radius_target_mode_matches_jax(instance):
    P, cats, caps, h, k = instance
    got, want = _both(P[:500], k, "partition", h, cats=cats[:500], caps=caps,
                      eps=0.5)
    _assert_same(got, want, P[:500])


@pytest.mark.parametrize("setting", ["mapreduce"])
def test_settings_not_ported_yet_raise(instance, setting):
    """Every setting is ported (MapReduce in step 11): without its mesh
    the mapreduce setting raises ``ValueError``; with one it selects a
    basis (its parity with the JAX package is
    ``tests/test_torch_mapreduce.py``)."""
    from repro_torch.launch import make_mesh

    P, cats, caps, h, k = instance
    spec = core.MatroidSpec("partition", h, 1)
    with pytest.raises(ValueError, match="mesh"):
        core.solve_dmmc(P, k, spec, cats=cats, caps=caps, tau=8,
                        setting=setting, device=CPU)
    sol = core.solve_dmmc(P, k, spec, cats=cats, caps=caps, tau=8,
                          setting=setting, device=CPU,
                          mesh=make_mesh((4,), ("data",), devices=[CPU] * 4))
    assert core.PartitionMatroid(cats[:, 0], caps).is_independent(
        list(sol.indices)) and len(sol.indices) == k


def test_songs_sim_generator_structure():
    from repro_torch.data import songs_sim

    P, cats, caps, spec = songs_sim(3000, 40, seed=3, device=CPU)
    P2, cats2, _, _ = songs_sim(3000, 40, seed=3, device=CPU)
    assert P.shape == (3000, 40) and cats.shape == (3000, 1)
    assert np.array_equal(P.numpy(), P2.numpy())
    assert np.array_equal(cats, cats2)
    assert spec.kind == "partition" and spec.num_categories == 16
    assert caps.shape == (16,) and caps.min() >= 1
    # floors of shares of 89 lose < 1 each; max(1, .) adds at most 1 each
    assert 89 - 16 <= caps.sum() <= 89 + 16
