"""The port's core modules on the CPU against the JAX package's.

Same inputs, made from a seed with numpy, go through both packages; the
port runs with ``device="cpu"``, the JAX side through its normal CPU
dispatch. Discrete outputs must be equal (the inputs are tie-free) and
floats within the stated tolerances.
"""
import importlib
import itertools

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import make_clustered_points
from repro_torch import convert
from repro_torch.core.solvers import coverage_matrix, registered_engines


def _modules(pkg):
    # by module path: the packages re-export functions under module names
    return [importlib.import_module(f"{pkg}.core.{m}") for m in
            ("coreset", "diversity", "final_solve", "geometry", "gmm",
             "matroid")]


jcoreset, jdiv, jfinal, jgeo, jgmm, jmat = _modules("repro")
coreset, diversity, final_solve, geometry, gmm, matroid = _modules(
    "repro_torch")

CPU = "cpu"


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "sqeuclidean"])
def test_normalize_for_metric(metric):
    x = np.random.default_rng(0).normal(size=(50, 7)).astype(np.float32)
    x[3] = 0.0  # the eps clamp
    got = geometry.normalize_for_metric(torch.as_tensor(x), metric).numpy()
    want = np.asarray(jgeo.normalize_for_metric(jnp.asarray(x), metric))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_geometry_helpers():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(30, 5)).astype(np.float32)
    y = rng.normal(size=(20, 5)).astype(np.float32)
    valid = rng.random(30) > 0.3
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    pairs = [
        (geometry.dists(xt, yt), jgeo.dists(xj, yj)),
        (geometry.point_dists(xt, yt[0]), jgeo.point_dists(xj, yj[0])),
        (geometry.pairwise_matrix(xt), jgeo.pairwise_matrix(xj)),
        (geometry.diameter_lower_bound(xt, torch.as_tensor(valid)),
         jgeo.diameter_lower_bound(xj, jnp.asarray(valid))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("variant", jdiv.VARIANTS)
@pytest.mark.parametrize("k", [1, 2, 5, 9, 13, 17])
def test_host_diversity_every_variant(variant, k):
    rng = np.random.default_rng(100 + k)
    P = rng.normal(size=(k, 4))
    D = np.sqrt(((P[:, None] - P[None]) ** 2).sum(-1))
    assert diversity.diversity(D, variant) == jdiv.diversity(D, variant)
    assert diversity.f_of_k(variant, k) == jdiv.f_of_k(variant, k)
    assert diversity.farness_lower_bound(3.0, k + 1, variant) == \
        jdiv.farness_lower_bound(3.0, k + 1, variant)
    got = diversity.diversity_of_points(P.astype(np.float32), variant,
                                        device=CPU)
    want = jdiv.diversity_of_points(P.astype(np.float32), variant)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _random_sets(rng, n, count=60):
    for _ in range(count):
        size = int(rng.integers(0, 7))
        yield [int(i) for i in rng.choice(n, size, replace=size > n)]


@pytest.mark.parametrize("kind", ["uniform", "partition", "transversal",
                                  "general"])
def test_matroid_oracles_on_random_sets(kind):
    rng = np.random.default_rng(7)
    n, h = 40, 4
    if kind == "transversal":
        cats = np.full((n, 2), -1, np.int32)
        cats[:, 0] = rng.integers(0, h, n)
        extra = rng.random(n) < 0.4
        cats[extra, 1] = rng.integers(0, h, extra.sum())
    else:
        cats = rng.integers(0, h, (n, 1)).astype(np.int32)
    caps = np.array([2, 1, 3, 1], np.int32)
    oracle = (lambda s: len(s) <= 3 and sum(s) % 5 != 0)
    specs = {
        "uniform": ("uniform", 0, 1), "partition": ("partition", h, 1),
        "transversal": ("transversal", h, 2), "general": ("general", 0, 1),
    }
    kw = dict(zip(("kind", "num_categories", "gamma"), specs[kind]))
    mine = matroid.make_host_matroid(matroid.MatroidSpec(**kw), cats, caps,
                                     n, 4, oracle)
    ref = jmat.make_host_matroid(jmat.MatroidSpec(**kw), cats, caps, n, 4,
                                 oracle)
    assert type(mine).__name__ == type(ref).__name__
    for s in _random_sets(rng, n):
        assert mine.is_independent(s) == ref.is_independent(s)
        assert mine.rank_of(s) == ref.rank_of(s)
        assert mine.greedy_independent(s, 3) == ref.greedy_independent(s, 3)
        if s and ref.is_independent(s[:-1]):
            assert mine.can_extend(s[:-1], s[-1]) == \
                ref.can_extend(s[:-1], s[-1])
    if kind in ("partition", "transversal"):
        assert mine.rank == ref.rank


def _gmm_pair(n, d, seed, **kw):
    rng = np.random.default_rng(seed)
    P = make_clustered_points(rng, n=n, d=d, centers=6, spread=0.05)
    valid = rng.random(n) > 0.05
    ref = jgmm.gmm(jnp.asarray(P), jnp.asarray(valid), **kw)
    got = gmm.gmm(P, valid, device=CPU, **kw)
    return got, ref


@pytest.mark.parametrize("kw", [
    dict(tau_max=12), dict(tau_max=40),
    dict(tau_max=64, k=3, eps=0.5, use_radius_target=True),
    dict(tau_max=10, k=2, eps=0.1, use_radius_target=True),
])
def test_gmm_matches_jax(kw):
    got, ref = _gmm_pair(500, 6, 3, **kw)
    assert got.num_centers == int(ref.num_centers)
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(ref.centers))
    np.testing.assert_array_equal(got.assign.numpy(), np.asarray(ref.assign))
    for a, b in ((got.radius, ref.radius), (got.delta, ref.delta),
                 (got.min_dist, ref.min_dist)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_gmm_fixed_and_radius_wrappers():
    rng = np.random.default_rng(4)
    P = make_clustered_points(rng, n=200, d=5)
    valid = np.ones(200, bool)
    a = gmm.gmm_fixed(P, valid, 9, device=CPU)
    b = jgmm.gmm_fixed(jnp.asarray(P), jnp.asarray(valid), 9)
    np.testing.assert_array_equal(a.assign.numpy(), np.asarray(b.assign))
    a = gmm.gmm_radius(P, valid, 3, 0.4, 50, device=CPU)
    b = jgmm.gmm_radius(jnp.asarray(P), jnp.asarray(valid), 3, 0.4, 50)
    assert a.num_centers == int(b.num_centers)
    np.testing.assert_array_equal(a.assign.numpy(), np.asarray(b.assign))


def _instance(kind, seed=5, n=400):
    rng = np.random.default_rng(seed)
    P = make_clustered_points(rng, n=n, d=6, centers=7, spread=0.05)
    h = 4
    if kind == "transversal":
        cats = np.full((n, 2), -1, np.int32)
        cats[:, 0] = rng.integers(0, h, n)
        extra = rng.random(n) < 0.4
        cats[extra, 1] = rng.integers(0, h, extra.sum())
        return P, cats, None, (kind, h, 2)
    cats = rng.integers(0, h, (n, 1)).astype(np.int32)
    caps = np.array([2, 1, 2, 1], np.int32)
    return P, cats, caps, (kind, h if kind == "partition" else 0, 1)


@pytest.mark.parametrize("kind", ["uniform", "partition", "transversal"])
@pytest.mark.parametrize("mode", [dict(tau=16), dict(eps=0.5)])
def test_seq_coreset_host_matches_jax(kind, mode):
    P, cats, caps, spec = _instance(kind)
    k = 4
    got, ginfo = coreset.seq_coreset_host(
        P, cats, matroid.MatroidSpec(*spec), caps, k, device=CPU, **mode)
    want, winfo = jcoreset.seq_coreset_host(
        P, cats, jmat.MatroidSpec(*spec), caps, k, **mode)
    np.testing.assert_array_equal(got, want)
    assert ginfo["tau"] == winfo["tau"] and ginfo["size"] == winfo["size"]
    np.testing.assert_allclose(ginfo["radius"], winfo["radius"], rtol=1e-5)


@pytest.mark.parametrize("kind", ["partition", "transversal"])
def test_extract_from_jax_gmm(kind):
    """The JAX GMM's clustering, carried across, drives the port's EXTRACT
    to the JAX coreset."""
    P, cats, caps, spec = _instance(kind, seed=9)
    k, tau = 3, 12
    res = jgmm.gmm(jnp.asarray(P), jnp.ones(len(P), bool), tau_max=tau)
    arrays = {f: np.asarray(v) for f, v in res._asdict().items()}
    mine = convert.gmm_result_from_arrays(arrays, device=CPU)
    got, _ = coreset.extract_host(mine, cats, matroid.MatroidSpec(*spec),
                                  caps, k)
    want, _ = jcoreset.seq_coreset_host(P, cats, jmat.MatroidSpec(*spec),
                                        caps, k, tau=tau)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_coreset_distance_matrix_matches_jax(metric):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(90, 11)).astype(np.float32)
    pts = np.array(jgeo.normalize_for_metric(jnp.asarray(pts), metric))
    got = final_solve.coreset_distance_matrix(pts, device=CPU)
    want = jfinal.coreset_distance_matrix(pts)
    assert got.dtype == np.float32 and got.shape == (90, 90)
    off = ~np.eye(90, dtype=bool)
    np.testing.assert_allclose(got[off], want[off], rtol=1e-5, atol=1e-5)
    # on the diagonal both keep the matmul form's cancellation noise, which
    # the sqrt magnifies: hold it to the reference's own squared-space
    # margin, 1e-5 x the operand norms (kernels/ops._pdist_e2)
    e2 = 1e-5 * 2 * np.sum(pts.astype(np.float64) ** 2, axis=1)
    assert np.all(np.diag(got).astype(np.float64) ** 2 <= e2)
    assert np.all(np.diag(want).astype(np.float64) ** 2 <= e2)


@pytest.mark.parametrize("variant", jdiv.VARIANTS)
@pytest.mark.parametrize("kind", ["partition", "transversal"])
def test_final_solve_host_matches_jax(variant, kind):
    P, cats, caps, spec = _instance(kind, seed=13, n=24)
    D = np.asarray(jfinal.coreset_distance_matrix(P))
    k = 4
    sub = np.arange(3, 21)
    mine = final_solve.SubsetMatroidView(
        matroid.make_host_matroid(matroid.MatroidSpec(*spec), cats, caps,
                                  len(P), k), sub)
    ref = jfinal.SubsetMatroidView(
        jmat.make_host_matroid(jmat.MatroidSpec(*spec), cats, caps, len(P),
                               k), sub)
    Dsub = D[np.ix_(sub, sub)]
    X, val = final_solve.final_solve(Dsub, mine, k, variant, engine="host")
    Xr, valr = jfinal.final_solve(Dsub, ref, k, variant, engine="host")
    assert X == Xr
    np.testing.assert_allclose(val, valr, rtol=1e-9)


def test_registry_has_only_host_engines():
    """The registry holds the reference's engines: the two host engines
    and, since the batched engines were ported, ``jit_sum`` and
    ``jit_greedy``, with the reference's order and coverage."""
    import repro.core.solvers as jsolvers

    names = [e.name for e in registered_engines()]
    assert names == [e.name for e in jsolvers.registered_engines()]
    assert names == ["jit_sum", "jit_greedy", "host_local_search",
                     "host_exhaustive"]
    cov = coverage_matrix()
    assert cov == jsolvers.coverage_matrix()
    for (variant, _kind), names in cov.items():
        host = "host_local_search" if variant == "sum" else "host_exhaustive"
        assert names[-1] == host


def test_convert_round_trips():
    P, cats, caps, spec = _instance("partition", seed=21)
    res = jgmm.gmm(jnp.asarray(P), jnp.ones(len(P), bool), tau_max=8)
    arrays = {f: np.asarray(v) for f, v in res._asdict().items()}
    back = convert.to_arrays(convert.gmm_result_from_arrays(arrays,
                                                            device=CPU))
    for name, a in arrays.items():
        np.testing.assert_array_equal(np.asarray(back[name]), a)
        if name != "num_centers":
            assert np.asarray(back[name]).dtype == a.dtype, name

    cs, _res, _ovf = jcoreset.seq_coreset(
        jnp.asarray(P), jnp.asarray(cats), jnp.ones(len(P), bool),
        jmat.MatroidSpec(*spec), jnp.asarray(caps), 3, 8)
    arrays = {f: np.asarray(v) for f, v in cs._asdict().items()}
    mine = convert.coreset_from_arrays(arrays, device=CPU)
    assert mine.capacity == arrays["points"].shape[0]
    assert int(mine.size()) == int(cs.size())
    back = convert.to_arrays(mine)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a)
        assert back[name].dtype == a.dtype, name

    sol = dict(indices=np.array([3, 1]), diversity=2.5,
               coreset_indices=np.array([1, 3, 5]), coreset_size=3,
               timings={"total_s": 0.1}, info={"tau": 8})
    back = convert.to_arrays(convert.solution_from_arrays(sol))
    for name, v in sol.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(back[name], v)
        else:
            assert back[name] == v


def test_default_capacity_matches_jax():
    for kind, h, gamma, k, tau in itertools.product(
            ["uniform", "partition", "transversal"], [3, 16], [1, 3], [2, 5],
            [4, 64]):
        mine = coreset.default_capacity(matroid.MatroidSpec(kind, h, gamma),
                                        k, tau)
        assert mine == jcoreset.default_capacity(
            jmat.MatroidSpec(kind, h, gamma), k, tau)
