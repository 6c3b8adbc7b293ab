"""The MapReduce setting of the port against the JAX package.

The reference's multi-device runs go through one subprocess with 8
forced host devices, as ``tests/test_distributed.py`` runs them; it
prints the union ``src_idx`` sets, the selections, the values, and the
global GMM's radius, delta and coreset as JSON. The port runs the same
instances on its in-process mesh (``make_mesh((8,), ("data",),
devices=["cpu"] * 8)``). Union sets and selections must be equal, and the
values allclose at rtol 1e-5 with each side's coreset-matrix diagonal
(matmul-form noise) taken out, as ``tests/test_torch_solve.py`` compares
them. The helpers (transversal EXTRACT, partition counts, ``seq_coreset``
with a transversal spec, ``concat_coresets``) are compared in process.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import coreset as jcoreset
from repro.core import matroid as jmatroid
from repro.core.geometry import normalize_for_metric
from repro.core.solvers import selection_value
from repro_torch import core
from repro_torch.core import coreset as tcoreset
from repro_torch.core import matroid as tmatroid
from repro_torch.core.distributed_gmm import _global_gmm_shard
from repro_torch.launch import data_axes, make_mesh, make_production_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"

# tests/test_distributed.py:30-38 (MapReduce, seed 0) and :168-175
# (global GMM, seed 3)
INSTANCE = """
import numpy as np
def instance(seed, gamma=1):
    rng = np.random.default_rng(seed)
    n, h, k = 1600, 4, 4
    base = rng.normal(size=(n, 2)) @ rng.normal(size=(2, 8))
    P = (base + 0.05*rng.normal(size=(n, 8))).astype(np.float32)
    cats = rng.integers(0, h, (n, gamma)).astype(np.int32)
    if gamma > 1:  # a transversal instance: -1 pads some second labels
        cats[rng.random(n) < 0.5, 1] = -1
    caps = np.full(h, 2, np.int32)
    return P, cats, caps, h, k
"""
exec(INSTANCE)

REF_RUN = INSTANCE + """
import json, jax, jax.numpy as jnp
from repro.core import solve_dmmc
from repro.core.matroid import MatroidSpec
from repro.core.distributed_gmm import distributed_coreset
from repro.core.gmm import gmm_fixed
from repro.launch.mesh import make_mesh
mesh = make_mesh((8,), ("data",))
out = {}
P, cats, caps, h, k = instance(0)
spec = MatroidSpec("partition", num_categories=h, gamma=1)
for name, r2 in (("mr", None), ("mr2", 16)):
    s = solve_dmmc(P, k, spec, cats=cats, caps=caps, tau=64,
                   setting="mapreduce", mesh=mesh, round2_tau=r2)
    out[name] = dict(coreset=s.coreset_indices.tolist(),
                     indices=s.indices.tolist(), diversity=s.diversity,
                     info=s.info)
s = solve_dmmc(P, k, spec, cats=cats, caps=caps, tau=64,
               setting="sequential")
out["seq"] = dict(coreset=s.coreset_indices.tolist(),
                 indices=s.indices.tolist(), diversity=s.diversity,
                 info=dict(tau=64))
Pt, ct, _, _, _ = instance(5, gamma=2)
tspec = MatroidSpec("transversal", num_categories=h, gamma=2)
s = solve_dmmc(Pt, k, tspec, cats=ct, tau=32, setting="mapreduce",
               mesh=mesh)
out["mr_transversal"] = dict(coreset=s.coreset_indices.tolist(),
                             indices=s.indices.tolist(),
                             diversity=s.diversity, info=s.info)
P, cats, caps, h, k = instance(3)
n = P.shape[0]
cs, radius, delta = distributed_coreset(
    mesh, jnp.asarray(P), jnp.asarray(cats), jnp.ones((n,), bool),
    spec, jnp.asarray(caps), k, 16)
ref = gmm_fixed(jnp.asarray(P), jnp.ones((n,), bool), 16)
v = np.asarray(cs.valid)
out["global_gmm"] = dict(
    radius=float(radius), delta=float(delta),
    src_idx=np.asarray(cs.src_idx)[v].tolist(),
    gmm_centers=np.asarray(ref.centers).tolist(),
    gmm_radius=float(ref.radius), gmm_delta=float(ref.delta))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    """The JAX package's 8-device runs, once for the module."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_RUN)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((8,), ("data",), devices=[CPU] * 8)


def _value_without_diagonal(cdm, P, coreset, indices, variant="sum"):
    pts = np.array(normalize_for_metric(jnp.asarray(P), "euclidean"))
    D = np.array(cdm(pts[np.asarray(coreset)]))
    np.fill_diagonal(D, 0.0)
    return selection_value(D, np.searchsorted(coreset, indices), variant)


def _assert_solution(got, want, P):
    np.testing.assert_array_equal(got.coreset_indices, want["coreset"])
    np.testing.assert_array_equal(got.indices, want["indices"])
    assert got.info == want["info"]
    mine = _value_without_diagonal(
        lambda r: core.coreset_distance_matrix(r, device=CPU), P,
        got.coreset_indices, got.indices)
    theirs = _value_without_diagonal(
        jcore.coreset_distance_matrix, P, np.asarray(want["coreset"]),
        np.asarray(want["indices"]))
    np.testing.assert_allclose(mine, theirs, rtol=1e-5)


@pytest.mark.parametrize("name,round2", [("mr", None), ("mr2", 16)])
def test_mapreduce_coreset_8_shards(ref, mesh, name, round2):
    """Twin of tests/test_distributed.py:26, with and without round 2."""
    P, cats, caps, h, k = instance(0)
    spec = core.MatroidSpec("partition", num_categories=h, gamma=1)
    sol = core.solve_dmmc(P, k, spec, cats=cats, caps=caps, tau=64,
                          setting="mapreduce", mesh=mesh, round2_tau=round2,
                          device=CPU)
    _assert_solution(sol, ref[name], P)
    m = core.PartitionMatroid(cats[:, 0], caps)
    assert m.is_independent(list(sol.indices))
    seq = core.solve_dmmc(P, k, spec, cats=cats, caps=caps, tau=64,
                          setting="sequential", device=CPU)
    seq.info = dict(tau=seq.info["tau"])
    _assert_solution(seq, ref["seq"], P)
    # the reference test's bounds: MR within 5% of sequential, round 2
    # within 10%, and round 2 smaller than round 1
    floor = 0.95 if round2 is None else 0.90
    assert sol.diversity >= floor * seq.diversity
    if round2 is not None:
        assert sol.coreset_size < ref["mr"]["info"]["size"]


def test_mapreduce_transversal_matches_jax(ref, mesh):
    """The transversal device EXTRACT on every shard, then the union."""
    P, cats, _, h, k = instance(5, gamma=2)
    spec = core.MatroidSpec("transversal", num_categories=h, gamma=2)
    sol = core.solve_dmmc(P, k, spec, cats=cats, tau=32,
                          setting="mapreduce", mesh=mesh, device=CPU)
    _assert_solution(sol, ref["mr_transversal"], P)


def test_global_gmm_matches_single_machine(ref, mesh):
    """Twin of tests/test_distributed.py:159: the 8-shard global traversal
    picks the centers of single-machine GMM, with the reference's radius,
    delta and coreset."""
    P, cats, caps, h, k = instance(3)
    n = P.shape[0]
    spec = core.MatroidSpec("partition", num_categories=h, gamma=1)
    cs, radius, delta = core.distributed_coreset(
        mesh, P, cats, np.ones(n, bool), spec, caps, k, 16)
    centers = _global_gmm_shard(mesh, list(torch.chunk(torch.as_tensor(P), 8)),
                                [torch.ones(n // 8, dtype=torch.bool)] * 8,
                                16, ("data",))[3]
    want = ref["global_gmm"]
    assert centers.tolist() == want["gmm_centers"]
    mine = core.gmm_fixed(torch.as_tensor(P), torch.ones(n, dtype=torch.bool),
                          16, device=CPU)
    assert centers.tolist() == mine.centers.tolist()
    np.testing.assert_allclose(float(radius), want["radius"], rtol=1e-5)
    np.testing.assert_allclose(float(delta), want["delta"], rtol=1e-5)
    np.testing.assert_allclose(float(radius), want["gmm_radius"], rtol=1e-5)
    np.testing.assert_allclose(float(delta), want["gmm_delta"], rtol=1e-5)
    assert cs.src_idx[cs.valid].tolist() == want["src_idx"]
    assert int(cs.valid.sum()) > 0


def test_mapreduce_pads_to_the_shard_count(mesh):
    """n not divisible by the shards: invalid zero rows complete the last
    shard, and no padding index reaches the coreset."""
    P, cats, caps, h, k = instance(0)
    spec = core.MatroidSpec("partition", num_categories=h, gamma=1)
    n = 1597
    sol = core.solve_dmmc(P[:n], k, spec, cats=cats[:n], caps=caps, tau=64,
                          setting="mapreduce", mesh=mesh, device=CPU)
    assert sol.coreset_indices.max() < n and sol.info["overflow"] == 0
    jsol = jcore.solve_dmmc(P[:n], k, jcore.MatroidSpec("partition", h, 1),
                            cats=cats[:n], caps=caps, tau=64,
                            setting="sequential")
    assert sol.diversity >= 0.9 * jsol.diversity


def test_mapreduce_views_equal_global_input(mesh):
    """The list-of-shards input (views) gives the union of the global
    input, and the union is the concatenation of per-shard SeqCoresets
    with their row offsets."""
    P, cats, caps, h, k = instance(0)
    spec = core.MatroidSpec("partition", num_categories=h, gamma=1)
    n = P.shape[0]
    Pt, ct = torch.as_tensor(P), torch.as_tensor(cats)
    vt = torch.ones(n, dtype=torch.bool)
    cs, ovf = core.mapreduce_coreset(mesh, Pt, ct, vt, spec, caps, k, 8)
    blocks = [list(torch.chunk(x, 8)) for x in (Pt, ct, vt)]
    cs2, _ = core.mapreduce_coreset(mesh, *blocks, spec, caps, k, 8)
    for a, b in zip(cs, cs2):
        assert torch.equal(a, b)
    nl = n // 8
    parts = [core.seq_coreset(P[s * nl:(s + 1) * nl],
                              cats[s * nl:(s + 1) * nl], np.ones(nl, bool),
                              spec, caps, k, 8, base_index=s * nl,
                              device=CPU)[0] for s in range(8)]
    for a, b in zip(cs, core.concat_coresets(parts)):
        assert torch.equal(a, b)
    assert int(ovf) == 0
    # the union's points are the rows its src_idx names
    v = cs.valid
    assert torch.equal(cs.points[v], Pt[cs.src_idx[v].long()])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transversal_extract_mask_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, h, gamma, tau, k = 300, 6, 3, 7, 3
    assign = rng.integers(0, tau, n).astype(np.int32)
    cats = rng.integers(0, h, (n, gamma)).astype(np.int32)
    cats[rng.random((n, gamma)) < 0.3] = -1
    valid = rng.random(n) < 0.9
    got = tmatroid.transversal_extract_mask(
        torch.as_tensor(assign), torch.as_tensor(cats),
        torch.as_tensor(valid), k, tau, h)
    want = jmatroid.transversal_extract_mask(
        jnp.asarray(assign), jnp.asarray(cats), jnp.asarray(valid), k, tau, h)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_partition_counts_ok_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m, h = 12, 4
    sel = rng.integers(0, h, (m, 1)).astype(np.int32)
    sv = rng.random(m) < 0.6
    caps = rng.integers(1, 4, h).astype(np.int32)
    got = tmatroid.partition_counts_ok(torch.as_tensor(sel),
                                       torch.as_tensor(sv),
                                       torch.as_tensor(caps), h)
    want = jmatroid.partition_counts_ok(jnp.asarray(sel), jnp.asarray(sv),
                                        jnp.asarray(caps), h)
    assert bool(got) == bool(want)


def test_seq_coreset_transversal_matches_jax():
    """``seq_coreset`` takes all three matroids, as the reference's does."""
    P, cats, _, h, k = instance(5, gamma=2)
    n = P.shape[0]
    spec = core.MatroidSpec("transversal", num_categories=h, gamma=2)
    cs, res, ovf = core.seq_coreset(P, cats, np.ones(n, bool), spec, None,
                                    k, 12, base_index=100, device=CPU)
    jcs, jres, jovf = jcore.seq_coreset(
        jnp.asarray(P), jnp.asarray(cats), jnp.ones((n,), bool),
        jcore.MatroidSpec("transversal", h, 2), None, k, 12,
        base_index=jnp.int32(100))
    np.testing.assert_array_equal(cs.src_idx.numpy(), np.asarray(jcs.src_idx))
    np.testing.assert_array_equal(cs.valid.numpy(), np.asarray(jcs.valid))
    np.testing.assert_array_equal(cs.cats.numpy(), np.asarray(jcs.cats))
    np.testing.assert_array_equal(cs.points.numpy(), np.asarray(jcs.points))
    assert int(ovf) == int(jovf)


def test_concat_coresets_matches_jax():
    P, cats, caps, h, k = instance(0)
    spec = core.MatroidSpec("partition", num_categories=h, gamma=1)
    parts, jparts = [], []
    for s, (lo, hi) in enumerate(((0, 500), (500, 1100))):
        v = np.ones(hi - lo, bool)
        parts.append(core.seq_coreset(P[lo:hi], cats[lo:hi], v, spec, caps,
                                      k, 6, base_index=lo, device=CPU)[0])
        jparts.append(jcore.seq_coreset(
            jnp.asarray(P[lo:hi]), jnp.asarray(cats[lo:hi]),
            jnp.asarray(v), jcore.MatroidSpec("partition", h, 1),
            jnp.asarray(caps), k, 6, base_index=jnp.int32(lo))[0])
    got = tcoreset.concat_coresets(parts)
    want = jcoreset.concat_coresets(jparts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mesh_api():
    """``shape[axis]``, ``axis_names``, the devices in C order, shard
    indices along a subset of axes, and the default's refusal."""
    mesh = make_mesh((2, 4), ("pod", "data"), devices=[CPU] * 8)
    assert mesh.shape["pod"] == 2 and mesh.shape["data"] == 4
    assert mesh.axis_names == ("pod", "data") and data_axes(mesh) == (
        "pod", "data")
    assert mesh.devices == (torch.device(CPU),) * 8
    assert [mesh.shard_index(p, ("data",)) for p in range(8)] == [
        0, 1, 2, 3, 0, 1, 2, 3]
    assert [s for s, _ in mesh.local_shards(("pod", "data"))] == list(
        range(8))
    assert [s for s, _ in mesh.local_shards(("data",))] == [0, 1, 2, 3]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs 8 devices"):
            make_mesh((8,), ("data",))
        with pytest.raises(RuntimeError, match="needs 256 cards"):
            make_production_mesh()
        with pytest.raises(RuntimeError, match="needs 512 cards"):
            make_production_mesh(multi_pod=True)


def test_mapreduce_over_two_axes_equals_one_axis(mesh):
    """A (2, 4) mesh sharding over both axes gives the 8-shard union; over
    ``data`` alone, the 4-shard union."""
    P, cats, caps, h, k = instance(0)
    spec = core.MatroidSpec("partition", num_categories=h, gamma=1)
    n = P.shape[0]
    m2 = make_mesh((2, 4), ("pod", "data"), devices=[CPU] * 8)
    args = (P, cats, np.ones(n, bool), spec, caps, k, 8)
    a, _ = core.mapreduce_coreset(mesh, *args)
    b, _ = core.mapreduce_coreset(m2, *args, data_axes=("pod", "data"))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c, _ = core.mapreduce_coreset(m2, *args, data_axes=("data",))
    m4 = make_mesh((4,), ("data",), devices=[CPU] * 4)
    d, _ = core.mapreduce_coreset(m4, *args)
    for x, y in zip(c, d):
        assert torch.equal(x, y)


def test_solve_dmmc_mapreduce_defaults_to_the_card():
    P, cats, caps, h, k = instance(0)
    spec = core.MatroidSpec("partition", num_categories=h, gamma=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    mesh = make_mesh((8,), ("data",), devices=[CPU] * 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.solve_dmmc(P, k, spec, cats=cats, caps=caps, tau=64,
                        setting="mapreduce", mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        core.solve_dmmc(P, k, spec, cats=cats, caps=caps, tau=64,
                        setting="mapreduce", device=CPU)
