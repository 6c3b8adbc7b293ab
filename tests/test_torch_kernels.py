"""The port's kernel wrappers on the CPU against the JAX package's.

On a CPU tensor ``repro_torch.kernels.ops`` runs the plain PyTorch
version; the JAX side runs as its own kernel tests do, through its jnp
reference (``force="ref"``) and its Pallas kernel in interpret mode.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro_torch.kernels import gmm_step, ops, pdist, precheck, ref

PDIST_SHAPES = [
    (8, 8, 4), (33, 17, 7), (128, 64, 32), (200, 300, 25), (5, 1000, 3),
]


@pytest.mark.parametrize("n,m,d", PDIST_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pdist_matches_jax(n, m, d, dtype):
    rng = np.random.default_rng(n * 1000 + m)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(rng.normal(size=(n, d)), jdt)
    y = jnp.asarray(rng.normal(size=(m, d)), jdt)
    tdt = getattr(torch, dtype)
    # bf16 values pass exactly through f32
    xt = torch.tensor(np.asarray(x, np.float32)).to(tdt)
    yt = torch.tensor(np.asarray(y, np.float32)).to(tdt)
    got = ops.pairwise_sqdist(xt, yt, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n, m)
    tol = 1e-4 if dtype == "float32" else 5e-2
    for force in ("ref", "interpret"):
        want = np.asarray(jops.pairwise_sqdist(x, y, force=force))
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        ops.pairwise_dist(xt, yt, device="cpu").numpy(),
        np.asarray(jops.pairwise_dist(x, y, force="ref")), rtol=tol, atol=tol,
    )


@pytest.mark.parametrize("n,d", [(16, 4), (100, 25), (1025, 7), (64, 128)])
def test_gmm_update_matches_jax(n, d):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    z = rng.normal(size=(d,)).astype(np.float32)
    md = rng.uniform(0.5, 3.0, size=(n,)).astype(np.float32)
    valid = rng.random(n) > 0.1
    nm, fi, fv = ops.gmm_update(x, z, md, valid, device="cpu")
    assert nm.shape == (n,) and fi.dtype == torch.int32 and fi.shape == ()
    for force in ("ref", "interpret"):
        r = jops.gmm_update(jnp.asarray(x), jnp.asarray(z), jnp.asarray(md),
                            jnp.asarray(valid), force=force)
        np.testing.assert_allclose(nm.numpy(), np.asarray(r[0]), rtol=1e-5,
                                   atol=1e-5)
        assert int(fi) == int(r[1])
        np.testing.assert_allclose(float(fv), float(r[2]), rtol=1e-5)


def test_gmm_update_first_index_and_invalid_rows():
    """Ties go to the first valid row; invalid rows count as -1."""
    x = np.zeros((6, 3), np.float32)
    x[[1, 3, 4]] = 1.0
    valid = np.array([True, False, True, True, True, True])
    nm, fi, fv = ops.gmm_update(x, np.zeros(3, np.float32),
                                np.full(6, np.inf, np.float32), valid,
                                device="cpu")
    assert int(fi) == 3 and float(fv) == pytest.approx(np.sqrt(3.0))
    _, fi, fv = ops.gmm_update(x, np.zeros(3, np.float32),
                               np.full(6, np.inf, np.float32),
                               np.zeros(6, bool), device="cpu")
    assert int(fi) == 0 and float(fv) == -1.0


def test_cuda_without_card_raises_and_cpu_path_launches_nothing():
    ops.reset_launches()
    x = torch.randn(5, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.pairwise_sqdist(x, x)  # default device is the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.gmm_update(x, x[0], torch.ones(5), torch.ones(5, dtype=bool))
    # the kernel wrappers take CUDA tensors only
    with pytest.raises(ValueError):
        pdist.pairwise_sqdist(x, x)
    with pytest.raises(ValueError):
        gmm_step.gmm_update(x, x[0], torch.ones(5), torch.ones(5, dtype=bool))
    with pytest.raises(ValueError, match="unknown force"):
        ops.pairwise_sqdist(x, x, force="interpret", device="cpu")
    ops.pairwise_sqdist(x, x, device="cpu")
    ops.gmm_update(x, x[0], torch.ones(5), torch.ones(5, dtype=bool),
                   device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.center_precheck(x, x, torch.ones(5, dtype=bool))
    with pytest.raises(ValueError):
        precheck.center_precheck_stats(x, x, torch.ones(5, dtype=bool))
    with pytest.raises(ValueError, match="unknown force"):
        ops.center_precheck(x, x, torch.ones(5, dtype=bool),
                            force="matmul", device="cpu")
    ops.center_precheck(x, x, torch.ones(5, dtype=bool), device="cpu")
    q = torch.randn(2, 6, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.flash_attention_fwd(q, q, q)
    ops.flash_attention_fwd(q, q, q, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.ssd_intra_chunk(q, -q[..., 0].abs(), q, q)
    ops.ssd_intra_chunk(q, -q[..., 0].abs(), q, q, device="cpu")
    o, lse = ops.flash_attention_fwd(q, q, q, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.flash_attention_bwd(q, q, q, o, lse, q)
    ops.flash_attention_bwd(q, q, q, o, lse, q, device="cpu")
    assert ops.launch_counts() == {"pairwise_sqdist": 0, "gmm_update": 0,
                                   "center_precheck": 0,
                                   "flash_attention_fwd": 0,
                                   "flash_attention_bwd": 0,
                                   "ssd_intra_chunk": 0}


def test_gmm_step_block_d():
    assert [gmm_step.block_d(d) for d in (1, 16, 17, 100, 128, 5000)] == [
        16, 16, 32, 128, 128, 128
    ]


PRECHECK_SHAPES = [(8, 5, 4), (37, 17, 7), (128, 33, 100), (200, 129, 25)]


def _precheck_inputs(B, T, d):
    rng = np.random.default_rng(B * 100 + T)
    x = (rng.normal(size=(B, d)) * 3).astype(np.float32)
    c = (rng.normal(size=(T, d)) * 3).astype(np.float32)
    return x, c, rng.random(T) > 0.2


@pytest.mark.parametrize("B,T,d", PRECHECK_SHAPES)
def test_center_precheck_oracles_match_jax(B, T, d):
    """Both oracles against the reference's on the same inputs: distances
    within 1e-4 (the frameworks sum in other orders), indices equal where
    the gaps clear twice the margin, the margin as the reference's."""
    x, c, cv = _precheck_inputs(B, T, d)
    jx, jc, jcv = jnp.asarray(x), jnp.asarray(c), jnp.asarray(cv)
    tx, tc, tcv = torch.tensor(x), torch.tensor(c), torch.tensor(cv)
    for force, jforce in (("exact", "ref"), (None, "matmul"),
                          ("ref", "matmul")):
        got = [t.numpy() for t in ops.center_precheck(
            tx, tc, tcv, force=force, device="cpu")]
        want = [np.asarray(a) for a in jops.center_precheck(
            jx, jc, jcv, force=jforce)]
        assert got[1].dtype == np.int32 and got[3].dtype == np.int32
        margin = np.broadcast_to(want[5], (B,))
        np.testing.assert_allclose(got[5], want[5], rtol=1e-4)
        if force == "exact":
            assert got[5].shape == () and float(got[5]) == 0.0
        for i in (0, 2, 4):
            np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-4)
        gap = 2 * margin + 1e-4
        safe_z = want[2] - want[0] > gap
        assert np.array_equal(got[1][safe_z], want[1][safe_z])
        safe_pair = want[4] - want[0] > gap
        pair = np.sort(np.stack([got[1], got[3]]), axis=0)
        pair_r = np.sort(np.stack([want[1], want[3]]), axis=0)
        assert np.array_equal(pair[:, safe_pair], pair_r[:, safe_pair])


@pytest.mark.parametrize("B,T,d", PRECHECK_SHAPES)
def test_center_precheck_matmul_vs_exact_contract(B, T, d):
    """The port's own plain version against its exact oracle: the index
    contract the blocked scan relies on."""
    x, c, cv = (torch.tensor(a) for a in _precheck_inputs(B, T, d))
    dmin_r, z_r, sec_r, z2_r, third_r, m_r = ops.center_precheck(
        x, c, cv, force="exact", device="cpu")
    dmin, z, sec, z2, third, margin = ops.center_precheck(
        x, c, cv, force="ref", device="cpu")
    assert float(m_r) == 0.0 and margin.shape == (B,)
    for a, b in ((dmin_r, dmin), (sec_r, sec), (third_r, third)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    safe_z = (sec_r - dmin_r) > 2 * margin
    assert torch.equal(z[safe_z], z_r[safe_z])
    safe_pair = (third_r - dmin_r) > 2 * margin
    pair = torch.sort(torch.stack([z, z2]), dim=0).values
    pair_r = torch.sort(torch.stack([z_r, z2_r]), dim=0).values
    assert torch.equal(pair[:, safe_pair], pair_r[:, safe_pair])


@pytest.mark.parametrize("force", ["exact", "ref"])
def test_center_precheck_all_invalid_centers(force):
    x = torch.ones(4, 3)
    c = torch.zeros(5, 3)
    dmin, z, sec, z2, third, _m = ops.center_precheck(
        x, c, torch.zeros(5, dtype=bool), force=force, device="cpu")
    assert torch.all(dmin >= np.float32(3.4e38))
    assert torch.equal(z, torch.zeros(4, dtype=torch.int32))
    assert torch.equal(z2, torch.zeros(4, dtype=torch.int32))


def _kernel_top3(d: np.ndarray, lanes: int = 32):
    """csrc/precheck.cu's reduction on the host: per lane, columns lane,
    lane + 32, ... inserted in ascending order into a lexicographic
    (value, column) top-3; the lane lists merged by xor butterfly; then
    the masking rule of _nearest_stats."""
    B, T = d.shape
    inf, fmax = np.float32(np.inf), np.float32(np.finfo(np.float32).max)

    def insert(top, v, c):
        top.append((v, c))
        top.sort()
        del top[3:]

    out = []
    for r in range(B):
        tops = [[(inf, T)] * 3 for _ in range(lanes)]
        for lane in range(lanes):
            for t in range(lane, T, lanes):
                insert(tops[lane], d[r, t], t)
        off = lanes // 2
        while off:
            tops = [sorted(tops[i] + tops[i ^ off])[:3]
                    for i in range(lanes)]
            off //= 2
        (v1, c1), (v2, c2), (v3, _c3) = tops[0]
        sec = min(v2, fmax)
        out.append((v1, c1, sec, c2 if sec < fmax else 0,
                    min(v3, fmax) if sec < fmax else fmax))
    return [np.array(col) for col in zip(*out)]


@pytest.mark.parametrize("T", [1, 2, 3, 5, 33, 70])
def test_kernel_reduction_rule_matches_nearest_stats(T):
    """The kernel's top-3 rule gives exactly _nearest_stats' results on
    tie-heavy rows: few distinct values, invalid columns, T not a multiple
    of the warp."""
    rng = np.random.default_rng(T)
    fmax = np.float32(np.finfo(np.float32).max)
    d = rng.integers(0, 3, size=(40, T)).astype(np.float32)
    d[rng.random((40, T)) < 0.3] = fmax
    d[0] = fmax  # a row with no valid center
    if T > 1:
        d[1, 1:] = fmax  # a row with one valid center, not at column 0
    want = [t.numpy() for t in ref._nearest_stats(torch.tensor(d))]
    got = _kernel_top3(d)
    for g, w in zip(got, want):
        assert np.array_equal(g.astype(w.dtype), w)


def test_precheck_splits():
    """d is cut into chunks of whole 16-wide steps, enough for about 264
    first-pass blocks, and the chunks cover d exactly once."""
    assert precheck.splits(128, 65, 5000) == (32, 160)
    assert precheck.splits(128, 257, 5000) == (14, 368)
    assert precheck.splits(8, 5, 4) == (1, 16)
    assert precheck.splits(3, 2, 0) == (1, 16)
    for B, T, d in [(128, 65, 5000), (1, 1, 1), (200, 129, 25), (37, 17, 7)]:
        S, chunk = precheck.splits(B, T, d)
        assert chunk % 16 == 0 and (S - 1) * chunk < d <= S * chunk
