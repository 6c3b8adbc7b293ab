"""The port's kernels on the card against their plain versions.

Needs an NVIDIA GPU (marker ``cuda``); skips without one. Imports only
torch and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.device import disable_tf32
from repro_torch.core import MatroidSpec, streaming
from repro_torch.kernels import gmm_step, ops, pdist, precheck

pytestmark = pytest.mark.cuda

PDIST_SHAPES = [
    (8, 8, 4), (33, 17, 7), (128, 64, 32), (200, 300, 25), (5, 1000, 3),
    (1, 1, 1), (65, 129, 17), (64, 64, 5000), (327, 327, 5000),
]
GMM_SHAPES = [(16, 4), (100, 25), (1025, 7), (64, 128), (3, 300), (4097, 129)]
PRECHECK_SHAPES = [(8, 5, 4), (37, 17, 7), (128, 33, 100), (200, 129, 25),
                   (128, 257, 100), (128, 65, 5000), (1, 1, 1), (33, 70, 17)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    disable_tf32()
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,d", PDIST_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pdist_kernel_vs_plain(cuda, n, m, d, dtype):
    rng = np.random.default_rng(n * 1000 + m)
    x = torch.as_tensor(rng.normal(size=(n, d)), device=cuda).to(dtype)
    y = torch.as_tensor(rng.normal(size=(m, d)), device=cuda).to(dtype)
    before = pdist.launches
    got = ops.pairwise_sqdist(x, y)
    want = ops.pairwise_sqdist(x, y, force="ref")
    torch.cuda.synchronize()
    assert pdist.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("n,d", GMM_SHAPES)
def test_gmm_step_kernel_vs_plain(cuda, n, d):
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32,
                        device=cuda)
    z = torch.as_tensor(rng.normal(size=(d,)), dtype=torch.float32,
                        device=cuda)
    md = torch.as_tensor(rng.uniform(0.5, 3.0, size=(n,)),
                         dtype=torch.float32, device=cuda)
    valid = torch.as_tensor(rng.random(n) > 0.1, device=cuda)
    before = gmm_step.launches
    nm, fi, fv = ops.gmm_update(x, z, md, valid)
    nm_r, fi_r, fv_r = ops.gmm_update(x, z, md, valid, force="ref")
    torch.cuda.synchronize()
    assert gmm_step.launches == before + 1
    torch.testing.assert_close(nm, nm_r, rtol=1e-5, atol=1e-5)
    assert int(fi) == int(fi_r)
    assert fi.dtype == torch.int32 and fi.shape == ()
    np.testing.assert_allclose(float(fv), float(fv_r), rtol=1e-5)


def test_gmm_step_first_index_on_ties(cuda):
    """Equal rows tie: the first valid one wins, across program blocks."""
    n, d = 200, 16
    x = torch.zeros(n, d, device=cuda)
    x[[40, 90, 150]] = 1.0
    valid = torch.ones(n, dtype=torch.bool, device=cuda)
    valid[40] = False
    md = torch.full((n,), torch.inf, device=cuda)
    _, fi, fv = ops.gmm_update(x, torch.zeros(d, device=cuda), md, valid)
    assert int(fi) == 90 and float(fv) == pytest.approx(4.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pdist_kernel_self_distance_is_exactly_zero(cuda, dtype):
    """Norms and dot products share one FFMA order, so d(x, x) = 0 exactly
    (the plain matmul form leaves cancellation noise there)."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(300, 5000)), device=cuda).to(dtype)
    x = x / x.float().norm(dim=1, keepdim=True).to(dtype)
    d2 = ops.pairwise_sqdist(x, x)
    assert torch.count_nonzero(torch.diagonal(d2)) == 0


def _check_precheck(x, c, cv):
    """K3 against its plain version (distances within 1e-4) and against
    the exact oracle (the index contract of the blocked scan)."""
    before = precheck.launches
    got = ops.center_precheck(x, c, cv)
    plain = ops.center_precheck(x, c, cv, force="ref")
    exact = ops.center_precheck(x, c, cv, force="exact")
    torch.cuda.synchronize()
    assert precheck.launches == before + 1
    for i in (0, 2, 4):
        torch.testing.assert_close(got[i], plain[i], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[i], exact[i], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[5], plain[5])
    T = c.shape[0]
    for z in (got[1], got[3]):
        assert z.dtype == torch.int32 and bool(torch.all((z >= 0) & (z < T)))
    dmin_r, z_r, sec_r, z2_r, third_r, _ = exact
    margin = got[5]
    safe_z = (sec_r - dmin_r) > 2 * margin
    assert torch.equal(got[1][safe_z], z_r[safe_z])
    safe_pair = (third_r - dmin_r) > 2 * margin
    pair = torch.sort(torch.stack([got[1], got[3]]), dim=0).values
    pair_r = torch.sort(torch.stack([z_r, z2_r]), dim=0).values
    assert torch.equal(pair[:, safe_pair], pair_r[:, safe_pair])
    return got


@pytest.mark.parametrize("B,T,d", PRECHECK_SHAPES)
def test_precheck_kernel_vs_plain(cuda, B, T, d):
    rng = np.random.default_rng(B * 100 + T)
    x = torch.as_tensor(rng.normal(size=(B, d)) * 3, dtype=torch.float32,
                        device=cuda)
    c = torch.as_tensor(rng.normal(size=(T, d)) * 3, dtype=torch.float32,
                        device=cuda)
    cv = torch.as_tensor(rng.random(T) > 0.2, device=cuda)
    _check_precheck(x, c, cv)


def test_precheck_kernel_first_index_ties(cuda):
    """Duplicated centers tie exactly: the kernel returns the first columns,
    as _nearest_stats does, across warp lanes and center tiles."""
    rng = np.random.default_rng(3)
    base = torch.as_tensor(rng.normal(size=(3, 64)), dtype=torch.float32,
                           device=cuda)
    c = base[torch.as_tensor([2, 0, 1, 0, 2, 1, 0] * 10, device=cuda)]
    x = base[torch.as_tensor([0, 1, 2] * 40, device=cuda)]
    cv = torch.ones(c.shape[0], dtype=torch.bool, device=cuda)
    cv[1] = False
    got = ops.center_precheck(x, c.contiguous(), cv)
    want = ops.center_precheck(x, c.contiguous(), cv, force="exact")
    for i in (1, 3):
        assert torch.equal(got[i], want[i])


def test_precheck_kernel_all_invalid_and_one_valid(cuda):
    x = torch.ones(4, 3, device=cuda)
    c = torch.zeros(40, 3, device=cuda)
    cv = torch.zeros(40, dtype=torch.bool, device=cuda)
    got = ops.center_precheck(x, c, cv)
    assert torch.all(got[0] >= np.float32(3.4e38))
    assert torch.equal(got[1], torch.zeros(4, dtype=torch.int32, device=cuda))
    cv[37] = True
    got = ops.center_precheck(x, c, cv)
    want = ops.center_precheck(x, c, cv, force="exact")
    torch.testing.assert_close(got[0], want[0])
    for i in (1, 2, 3, 4):  # second and third are float32 max
        assert torch.equal(got[i], want[i])
    assert torch.equal(got[1], torch.full_like(got[1], 37))
    assert torch.equal(got[3], torch.zeros_like(got[3]))


def test_blocked_scan_equals_per_point_on_the_card(cuda):
    rng = np.random.default_rng(0)
    n, d, h, k, tau = 600, 32, 4, 3, 6
    base = rng.normal(size=(14, d)) * 3
    P = (base[rng.integers(0, 14, n)] + 0.4 * rng.normal(size=(n, d)))
    P = torch.as_tensor(P, dtype=torch.float32, device=cuda)
    cats = rng.integers(0, h, (n, 1)).astype(np.int32)
    caps = np.full(h, 2, np.int32)
    spec = MatroidSpec("partition", h, 1)
    states = {}
    for bs in (1, 16, 128):
        before = precheck.launches
        _cs, states[bs] = streaming.stream_coreset(
            P, cats, np.ones(n, bool), spec, caps, k, tau, block_size=bs,
            device=cuda)
        assert (precheck.launches > before) == (bs > 1)
    for bs in (16, 128):
        for f in streaming.StreamState._fields:
            assert torch.equal(getattr(states[1], f), getattr(states[bs], f)), f
