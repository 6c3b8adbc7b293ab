"""The port's kernels on the card against their plain versions.

Needs an NVIDIA GPU (marker ``cuda``); skips without one. Imports only
torch and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.device import disable_tf32
from repro_torch.kernels import gmm_step, ops, pdist

pytestmark = pytest.mark.cuda

PDIST_SHAPES = [
    (8, 8, 4), (33, 17, 7), (128, 64, 32), (200, 300, 25), (5, 1000, 3),
    (1, 1, 1), (65, 129, 17), (64, 64, 5000), (327, 327, 5000),
]
GMM_SHAPES = [(16, 4), (100, 25), (1025, 7), (64, 128), (3, 300), (4097, 129)]


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
