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
from repro_torch.kernels import gmm_step, ops, pdist

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
    assert ops.launch_counts() == {"pairwise_sqdist": 0, "gmm_update": 0}


def test_gmm_step_block_d():
    assert [gmm_step.block_d(d) for d in (1, 16, 17, 100, 128, 5000)] == [
        16, 16, 32, 128, 128, 128
    ]
