"""A CPU model of the TF32 products behind K6 (and the reason K1 stays FFMA).

K6 (``src/repro_torch/kernels/csrc/ssd.cu``) runs its three products on
the tensor cores in TF32 with each operand split as hi = tf32(a), lo =
tf32(a - hi), accumulating lo.hi + hi.lo + hi.hi in f32 (3xTF32). This
file emulates that rounding on the CPU with integer bit operations on f32
tensors (round to nearest, ties away from zero, at 10 mantissa bits, as
``cvt.rna.tf32.f32`` does; a product of two tf32 values is exact in f32)
and holds three claims against an f64 answer:

- 3xTF32 keeps K6's y = (C B^T * L) xbar and state = (B * w)^T xbar within
  1e-6 of their largest value, the level of f32 itself;
- one TF32 product (1xTF32) exceeds K6's 2e-4 gate, which is why the split
  is needed;
- for K1 at the solve's shape (327 unit rows of d = 5000 against
  themselves) 3xTF32 stays inside the 1e-5 x (||x||^2 + ||c||^2) margin of
  ``kernels/ops.py:_pdist_e2`` and 1xTF32 does not.

The decays (cum, L, w) are taken in f64 on both sides and rounded to f32
for the emulated one, so what is measured is the products.
"""
import numpy as np
import pytest
import torch

SSD_GATE = 2e-4  # the K6 card gates, relative to the largest value
PDIST_MARGIN = 1e-5  # kernels/ops.py:_pdist_e2, times ||x||^2 + ||c||^2


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest tf32 value (ties away from zero), as f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 product, f32 accumulation."""
    return tf32(a) @ tf32(b)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3xTF32: lo.hi + hi.lo + hi.hi, each a TF32 product, summed in f32."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _ssd_cell(rng, q, p, n):
    x = rng.normal(size=(q, p))
    loga = -rng.uniform(0.01, 0.4, q)
    B = rng.normal(size=(q, n))
    C = rng.normal(size=(q, n))
    cum = np.cumsum(loga)
    L = np.tril(np.exp(cum[:, None] - cum[None, :]))
    w = np.exp(cum[-1] - cum)
    return x, B, C, L, w


def _ssd(mm, x, B, C, L, w):
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)
    x, B, C, L, w = map(f, (x, B, C, L, w))
    M = mm(C, B.T) * L
    return mm(M, x), mm((B * w[:, None]).T, x)


def _ssd_errors(mm, q, p, n, cells=3, seed=0):
    """Largest |emulated - f64| / largest |f64| over a few cells, for y and
    for the state."""
    rng = np.random.default_rng(seed + q + n)
    ey = es = 0.0
    for _ in range(cells):
        x, B, C, L, w = _ssd_cell(rng, q, p, n)
        y64 = ((C @ B.T) * L) @ x
        s64 = (B * w[:, None]).T @ x
        y, s = _ssd(mm, x, B, C, L, w)
        ey = max(ey, np.abs(y.double().numpy() - y64).max() / np.abs(y64).max())
        es = max(es, np.abs(s.double().numpy() - s64).max() / np.abs(s64).max())
    return ey, es


def test_tf32_rounding_model():
    """The emulated tf32 keeps 10 mantissa bits and rounds to nearest."""
    x = torch.as_tensor(np.random.default_rng(0).normal(size=4096),
                        dtype=torch.float32)
    t = tf32(x)
    assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((t - x).abs() / x.abs()).max()) <= 2.0**-11
    one = torch.tensor([1 + 2**-11, 1 + 2**-11 - 2**-23], dtype=torch.float32)
    assert tf32(one).tolist() == [1 + 2**-10, 1.0]


@pytest.mark.parametrize("q,p,n", [(256, 64, 64), (16, 64, 64),
                                   (256, 64, 128)])
def test_ssd_3xtf32_stays_at_f32_level(q, p, n):
    ey, es = _ssd_errors(mm3, q, p, n)
    assert ey <= 1e-6 and es <= 1e-6, (ey, es)


def test_ssd_1xtf32_exceeds_the_gate():
    ey, es = _ssd_errors(mm1, 256, 64, 64)
    assert ey > SSD_GATE, (ey, es)


@pytest.mark.parametrize("mm,inside", [(mm3, True), (mm1, False)],
                         ids=["3xtf32", "1xtf32"])
def test_pdist_tf32_against_the_scan_margin(mm, inside):
    rng = np.random.default_rng(0)
    x64 = rng.normal(size=(327, 5000))
    x64 /= np.linalg.norm(x64, axis=1, keepdims=True)
    nrm64 = np.sum(x64 * x64, axis=1)
    d64 = nrm64[:, None] + nrm64[None, :] - 2 * x64 @ x64.T
    x = torch.as_tensor(x64, dtype=torch.float32)
    nrm = torch.sum(x * x, dim=1)
    d = nrm[:, None] + nrm[None, :] - 2 * mm(x, x.T)
    err = float(np.abs(d.double().numpy() - d64).max())
    margin = PDIST_MARGIN * float(2 * nrm64.max())
    assert (err <= margin) == inside, (err, margin)
