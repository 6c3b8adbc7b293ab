"""A CPU model of the TF32 products behind K6 and K6b (and the reason K1
stays FFMA).

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
  ``kernels/ops.py:_pdist_e2`` and 1xTF32 does not;
- K6b (``csrc/ssd_bwd.cu``), its products emulated in the orientation the
  kernel runs them (s rows: dM^T = xbar dy^T, xd = xbar dstate^T, M^T dy,
  (B * w) dstate, G^T = B C^T; then dB = w * xd + dG^T C and dC = dG B
  from dG^T summed over the heads that share B and C, in head order),
  keeps dxbar, dloga, dB and dC within 5e-6 of their largest value, 40
  times under its 2e-4 gate, dloga's cancelling sums included; one TF32
  product would break the gate on every one of the four.

The decays (cum, L, w) are taken in f64 on both sides and rounded to f32
for the emulated one, so what is measured is the products.
"""
import functools

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


# K6b: a group of heads sharing B and C, as the model calls it
SSD_BWD_HEADS = 4
SSD_BWD_SHAPES = [(256, 64, 128), (256, 64, 64)]
SSD_BWD_3X_BOUND = 5e-6  # of each gradient's largest value
GRADS = ("dxbar", "dloga", "dB", "dC")


def _ssd_bwd_group(rng, H, q, p, n):
    return dict(x=rng.normal(size=(H, q, p)), dy=rng.normal(size=(H, q, p)),
                ds=rng.normal(size=(H, n, p)),
                loga=-rng.uniform(0.01, 0.4, (H, q)),
                B=rng.normal(size=(q, n)), C=rng.normal(size=(q, n)))


def _decays(loga):
    cum = np.cumsum(loga)
    L = np.tril(np.exp(cum[:, None] - cum[None, :]))
    return L, np.exp(cum[-1] - cum)


def _ssd_bwd_f64(d):
    """The vector-Jacobian product in f64, per head (t rows)."""
    B, C = d["B"], d["C"]
    G = C @ B.T
    out = dict(dxbar=[], dloga=[], dB=0.0, dC=0.0)
    for x, dy, ds, loga in zip(d["x"], d["dy"], d["ds"], d["loga"]):
        L, w = _decays(loga)
        M = G * L
        dM = (dy @ x.T) * (L != 0)
        dG = dM * L
        xd = x @ ds.T
        out["dxbar"].append(M.T @ dy + (B * w[:, None]) @ ds)
        out["dB"] = out["dB"] + dG.T @ C + w[:, None] * xd
        out["dC"] = out["dC"] + dG @ B
        u = (xd * B).sum(1)
        dmm = dM * M
        dcum = dmm.sum(1) - dmm.sum(0) - w * u
        dcum[-1] += (w * u).sum()
        out["dloga"].append(np.cumsum(dcum[::-1])[::-1])
    return {k: np.stack(v) if isinstance(v, list) else v
            for k, v in out.items()}


def _ssd_bwd_emulated(mm, d):
    """K6b's products in f32 through ``mm``, in the kernel's s-row
    orientation, dG^T and w * xd summed over the heads in order."""
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                  dtype=torch.float32)
    B, C = f(d["B"]), f(d["C"])
    GT = mm(B, C.T)
    dGT = dBst = 0.0
    out = dict(dxbar=[], dloga=[])
    for x, dy, ds, loga in zip(d["x"], d["dy"], d["ds"], d["loga"]):
        L, w = _decays(loga)
        x, dy, ds, LT, w = f(x), f(dy), f(ds), f(L.T), f(w)
        dgt = mm(x, dy.T) * LT
        MT = GT * LT
        dmm = dgt * GT
        xd = mm(x, ds.T)
        u = (xd * B).sum(1)
        out["dxbar"].append(mm(B * w[:, None], ds) + mm(MT, dy))
        dBst = dBst + w[:, None] * xd
        dGT = dGT + dgt
        dcum = dmm.sum(0) - dmm.sum(1) - w * u
        dcum[-1] += (w * u).sum()
        out["dloga"].append(torch.flip(torch.cumsum(torch.flip(dcum, [0]), 0),
                                       [0]))
    out = {k: torch.stack(v).double().numpy() for k, v in out.items()}
    out["dB"] = (dBst + mm(dGT, C)).double().numpy()
    out["dC"] = mm(dGT.T, B).double().numpy()
    return out


@functools.lru_cache(maxsize=None)
def _ssd_bwd_errors(three: bool, q: int, p: int, n: int) -> dict:
    """Largest |emulated - f64| / largest |f64| of each gradient."""
    d = _ssd_bwd_group(np.random.default_rng(q + n), SSD_BWD_HEADS, q, p, n)
    want = _ssd_bwd_f64(d)
    got = _ssd_bwd_emulated(mm3 if three else mm1, d)
    return {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
            for k in GRADS}


def test_ssd_bwd_f64_model_is_the_plain_version():
    """The f64 model above computes what ``ref.ssd_intra_chunk_bwd`` does
    (heads sharing B and C, dB and dC summed over them)."""
    from repro_torch.kernels import ref

    d = _ssd_bwd_group(np.random.default_rng(1), 3, 100, 16, 24)
    want = _ssd_bwd_f64(d)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    got = ref.ssd_intra_chunk_bwd(
        t(d["x"])[None], t(d["loga"])[None], t(d["B"])[None, None],
        t(d["C"])[None, None], t(d["dy"])[None], t(d["ds"])[None])
    for name, g in zip(GRADS, got):
        g = g.double().numpy().reshape(np.shape(want[name]))
        rel = np.abs(g - want[name]).max() / np.abs(want[name]).max()
        assert rel <= 1e-5, (name, rel)


@pytest.mark.parametrize("q,p,n", SSD_BWD_SHAPES)
@pytest.mark.parametrize("grad", GRADS)
def test_ssd_bwd_3xtf32_stays_far_under_the_gate(grad, q, p, n):
    err = _ssd_bwd_errors(True, q, p, n)[grad]
    assert err <= SSD_BWD_3X_BOUND, (grad, err)


@pytest.mark.parametrize("q,p,n", SSD_BWD_SHAPES)
@pytest.mark.parametrize("grad", GRADS)
def test_ssd_bwd_1xtf32_breaks_the_gate(grad, q, p, n):
    """One TF32 product leaves 3e-4 to 6e-4 of the largest value on each
    gradient (dloga the least), over the 2e-4 gate."""
    err = _ssd_bwd_errors(False, q, p, n)[grad]
    assert err > SSD_GATE, (grad, err)
