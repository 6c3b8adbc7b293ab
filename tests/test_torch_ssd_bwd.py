"""CPU parity of the port's SSD intra-chunk backward (K6b's plain version,
``ref.ssd_intra_chunk_bwd``) with ``jax.vjp`` of the JAX package's
per-cell SSD oracle, and of ``models.mamba.ssd_chunked``'s gradients
(through ``SSDIntraChunk``) with ``jax.vjp`` of the JAX package's
``ssd_chunked``.

The same numpy inputs and cotangents go to both packages; the decays'
cotangents are zero for the per-cell oracle, as the port's kernel leaves
the decays to its caller. Tolerance: 2e-4 of each gradient's largest
entry, the JAX package's own SSD tolerance (tests/test_kernels.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jax_ref
from repro.models.mamba import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops, ref, ssd_bwd
from repro_torch.models.mamba import SSDIntraChunk, ssd_chunked

# (g, q, p, n): tests/test_kernels.py's SSD_SHAPES, then q = 1 and q = 48
SSD_SHAPES = [(2, 16, 8, 4), (3, 32, 16, 8), (1, 64, 32, 16), (4, 8, 64, 32),
              (2, 1, 16, 8), (3, 48, 16, 8)]
TOL = 2e-4


def _inputs(lead, q, p, n, seed, b_lead=None):
    """xbar, loga, B, C, dy, dstate as f32 numpy arrays; B and C with the
    leading dims ``b_lead`` (default: ``lead``)."""
    rng = np.random.default_rng(seed)
    b_lead = lead if b_lead is None else b_lead
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return (f(*lead, q, p),
            (-rng.uniform(0.01, 0.4, (*lead, q))).astype(np.float32),
            f(*b_lead, q, n), f(*b_lead, q, n), f(*lead, q, p),
            f(*lead, n, p))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


def _jax_vjp(xb, la, B, C, dy, ds):
    """jax.vjp of the per-cell oracle vmapped over the cells, the decays'
    cotangents zero."""
    g, q = la.shape
    _, vjp = jax.vjp(jax.vmap(jax_ref.ssd_intra_chunk),
                     *(jnp.asarray(a) for a in (xb, la, B, C)))
    return vjp((jnp.asarray(dy), jnp.asarray(ds), jnp.zeros((g, q)),
                jnp.zeros((g,))))


@pytest.mark.parametrize("g,q,p,n", SSD_SHAPES)
def test_plain_bwd_matches_jax_vjp(g, q, p, n):
    args = _inputs((g,), q, p, n, seed=g * 100 + q)
    want = _jax_vjp(*args)
    got = ops.ssd_intra_chunk_bwd(*args, device="cpu")
    for gt, w, name in zip(got, want, ("dxbar", "dloga", "dB", "dC")):
        assert gt.dtype == torch.float32 and gt.shape == w.shape, name
        _close(gt.numpy(), w)


@pytest.mark.parametrize("q", [1, 16, 48])
def test_head_broadcast_sums_the_per_cell_gradients(q):
    """B and C of size 1 along the heads (the model's layout, a stride-0
    broadcast once expanded): dB and dC come back in that shape, the sum
    over the heads of the per-cell gradients; dxbar and dloga are the
    per-cell ones. Also against jax.vjp, cell by cell."""
    g1, H, p, n = 3, 5, 16, 8
    xb, la, B, C, dy, ds = (torch.as_tensor(a) for a in _inputs(
        (g1, H), q, p, n, seed=q, b_lead=(g1, 1)))
    got = ref.ssd_intra_chunk_bwd(xb, la, B, C, dy, ds)
    assert got[2].shape == B.shape and got[3].shape == C.shape
    per_cell = ref.ssd_intra_chunk_bwd(
        xb, la, B.expand(g1, H, q, n).contiguous(),
        C.expand(g1, H, q, n).contiguous(), dy, ds)
    assert torch.equal(got[0], per_cell[0])
    assert torch.equal(got[1], per_cell[1])
    for i in (2, 3):
        assert torch.equal(got[i], per_cell[i].sum(dim=1, keepdim=True))
    # a stride-0 view of the full shape is the caller's own shape: its
    # gradient stays per cell
    full = ref.ssd_intra_chunk_bwd(xb, la, B.expand(g1, H, q, n),
                                   C.expand(g1, H, q, n), dy, ds)
    assert full[2].shape == (g1, H, q, n)
    assert torch.equal(full[2], per_cell[2])
    flat = lambda t: t.reshape(g1 * H, *t.shape[2:]).numpy()  # noqa: E731
    Bx, Cx = (t.expand(g1, H, q, n) for t in (B, C))
    want = _jax_vjp(*(flat(t) for t in (xb, la, Bx, Cx, dy, ds)))
    for gt, w in zip(per_cell, want):
        _close(flat(gt), w)


def test_chunked_walk_changes_nothing(monkeypatch):
    """Walking the cells in chunks along the first axis changes no bit,
    per cell and with B and C shared along the heads, and adds the chunks'
    dB where B broadcasts along the first axis too."""
    g1, H, q, p, n = 5, 3, 40, 8, 6
    args = [torch.as_tensor(a) for a in _inputs((g1, H), q, p, n, seed=7)]
    shared = [torch.as_tensor(a) for a in _inputs((g1, H), q, p, n, seed=8,
                                                  b_lead=(g1, 1))]
    once = [ref.ssd_intra_chunk_bwd(*a) for a in (args, shared)]
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 2 * H * q * q)  # 2 rows a chunk
    for a, want in zip((args, shared), once):
        for got, w in zip(ref.ssd_intra_chunk_bwd(*a), want):
            assert torch.equal(got, w)
    xb, la, B, C, dy, ds = shared
    B1, C1 = B[:1], C[:1]  # one B and C for every cell
    got = ref.ssd_intra_chunk_bwd(xb, la, B1, C1, dy, ds)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 2**28)
    want = ref.ssd_intra_chunk_bwd(xb, la, B1, C1, dy, ds)
    assert got[2].shape == B1.shape
    for g, w in zip(got, want):  # the chunks' dB add in another order
        _close(g.numpy(), w.numpy(), tol=1e-5)


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_ssd_chunked_grads_match_jax(chunk):
    """models.mamba.ssd_chunked's gradients in all four inputs (the decays
    and the inter-chunk recurrence differentiated by autograd, the
    intra-chunk step by SSDIntraChunk) against jax.vjp of the JAX
    package's ssd_chunked; its values are the no-grad path's bit for
    bit."""
    b, seq, h, p, n = 2, 96, 3, 16, 8
    rng = np.random.default_rng(chunk)
    xb = rng.normal(size=(b, seq, h, p)).astype(np.float32)
    la = (-rng.uniform(0.01, 0.3, (b, seq, h))).astype(np.float32)
    B = rng.normal(size=(b, seq, n)).astype(np.float32)
    C = rng.normal(size=(b, seq, n)).astype(np.float32)
    gy = rng.normal(size=(b, seq, h, p)).astype(np.float32)
    gs = rng.normal(size=(b, h, p, n)).astype(np.float32)
    (jy, js), vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk),
                            *(jnp.asarray(a) for a in (xb, la, B, C)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gs)))
    live = [torch.tensor(a, requires_grad=True) for a in (xb, la, B, C)]
    y, s = ssd_chunked(*live, chunk)
    _close(y.detach().numpy(), jy)
    _close(s.detach().numpy(), js)
    got = torch.autograd.grad((y, s), live,
                              (torch.as_tensor(gy), torch.as_tensor(gs)))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    with torch.no_grad():
        y0, s0 = ssd_chunked(*live, chunk)
    assert torch.equal(y0, y.detach()) and torch.equal(s0, s.detach())


def test_function_matches_autograd_of_the_plain_forward():
    """SSDIntraChunk's backward equals autograd through the plain forward,
    B and C shared by the heads; it saves its four inputs, not y."""
    g1, H, q, p, n = 2, 4, 24, 8, 6
    arrs = _inputs((g1, H), q, p, n, seed=3, b_lead=(g1, 1))
    live = [torch.tensor(a, requires_grad=True) for a in arrs[:4]]
    dy, ds = (torch.as_tensor(a) for a in arrs[4:])
    y, s = SSDIntraChunk.apply(*live, None)
    got = torch.autograd.grad((y, s), live, (dy, ds), retain_graph=True)
    assert len(y.grad_fn.saved_tensors) == 4
    y_r, s_r = ref.ssd_intra_chunk(*live)
    want = torch.autograd.grad((y_r, s_r), live, (dy, ds))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_bwd_is_counted_and_refuses_cpu_tensors():
    assert "ssd_intra_chunk_bwd" in ops.launch_counts()
    ops.reset_launches()
    assert ops.launch_counts()["ssd_intra_chunk_bwd"] == 0
    args = [torch.as_tensor(a) for a in _inputs((2,), 16, 8, 4, seed=0)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_bwd.ssd_intra_chunk_bwd(*args)
    ops.ssd_intra_chunk_bwd(*args, device="cpu")  # the plain version
    assert ops.launch_counts()["ssd_intra_chunk_bwd"] == 0
