"""CPU parity of the port's K4 (flash forward) and K6 (SSD intra-chunk)
plain versions with the JAX package's Pallas kernels, run in interpret
mode, and with the recurrent SSD oracle.

The same numpy inputs go to both packages. Tolerances are the JAX tests'
own (tests/test_kernels.py): 1e-4 for flash, 2e-4 for SSD.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash, ops, ref, ssd

# tests/test_kernels.py's FLASH_SHAPES, then zamba2's hd = 112 off the tile
FLASH_SHAPES = [
    (4, 64, 64, 16, True), (2, 48, 80, 32, False), (3, 33, 33, 8, True),
    (1, 128, 128, 64, True), (2, 96, 32, 16, False),
    (2, 70, 70, 112, True), (2, 40, 90, 112, False),
]
SSD_SHAPES = [
    (2, 16, 8, 4), (3, 32, 16, 8), (1, 64, 32, 16), (4, 8, 64, 32),
]


def _flash_inputs(bh, sq, skv, hd):
    rng = np.random.default_rng(bh * sq + hd)
    return [rng.normal(size=(bh, s, hd)).astype(np.float32)
            for s in (sq, skv, skv)]


def _ssd_inputs(g, q, p, n):
    rng = np.random.default_rng(g * 100 + q)
    return (rng.normal(size=(g, q, p)).astype(np.float32),
            -rng.uniform(0.01, 0.4, size=(g, q)).astype(np.float32),
            rng.normal(size=(g, q, n)).astype(np.float32),
            rng.normal(size=(g, q, n)).astype(np.float32))


@pytest.mark.parametrize("bh,sq,skv,hd,causal", FLASH_SHAPES)
def test_flash_fwd_plain_matches_jax_kernel(bh, sq, skv, hd, causal):
    q, k, v = _flash_inputs(bh, sq, skv, hd)
    want = jops.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_block=16, kv_block=32, force="interpret")
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal, device="cpu")
    assert o.dtype == torch.float32 and lse.shape == (bh, sq)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("bh,sq,skv,hd,causal", FLASH_SHAPES)
def test_flash_fwd_lse_is_logsumexp_of_scores(bh, sq, skv, hd, causal):
    q, k, v = _flash_inputs(bh, sq, skv, hd)
    s = np.einsum("bqh,bkh->bqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(hd)
    if causal:
        s = np.where(np.arange(sq)[:, None] >= np.arange(skv)[None], s,
                     -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    _, lse = ops.flash_attention_fwd(q, k, v, causal=causal, device="cpu")
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-4, atol=1e-4)


def test_flash_plain_chunked_rows_change_nothing(monkeypatch):
    q, k, v = (torch.as_tensor(a) for a in _flash_inputs(3, 100, 100, 112))
    o1, l1 = ref.flash_attention_fwd(q, k, v, causal=True)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 3 * 100 * 7)  # 7 rows a chunk
    o2, l2 = ref.flash_attention_fwd(q, k, v, causal=True)
    # the same formula per row; BLAS may sum a shorter block in another
    # order, so equal to f32 rounding
    torch.testing.assert_close(o1, o2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(l1, l2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (6, 1)])
def test_model_attention_matches_jax(H, KV):
    """models.attention (layout + GQA expansion + K4's plain path) against
    the JAX model's flash attention."""
    from repro.models.attention import flash_attention as jflash
    from repro_torch.models.attention import flash_attention

    rng = np.random.default_rng(H * 10 + KV)
    B, S, hd = 2, 48, 16
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, q_block=16, kv_block=16)
    got = flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("g,q,p,n", SSD_SHAPES)
def test_ssd_plain_matches_jax_kernel(g, q, p, n):
    args = _ssd_inputs(g, q, p, n)
    want = jops.ssd_intra_chunk(*map(jnp.asarray, args), force="interpret")
    got = ops.ssd_intra_chunk(*args, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4)


def test_ssd_plain_head_broadcast_and_chunks(monkeypatch):
    """Cells as (cells, heads) with B and C as stride-0 head views give
    the per-cell result of contiguous copies, and walking the cells in
    chunks changes nothing."""
    xb, la, B, C = (torch.as_tensor(a) for a in _ssd_inputs(6, 32, 16, 8))
    H = 3
    xb4 = xb.reshape(2, H, 32, 16)
    la4 = la.reshape(2, H, 32)
    B4 = B.reshape(2, H, 32, 8)[:, :1].expand(-1, H, -1, -1)
    C4 = C.reshape(2, H, 32, 8)[:, :1].expand(-1, H, -1, -1)
    y, s, _, _ = ops.ssd_intra_chunk(xb4, la4, B4, C4, device="cpu")
    y_c, s_c, _, _ = ops.ssd_intra_chunk(
        xb4.reshape(6, 32, 16), la4.reshape(6, 32),
        B4.reshape(6, 32, 8), C4.reshape(6, 32, 8), device="cpu")
    torch.testing.assert_close(y.reshape(6, 32, 16), y_c)
    torch.testing.assert_close(s.reshape(6, 8, 16), s_c)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 1)  # one leading row a chunk
    y2, s2, _, _ = ops.ssd_intra_chunk(xb4, la4, B4, C4, device="cpu")
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(s, s2, rtol=0, atol=0)


def test_ssd_reference_scan_matches_jax():
    rng = np.random.default_rng(5)
    l, p, n = 40, 8, 6
    args = (rng.normal(size=(l, p)).astype(np.float32),
            -rng.uniform(0.01, 0.3, size=(l,)).astype(np.float32),
            rng.normal(size=(l, n)).astype(np.float32),
            rng.normal(size=(l, n)).astype(np.float32))
    ys_j, s_j = jref.ssd_reference_scan(*map(jnp.asarray, args))
    ys, s = ref.ssd_reference_scan(*map(torch.as_tensor, args))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("chunk", [8, 16, 48])
def test_ssd_chunked_matches_recurrent_scan(chunk):
    """models.mamba.ssd_chunked (K6's plain path plus the inter-chunk
    recurrence) == the step-by-step oracle, and == the JAX model's."""
    from repro.models.mamba import ssd_chunked as jssd_chunked
    from repro_torch.models.mamba import ssd_chunked

    rng = np.random.default_rng(1)
    b, l, h, p, n = 2, 48, 3, 8, 5
    xb = rng.normal(size=(b, l, h, p)).astype(np.float32)
    la = -rng.uniform(0.01, 0.3, size=(b, l, h)).astype(np.float32)
    B = rng.normal(size=(b, l, n)).astype(np.float32)
    C = rng.normal(size=(b, l, n)).astype(np.float32)
    y, s_fin = ssd_chunked(*map(torch.as_tensor, (xb, la, B, C)), chunk)
    for bi in range(b):
        for hi in range(h):
            ys, sf = ref.ssd_reference_scan(
                torch.as_tensor(xb[bi, :, hi]), torch.as_tensor(la[bi, :, hi]),
                torch.as_tensor(B[bi]), torch.as_tensor(C[bi]))
            np.testing.assert_allclose(y[bi, :, hi].numpy(), ys.numpy(),
                                       rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(s_fin[bi, hi].numpy(), sf.T.numpy(),
                                       rtol=2e-4, atol=2e-4)
    y_j, s_j = jssd_chunked(*map(jnp.asarray, (xb, la, B, C)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(s_j), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("which", ["flash", "ssd"])
def test_kernel_wrappers_refuse_cpu_tensors(which):
    """A kernel wrapper launches on a CUDA tensor or raises; the plain
    version is ops' choice for a CPU tensor, never the wrapper's."""
    if which == "flash":
        q, k, v = (torch.as_tensor(a) for a in _flash_inputs(1, 8, 8, 16))
        with pytest.raises(ValueError, match="CUDA"):
            flash.flash_attention_fwd(q, k, v)
    else:
        args = [torch.as_tensor(a) for a in _ssd_inputs(2, 16, 8, 4)]
        with pytest.raises(ValueError, match="CUDA"):
            ssd.ssd_intra_chunk(*args)


def test_new_kernels_are_counted():
    counts = ops.launch_counts()
    assert {"flash_attention_fwd", "ssd_intra_chunk"} <= set(counts)
