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
from repro_torch.kernels import flash, gmm_step, ops, pdist, precheck, ssd

pytestmark = pytest.mark.cuda

PDIST_SHAPES = [
    (8, 8, 4), (33, 17, 7), (128, 64, 32), (200, 300, 25), (5, 1000, 3),
    (1, 1, 1), (65, 129, 17), (64, 64, 5000), (327, 327, 5000),
]
GMM_SHAPES = [(16, 4), (100, 25), (1025, 7), (64, 128), (3, 300), (4097, 129)]
PRECHECK_SHAPES = [(8, 5, 4), (37, 17, 7), (128, 33, 100), (200, 129, 25),
                   (128, 257, 100), (128, 65, 5000), (1, 1, 1), (33, 70, 17)]
# (BH, Sq, Skv, hd, causal): tests/test_kernels.py's FLASH_SHAPES, then
# hd in {64, 112, 128, 256} with S off the 64-row tile, Sq != Skv, one row;
# then the edges of the bf16 tensor-core tiles: S off the 128-row tile (129,
# 255), Sq != Skv both ways under the causal mask, Sq = 1, hd 8, 40 and 256
FLASH_SHAPES = [
    (4, 64, 64, 16, True), (2, 48, 80, 32, False), (3, 33, 33, 8, True),
    (1, 128, 128, 64, True), (2, 96, 32, 16, False),
    (3, 100, 100, 64, True), (2, 200, 200, 112, True),
    (2, 130, 257, 112, False), (2, 70, 70, 128, True), (1, 90, 50, 128, True),
    (2, 65, 65, 256, False), (3, 1, 70, 112, False), (8, 1024, 1024, 112, True),
    (2, 129, 129, 64, True), (2, 255, 129, 40, True), (2, 129, 255, 40, False),
    (2, 129, 300, 112, True), (2, 300, 129, 64, True), (2, 1, 200, 64, False),
    (1, 1, 9, 8, False), (2, 255, 255, 256, True), (2, 129, 200, 256, False),
    (3, 255, 255, 8, False),
]
# (g, q, p, n): tests/test_kernels.py's SSD_SHAPES, then the model's chunk
# widths (q up to 256, p = 64, n = 64 or 128) and ragged q
SSD_SHAPES = [
    (2, 16, 8, 4), (3, 32, 16, 8), (1, 64, 32, 16), (4, 8, 64, 32),
    (5, 256, 64, 64), (3, 256, 64, 128), (7, 100, 64, 64), (2, 1, 16, 8),
    (9, 16, 64, 64),
]


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


def _route(dtype) -> str:
    return "wgmma" if dtype == torch.bfloat16 else "ffma"


def _flash_inputs(cuda, bh, sq, skv, hd, dtype):
    rng = np.random.default_rng(bh * 1000 + sq + hd)
    return [torch.as_tensor(rng.normal(size=(bh, s, hd)), device=cuda).to(
        dtype) for s in (sq, skv, skv)]


@pytest.mark.parametrize("bh,sq,skv,hd,causal", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_kernel_vs_plain(cuda, bh, sq, skv, hd, causal, dtype):
    q, k, v = _flash_inputs(cuda, bh, sq, skv, hd, dtype)
    before = flash.launches
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    o_r, lse_r = ops.flash_attention_fwd(q, k, v, causal=causal, force="ref")
    torch.cuda.synchronize()
    assert flash.launches == before + 1
    # bf16 runs on the tensor cores (every hd here is a multiple of 8), f32
    # on the FFMA kernel
    assert flash.last_route["fwd"] == _route(dtype)
    assert o.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(o, o_r, rtol=1e-4, atol=1e-4)
    else:  # 1e-2 relative to the output's scale: a bf16 rounding or two
        scale = float(o_r.float().abs().max())
        torch.testing.assert_close(o.float(), o_r.float(), rtol=1e-2,
                                   atol=1e-2 * scale)
    torch.testing.assert_close(lse, lse_r, rtol=1e-4, atol=1e-4)


def test_flash_fwd_kernel_matches_model_attention(cuda):
    """The model's attention layout (GQA kv heads expanded) through K4
    equals the plain path."""
    from repro_torch.models.attention import flash_attention

    rng = np.random.default_rng(7)
    B, S, H, KV, hd = 2, 100, 8, 2, 112
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, hd)),
                               dtype=torch.float32, device=cuda)
               for h in (H, KV, KV))
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q, k, v, causal=True, force="ref")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _ssd_inputs(cuda, g, q, p, n):
    rng = np.random.default_rng(g * 100 + q + n)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    return (f(rng.normal(size=(g, q, p))), f(-rng.uniform(0.01, 0.4, (g, q))),
            f(rng.normal(size=(g, q, n))), f(rng.normal(size=(g, q, n))))


def _close_to_scale(got, want, tol=2e-4):
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("g,q,p,n", SSD_SHAPES)
def test_ssd_kernel_vs_plain(cuda, g, q, p, n):
    xb, la, B, C = _ssd_inputs(cuda, g, q, p, n)
    before = ssd.launches
    y, s, dfs, td = ops.ssd_intra_chunk(xb, la, B, C)
    y_r, s_r, dfs_r, td_r = ops.ssd_intra_chunk(xb, la, B, C, force="ref")
    torch.cuda.synchronize()
    assert ssd.launches == before + 1
    assert y.shape == (g, q, p) and s.shape == (g, n, p)
    _close_to_scale(y, y_r)
    _close_to_scale(s, s_r)
    torch.testing.assert_close(dfs, dfs_r)
    torch.testing.assert_close(td, td_r)


def test_ssd_kernel_head_broadcast_strided(cuda):
    """The model's layout: cells (batch*chunk, head) as a permuted view of
    (B, S, H, P), B and C shared by all heads as stride-0 views. No copy
    per head is made, and y comes back in xbar's layout."""
    rng = np.random.default_rng(3)
    Bsz, nc, Q, H, P, N = 2, 3, 64, 12, 64, 64
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    xbar = f(rng.normal(size=(Bsz * nc, Q, H, P))).permute(0, 2, 1, 3)
    loga = f(-rng.uniform(0.01, 0.4, (Bsz * nc, Q, H))).permute(0, 2, 1)
    Bm = f(rng.normal(size=(Bsz * nc, 1, Q, N))).expand(-1, H, -1, -1)
    Cm = f(rng.normal(size=(Bsz * nc, 1, Q, N))).expand(-1, H, -1, -1)
    assert Bm.stride(1) == 0
    before = ssd.launches
    y, s, _, _ = ops.ssd_intra_chunk(xbar, loga, Bm, Cm)
    assert ssd.launches == before + 1
    assert y.stride() == xbar.stride()
    y_r, s_r, _, _ = ops.ssd_intra_chunk(
        xbar.contiguous(), loga.contiguous(), Bm.contiguous(),
        Cm.contiguous(), force="ref")
    _close_to_scale(y, y_r)
    _close_to_scale(s, s_r)


def test_ssd_chunked_kernel_matches_recurrent_scan(cuda):
    from repro_torch.kernels import ref
    from repro_torch.models.mamba import ssd_chunked

    rng = np.random.default_rng(1)
    b, l, h, p, n = 2, 96, 3, 16, 8
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    xb = f(rng.normal(size=(b, l, h, p)))
    la = f(-rng.uniform(0.01, 0.3, size=(b, l, h)))
    B = f(rng.normal(size=(b, l, n)))
    C = f(rng.normal(size=(b, l, n)))
    y, s_fin = ssd_chunked(xb, la, B, C, chunk=32)
    for bi in range(b):
        for hi in range(h):
            ys, sf = ref.ssd_reference_scan(xb[bi, :, hi], la[bi, :, hi],
                                            B[bi], C[bi])
            torch.testing.assert_close(y[bi, :, hi], ys, rtol=2e-4,
                                       atol=2e-4)
            torch.testing.assert_close(s_fin[bi, hi], sf.T, rtol=2e-4,
                                       atol=2e-4)


def test_lm_forward_launches_k4_and_k6(cuda):
    """A reduced hybrid forward on the card launches K4 once per shared
    attention application and K6 once per Mamba2 layer, and agrees with
    the plain path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                              dtype="float32")
    lm = LM(cfg)
    params = lm.init(0, device=cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 48)), device=cuda)
    ops.reset_launches()
    got, _, _ = lm.forward(params, toks)
    counts = ops.launch_counts()
    want, _, _ = lm.forward(params, toks, force="ref")
    supers = cfg.n_layers // cfg.shared_attn_every
    assert counts["flash_attention_fwd"] == supers
    assert counts["ssd_intra_chunk"] == cfg.n_layers
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def _flash_bwd_inputs(cuda, bh, sq, skv, hd, causal, dtype):
    """q, k, v, and o and lse from the plain forward, and a random do."""
    q, k, v = _flash_inputs(cuda, bh, sq, skv, hd, dtype)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal, force="ref")
    rng = np.random.default_rng(bh + sq + skv)
    do = torch.as_tensor(rng.normal(size=(bh, sq, hd)), device=cuda).to(dtype)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("bh,sq,skv,hd,causal", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_kernel_vs_plain(cuda, bh, sq, skv, hd, causal, dtype):
    args = _flash_bwd_inputs(cuda, bh, sq, skv, hd, causal, dtype)
    before = flash.bwd_launches
    got = ops.flash_attention_bwd(*args, causal=causal)
    want = ops.flash_attention_bwd(*args, causal=causal, force="ref")
    torch.cuda.synchronize()
    assert flash.bwd_launches == before + 1
    assert flash.last_route["bwd"] == _route(dtype)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        # relative to each gradient's largest entry: f32 sums in another
        # order, bf16 a rounding or two of the output
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), err


@pytest.mark.parametrize("hd", [64, 112])
def test_flash_bwd_kernel_is_deterministic(cuda, hd):
    args = _flash_bwd_inputs(cuda, 6, 300, 300, hd, True, torch.bfloat16)
    a = ops.flash_attention_bwd(*args)
    b = ops.flash_attention_bwd(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_loss_backward_on_the_card_launches_k4_and_k5(cuda):
    """A reduced dense model's loss and gradient on the card through K4 and
    K5 (with remat: K4 twice a layer) agree with the plain path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              dtype="float32")
    lm = LM(cfg)
    params = tree_map(lambda p: p.requires_grad_(True),
                      lm.init(0, device=cuda))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 100)), device=cuda)
    ops.reset_launches()
    loss, _ = lm.loss(params, toks)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == 2 * cfg.n_layers
    assert counts["flash_attention_bwd"] == cfg.n_layers
    loss_r, _ = lm.loss(params, toks, force="ref")
    grads_r = torch.autograd.grad(loss_r, tree_leaves(params))
    assert ops.launch_counts() == counts
    torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, grads_r):
        rel = float((g - w).norm() / (w.norm() + 1e-30))
        assert rel <= 1e-4, rel


def test_kernel_path_refuses_to_cut_a_graph_on_the_card(cuda):
    xb, la, B, C = _ssd_inputs(cuda, 2, 16, 8, 4)
    xb.requires_grad_(True)
    with pytest.raises(RuntimeError, match="cut silently"):
        ops.ssd_intra_chunk(xb, la, B, C)
    with torch.no_grad():
        ops.ssd_intra_chunk(xb, la, B, C)


def test_pipeline_selects_on_k2_as_on_the_plain_path(cuda):
    """The diverse batch selection launches K2 (tau a step) and picks the
    same sequences as the selection on plain GMM."""
    from repro_torch.data import DataConfig, Pipeline

    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=16, seed=3)
    pipe, pipe_r = Pipeline(cfg, device=cuda), Pipeline(cfg, force="ref",
                                                        device=cuda)
    for step in range(3):
        ops.reset_launches()
        b = pipe.batch_at(step)
        assert ops.launch_counts()["gmm_update"] == cfg.selector_tau
        b_r = pipe_r.batch_at(step)
        assert ops.launch_counts()["gmm_update"] == cfg.selector_tau
        assert torch.equal(b["tokens"], b_r["tokens"])
        assert torch.equal(b["domains"], b_r["domains"])
