"""The port's kernels on the card against their plain versions.

Needs an NVIDIA GPU (marker ``cuda``); skips without one. Imports only
torch and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import shutil

import numpy as np
import pytest
import torch

from repro_torch.device import disable_tf32
from repro_torch.core import MatroidSpec, streaming
from repro_torch.kernels import (
    flash, gmm_step, ops, pdist, precheck, ref, ssd, ssd_bwd,
)

pytestmark = pytest.mark.cuda

# then d off the 32-column panel and the split width: d below one panel,
# d % 4 != 0 (element copies), odd d over several splits
PDIST_SHAPES = [
    (8, 8, 4), (33, 17, 7), (128, 64, 32), (200, 300, 25), (5, 1000, 3),
    (1, 1, 1), (65, 129, 17), (64, 64, 5000), (327, 327, 5000),
    (100, 64, 31), (70, 90, 33), (64, 200, 4999), (130, 70, 4100),
]
# (n, d) of x against itself: the sym route
PDIST_SELF_SHAPES = [(300, 5000), (327, 5000), (1408, 5000), (70, 33),
                     (65, 20)]
GMM_SHAPES = [(16, 4), (100, 25), (1025, 7), (64, 128), (3, 300), (4097, 129)]
# then K3's edges: T = 257 (tau 256) at the main path's d, a row tile
# cut short (B < 16) with d off the chunk, several panels of 256 valid
# centers, d past one cluster's 16 x 256 columns
PRECHECK_SHAPES = [(8, 5, 4), (37, 17, 7), (128, 33, 100), (200, 129, 25),
                   (128, 257, 100), (128, 65, 5000), (1, 1, 1), (33, 70, 17),
                   (128, 257, 5000), (5, 65, 4999), (70, 700, 40),
                   (20, 3, 9000)]
# (BH, Sq, Skv, hd, causal): tests/test_kernels.py's FLASH_SHAPES, then
# hd in {64, 112, 128, 256} with S off the 64-row tile, Sq != Skv, one row;
# then the edges of the bf16 tensor-core tiles: S off the 128-row tile (129,
# 255), Sq != Skv both ways under the causal mask, Sq = 1, hd 8, 40 and 256;
# then a vlm's cross attention (text queries against 1,024 image tokens,
# hd 128, not causal): prompts shorter, as long, longer and off the tiles
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
    (4, 100, 1024, 128, False), (2, 1024, 1024, 128, False),
    (3, 1300, 1024, 128, False), (2, 1, 1024, 128, False),
]
# (g, q, p, n): tests/test_kernels.py's SSD_SHAPES, then the model's chunk
# widths (q up to 256, p = 64, n = 64 or 128) and ragged q
SSD_SHAPES = [
    (2, 16, 8, 4), (3, 32, 16, 8), (1, 64, 32, 16), (4, 8, 64, 32),
    (5, 256, 64, 64), (3, 256, 64, 128), (7, 100, 64, 64), (2, 1, 16, 8),
    (9, 16, 64, 64), (5, 33, 48, 100), (4, 20, 6, 10), (3, 300, 64, 72),
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
    assert pdist.last_route == "full"
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


@pytest.mark.parametrize("n,d", PDIST_SELF_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pdist_kernel_self_distance_is_exactly_zero(cuda, n, d, dtype):
    """x against itself takes the sym route: norms and dot products share
    one FFMA order and one split order, so d(x, x) = 0 exactly (the plain
    matmul form leaves cancellation noise there); D equals its transpose
    bit for bit, and two calls give the same bits."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(n, d)), device=cuda).to(dtype)
    x = x / x.float().norm(dim=1, keepdim=True).to(dtype)
    d2 = ops.pairwise_sqdist(x, x)
    assert pdist.last_route == "sym"
    assert torch.count_nonzero(torch.diagonal(d2)) == 0
    assert torch.equal(d2, d2.T)
    assert torch.equal(d2, ops.pairwise_sqdist(x, x))
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(d2, ops.pairwise_sqdist(x, x, force="ref"),
                               rtol=tol, atol=tol)


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


def _precheck_inputs(cuda, B, T, d, seed=0):
    rng = np.random.default_rng(B * 100 + T + seed)
    x = torch.as_tensor(rng.normal(size=(B, d)) * 3, dtype=torch.float32,
                        device=cuda)
    c = torch.as_tensor(rng.normal(size=(T, d)) * 3, dtype=torch.float32,
                        device=cuda)
    cv = torch.as_tensor(rng.random(T) > 0.2, device=cuda)
    return x, c, cv


@pytest.mark.parametrize("B,T,d", PRECHECK_SHAPES)
def test_precheck_kernel_vs_plain(cuda, B, T, d):
    _check_precheck(*_precheck_inputs(cuda, B, T, d))


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


def _check_block_precheck(x, c, cv, x1, thr, r2):
    """K3's fused route against ``ref.block_precheck`` on the plain path:
    one launch a call, two calls bit-identical, z equal on every row where
    both flags are off, and a flag that differs only where the plain
    path's comparison lies within 2 margins (the third center) or within
    2 SLACK (the refined comparisons) of its boundary. Returns the rows
    whose flag is off on both paths."""
    before = precheck.launches
    out = ops.block_precheck(x, c, cv, x1, thr, r2)
    again = ops.block_precheck(x, c, cv, x1, thr, r2)
    torch.cuda.synchronize()
    assert precheck.launches == before + 2
    assert out.dtype == torch.int32 and out.shape == (2, x.shape[0])
    assert torch.equal(out, again)
    assert bool(torch.all((out[1] == 0) | (out[1] == 1)))
    z, f = out[0], out[1] != 0
    plain = ops.block_precheck(x, c, cv, x1, thr, r2, force="ref")
    zr, fr = plain[0], plain[1] != 0
    assert precheck.launches == before + 2
    dmin_e, z1, _, z2, third_e, margin = ops.center_precheck(
        x, c, cv, force="ref")
    d1e = torch.where(cv[z1.long()], ref.point_dist(c[z1.long()], x),
                      ref._F32_MAX)
    d2e = torch.where(cv[z2.long()], ref.point_dist(c[z2.long()], x),
                      ref._F32_MAX)
    dmin = torch.minimum(d1e, d2e)
    off = ~f & ~fr
    assert torch.equal(z[off], zr[off])
    slack = 2 * ref.SLACK
    near = (((third_e - dmin_e) - 2 * margin).abs() <= 2 * margin) | (
        (d1e - d2e).abs() <= slack * dmin) | ((dmin - thr).abs() <= slack * thr)
    if x1 is not None:
        d1 = ref.point_dist(x, x1[None, :])
        near |= (d1 - r2).abs() <= slack * r2
    assert bool(torch.all(near[f != fr]))
    return off


@pytest.mark.parametrize("B,T,d", PRECHECK_SHAPES)
@pytest.mark.parametrize("variant", ["radius", "diameter"])
def test_block_precheck_kernel_vs_plain(cuda, B, T, d, variant):
    """Thresholds at the median of the plain path's nearest distance (and
    of d(x, x1)), so rows fall on both sides of every boundary."""
    x, c, cv = _precheck_inputs(cuda, B, T, d)
    dmin = ops.center_precheck(x, c, cv, force="exact")[0]
    thr = float(torch.quantile(dmin[dmin < 1e30], 0.5)) if bool(
        torch.any(dmin < 1e30)) else 1.0
    x1 = r2 = None
    if variant == "diameter":
        x1 = x[0].clone()
        r2 = float(torch.quantile(ref.point_dist(x, x1[None, :]), 0.5))
    _check_block_precheck(x, c, cv, x1, thr, r2)


@pytest.mark.parametrize("T", [1, 65, 257])
def test_precheck_kernel_repeats_bit_for_bit(cuda, T):
    x, c, cv = _precheck_inputs(cuda, 128, T, 5000, seed=1)
    a = ops.center_precheck(x, c, cv)
    b = ops.center_precheck(x, c, cv)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    thr = float(a[0][a[0] < 1e30].median()) if bool(
        torch.any(a[0] < 1e30)) else 1.0
    p = ops.block_precheck(x, c, cv, x[3], thr, 10.0)
    q = ops.block_precheck(x, c, cv, x[3], thr, 10.0)
    assert torch.equal(p, q)


@pytest.mark.parametrize("B,T,d", [(128, 257, 5000), (128, 400, 5000),
                                   (70, 700, 40)])
def test_precheck_multi_panel_repeats_bit_for_bit(cuda, B, T, d):
    """More than 127 valid centers take several panels; the leader's
    distance tiles share the ring with the next panel's stages. Many calls
    of both routes, back to back, give one result."""
    x, c, _ = _precheck_inputs(cuda, B, T, d, seed=2)
    cv = torch.ones(T, dtype=torch.bool, device=cuda)
    thr = float(ops.center_precheck(x, c, cv, force="exact")[0].median())
    stats = [torch.stack([t.float() for t in
                          precheck.center_precheck_stats(x, c, cv)])
             for _ in range(200)]
    fused = [ops.block_precheck(x, c, cv, x[1], thr, 2 * thr)
             for _ in range(200)]
    torch.cuda.synchronize()
    for runs in (stats, fused):
        assert all(torch.equal(r, runs[0]) for r in runs[1:])
    _check_precheck(x, c, cv)
    _check_block_precheck(x, c, cv, x[1], thr, 2 * thr)


def test_precheck_is_one_kernel_launch(cuda):
    """Each route is one kernel on the card and nothing else: no scratch
    fill, no second pass, no torch op."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, c, cv = _precheck_inputs(cuda, 128, 65, 5000)
    x1 = x[0].clone()
    for fn in (lambda: precheck.center_precheck_stats(x, c, cv),
               lambda: precheck.block_precheck(x, c, cv, None, 1.0, 0.0,
                                               0.0, 0.0),
               lambda: precheck.block_precheck(x, c, cv, x1, 1.0, 0.0,
                                               2.0, 0.0)):
        fn()  # builds, plans
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        assert len(names) == 1 and "precheck_kernel" in names[0], names
    plan = precheck.last_plan
    # the main path's shape runs in one wave: every cluster resident at once
    assert plan["S"] == 16 and plan["chunk"] == 320 and plan["tiles"] == 8
    assert plan["max_active_clusters"] >= plan["tiles"]


def test_block_precheck_ties_and_invalid_centers(cuda):
    """Duplicated centers tie exactly (the flag is on, z is the first
    column); all centers invalid (every flag on, z = 0); one valid center
    not at column 0 (z is that center, the flag as the plain path's)."""
    rng = np.random.default_rng(3)
    base = torch.as_tensor(rng.normal(size=(3, 64)), dtype=torch.float32,
                           device=cuda)
    c = base[torch.as_tensor([2, 0, 1, 0, 2, 1, 0] * 10, device=cuda)]
    c = c.contiguous()
    x = (base[torch.as_tensor([0, 1, 2] * 40, device=cuda)]
         + 0.3 * torch.as_tensor(rng.normal(size=(120, 64)),
                                 dtype=torch.float32, device=cuda))
    cv = torch.ones(c.shape[0], dtype=torch.bool, device=cuda)
    cv[1] = False
    z, f = ops.block_precheck(x, c, cv, None, 100.0, None)
    zr, fr = ops.block_precheck(x, c, cv, None, 100.0, None, force="exact")
    assert bool(torch.all(f == 1)) and torch.equal(fr, f)
    assert torch.equal(z, zr)
    cv[:] = False
    z, f = ops.block_precheck(x, c, cv, None, 100.0, None)
    assert bool(torch.all(f == 1)) and not bool(torch.any(z))
    cv[37] = True
    z, f = ops.block_precheck(x, c, cv, x[5], 100.0, 1e6)
    zr, fr = ops.block_precheck(x, c, cv, x[5], 100.0, 1e6, force="ref")
    assert torch.equal(z, torch.full_like(z, 37)) and torch.equal(f, fr)


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


def test_model_attention_at_batch_one_on_the_card(cuda):
    """One sequence (B = 1, where the heads-first reshape alone is a
    strided view) through K4 and K5 from the model's layout, GQA and not
    causal too, against the plain path."""
    from repro_torch.models.attention import flash_attention

    rng = np.random.default_rng(8)
    for sq, skv, H, KV, causal in ((100, 100, 8, 2, True),
                                   (40, 130, 4, 4, False)):
        q, k, v = (torch.as_tensor(rng.normal(size=(1, s, h, 64)),
                                   dtype=torch.float32, device=cuda)
                   .requires_grad_(True)
                   for s, h in ((sq, H), (skv, KV), (skv, KV)))
        do = torch.as_tensor(rng.normal(size=(1, sq, H, 64)),
                             dtype=torch.float32, device=cuda)
        outs = []
        for force in (None, "ref"):
            o = flash_attention(q, k, v, causal=causal, force=force)
            outs.append((o, *torch.autograd.grad(o, (q, k, v), do)))
        for a, b in zip(*outs):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


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
    assert ssd.last_route == "per_cell"
    assert y.shape == (g, q, p) and s.shape == (g, n, p)
    _close_to_scale(y, y_r)
    _close_to_scale(s, s_r)
    torch.testing.assert_close(dfs, dfs_r)
    torch.testing.assert_close(td, td_r)


@pytest.mark.parametrize("Q", [1, 16, 64, 100, 256])
def test_ssd_kernel_head_broadcast_strided(cuda, Q):
    """The model's layout: cells (batch*chunk, head) as a permuted view of
    (B, S, H, P), B and C shared by all heads as stride-0 views, which
    takes the shared_bc route (q <= 32 packs several heads a block). No
    copy per head is made, y comes back in xbar's layout, and two calls
    give the same bits."""
    rng = np.random.default_rng(3)
    Bsz, nc, H, P, N = 2, 3, 12, 64, 64
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    xbar = f(rng.normal(size=(Bsz * nc, Q, H, P))).permute(0, 2, 1, 3)
    loga = f(-rng.uniform(0.01, 0.4, (Bsz * nc, Q, H))).permute(0, 2, 1)
    Bm = f(rng.normal(size=(Bsz * nc, 1, Q, N))).expand(-1, H, -1, -1)
    Cm = f(rng.normal(size=(Bsz * nc, 1, Q, N))).expand(-1, H, -1, -1)
    assert Bm.stride(1) == 0
    before = ssd.launches
    y, s, _, _ = ops.ssd_intra_chunk(xbar, loga, Bm, Cm)
    assert ssd.launches == before + 1
    assert ssd.last_route == "shared_bc"
    assert y.stride() == xbar.stride()
    y2, s2, _, _ = ops.ssd_intra_chunk(xbar, loga, Bm, Cm)
    assert torch.equal(y, y2) and torch.equal(s, s2)
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


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |t| (8 significant bits)."""
    a = t.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


# the main paths' head widths (zamba2-7b 112, smollm-135m 64) and edges of
# the tensor-core tiles
FLASH_LIKE_SHAPES = [(8, 1024, 1024, 112, True), (4, 512, 512, 64, True),
                     (2, 255, 129, 40, True), (2, 129, 300, 112, True),
                     (2, 129, 255, 256, False)]


@pytest.mark.parametrize("bh,sq,skv,hd,causal", FLASH_LIKE_SHAPES)
def test_flash_bf16_kernels_vs_plain_like_for_like(cuda, bh, sq, skv, hd,
                                                   causal):
    """K4 and K5's bf16 tensor-core routes against the plain versions with
    P (and dS) rounded to bf16 as the kernels round them
    (``ref.flash_attention_fwd/_bwd(bf16_p=True)``): every output element
    within one bf16 spacing of the plain one (both round their f32 result
    to bf16 once, so a result near a rounding boundary may land on either
    side) plus 2e-3 of the output's largest entry, where the f32-P plain
    versions need the 1e-2 gates above."""
    q, k, v = _flash_inputs(cuda, bh, sq, skv, hd, torch.bfloat16)
    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    o_r, lse_r = ref.flash_attention_fwd(q, k, v, causal=causal, bf16_p=True)
    assert flash.last_route["fwd"] == "wgmma"
    scale = float(o_r.float().abs().max())
    assert bool(torch.all((o.float() - o_r.float()).abs()
                          <= _bf16_ulp(o_r) + 2e-3 * scale))
    torch.testing.assert_close(lse, lse_r, rtol=1e-4, atol=1e-4)
    do = torch.as_tensor(np.random.default_rng(bh + sq).normal(
        size=(bh, sq, hd)), device=cuda).to(torch.bfloat16)
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   bf16_p=True)
    assert flash.last_route["bwd"] == "wgmma"
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        assert bool(torch.all((g.float() - w.float()).abs()
                              <= _bf16_ulp(w) + 2e-3 * scale))


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


# (g, q, p, n) of K6b, per cell: q 1 and 16 (one partial tile), 48, 100
# and 256 (4 tiles, the model's chunk), n 64 and 128
SSD_BWD_SHAPES = [(2, 1, 16, 8), (3, 16, 8, 4), (4, 16, 64, 64),
                  (3, 48, 16, 8), (2, 100, 64, 72), (3, 256, 64, 128),
                  (5, 256, 64, 64), (2, 256, 6, 10)]


def _ssd_bwd_grads(cuda, lead, q, p, n, seed):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    return (f(rng.normal(size=(*lead, q, p))),
            f(rng.normal(size=(*lead, n, p))))


def _check_ssd_bwd(got, want, tol=2e-4):
    """Each gradient within 2e-4 of the plain version's largest entry."""
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(1.0, float(w.abs().max()))
        torch.testing.assert_close(g, w, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("g,q,p,n", SSD_BWD_SHAPES)
def test_ssd_bwd_kernel_vs_plain(cuda, g, q, p, n):
    xb, la, B, C = _ssd_inputs(cuda, g, q, p, n)
    dy, ds = _ssd_bwd_grads(cuda, (g,), q, p, n, seed=q)
    before = ssd_bwd.launches
    got = ops.ssd_intra_chunk_bwd(xb, la, B, C, dy, ds)
    again = ops.ssd_intra_chunk_bwd(xb, la, B, C, dy, ds)
    want = ops.ssd_intra_chunk_bwd(xb, la, B, C, dy, ds, force="ref")
    torch.cuda.synchronize()
    assert ssd_bwd.launches == before + 2
    assert ssd_bwd.last_route == "per_cell"
    _check_ssd_bwd(got, want)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Q", [16, 256])
def test_ssd_bwd_kernel_head_broadcast_strided(cuda, Q):
    """The model's layout: xbar, dy and loga permuted views of (B, S, H,
    .), B and C of size 1 along the heads (a stride-0 broadcast): dB and
    dC come back in that shape, summed over the heads in a fixed order;
    dxbar in xbar's layout; two calls give the same bits."""
    rng = np.random.default_rng(Q)
    Bsz, nc, H, P, N = 2, 3, 12, 64, 128
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    xbar = f(rng.normal(size=(Bsz * nc, Q, H, P))).permute(0, 2, 1, 3)
    dy = f(rng.normal(size=(Bsz * nc, Q, H, P))).permute(0, 2, 1, 3)
    loga = f(-rng.uniform(0.01, 0.4, (Bsz * nc, Q, H))).permute(0, 2, 1)
    Bm = f(rng.normal(size=(Bsz * nc, 1, Q, N)))
    Cm = f(rng.normal(size=(Bsz * nc, 1, Q, N)))
    ds = f(rng.normal(size=(Bsz * nc, H, N, P)))
    got = ops.ssd_intra_chunk_bwd(xbar, loga, Bm, Cm, dy, ds)
    assert ssd_bwd.last_route == "shared_bc"
    assert got[0].stride() == xbar.stride()
    assert got[2].shape == Bm.shape and got[3].shape == Cm.shape
    again = ops.ssd_intra_chunk_bwd(xbar, loga, Bm, Cm, dy, ds)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    want = ops.ssd_intra_chunk_bwd(
        xbar.contiguous(), loga.contiguous(), Bm, Cm, dy.contiguous(), ds,
        force="ref")
    _check_ssd_bwd(got, want)
    # the per-cell route on the same cells: its dB and dC, summed over
    # the heads, are the shared route's
    Bx, Cx = (t.expand(-1, H, -1, -1).contiguous() for t in (Bm, Cm))
    cells = ops.ssd_intra_chunk_bwd(xbar, loga, Bx, Cx, dy, ds)
    assert ssd_bwd.last_route == "per_cell"
    _check_ssd_bwd((cells[2].sum(1, keepdim=True),
                    cells[3].sum(1, keepdim=True)), got[2:])


# (heads, q, n) in the model's layout, B and C shared by the heads: head
# counts that no head slice divides (1, 8, 12) and the models' (80: mamba2,
# 112: zamba2), q 1, 48, 100 and 256, n 64, 72 and 128
SSD_BWD_HEAD_SHAPES = [(1, 256, 128), (8, 100, 64), (12, 1, 128),
                       (12, 48, 72), (80, 256, 128), (112, 256, 64),
                       (112, 100, 64)]


@pytest.mark.parametrize("H,q,n", SSD_BWD_HEAD_SHAPES)
def test_ssd_bwd_kernel_head_slices(cuda, H, q, n):
    """The heads of a batch * chunk cut into slices over several blocks:
    every gradient against the plain version, dB and dC summed over all
    heads, two calls bit-identical."""
    rng = np.random.default_rng(H * 1000 + q)
    bc, P = 2, 64
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    xbar = f(rng.normal(size=(bc, q, H, P))).permute(0, 2, 1, 3)
    dy = f(rng.normal(size=(bc, q, H, P))).permute(0, 2, 1, 3)
    loga = f(-rng.uniform(0.01, 0.4, (bc, q, H))).permute(0, 2, 1)
    Bm = f(rng.normal(size=(bc, 1, q, n)))
    Cm = f(rng.normal(size=(bc, 1, q, n)))
    ds = f(rng.normal(size=(bc, H, n, P)))
    got = ops.ssd_intra_chunk_bwd(xbar, loga, Bm, Cm, dy, ds)
    assert ssd_bwd.last_route == ("shared_bc" if H > 1 else "per_cell")
    again = ops.ssd_intra_chunk_bwd(xbar, loga, Bm, Cm, dy, ds)
    want = ops.ssd_intra_chunk_bwd(
        xbar.contiguous(), loga.contiguous(), Bm, Cm, dy.contiguous(), ds,
        force="ref")
    torch.cuda.synchronize()
    _check_ssd_bwd(got, want)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("q,p,n", [(100, 63, 72), (256, 64, 128), (1, 5, 3),
                                   (16, 64, 64)])
def test_ssd_bwd_kernel_rows_not_16_byte_aligned(cuda, q, p, n):
    """Every operand a view one float into a wider buffer, so no row is
    16-byte aligned (the 4-byte copies): against the plain version, and
    bit-identical on a repeat."""
    g = 3
    rng = np.random.default_rng(q + p + n)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)

    def shifted(*shape):
        return f(rng.normal(size=(*shape[:-1], shape[-1] + 1)))[..., 1:]

    xb, B, C, dy = (shifted(g, q, w) for w in (p, n, n, p))
    ds = shifted(g, n, p)
    la = f(-rng.uniform(0.01, 0.4, (g, q)))
    got = ops.ssd_intra_chunk_bwd(xb, la, B, C, dy, ds)
    assert ssd_bwd.last_route == "per_cell"
    again = ops.ssd_intra_chunk_bwd(xb, la, B, C, dy, ds)
    want = ops.ssd_intra_chunk_bwd(xb, la, B, C, dy, ds, force="ref")
    torch.cuda.synchronize()
    _check_ssd_bwd(got, want)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_ssd_bwd_describe_reports_the_design(cuda):
    """mamba2-2.7b's layer: the cell kernel fits two blocks an SM with no
    spills, and its grid covers every (group, slice, s-tile pair)."""
    d = ssd_bwd.describe(64, 80, 256, 128, True, cuda.index or 0)
    assert d["blocks_per_sm"] >= 2 and d["local_bytes"] == 0, d
    assert d["cell_blocks"] == 64 * d["slices"] * 2, d
    assert d["slices"] * d["cells_a_slice"] >= 80, d


def test_ssd_bwd_is_counted_and_refuses_cpu_tensors(cuda):
    xb, la, B, C = _ssd_inputs(cuda, 2, 16, 8, 4)
    dy, ds = _ssd_bwd_grads(cuda, (2,), 16, 8, 4, seed=0)
    ops.reset_launches()
    ops.ssd_intra_chunk_bwd(xb, la, B, C, dy, ds)
    ops.ssd_intra_chunk_bwd(xb, la, B, C, dy, ds, force="ref")
    assert ops.launch_counts()["ssd_intra_chunk_bwd"] == 1
    with pytest.raises(ValueError, match="CUDA"):
        ssd_bwd.ssd_intra_chunk_bwd(*(t.cpu() for t in (xb, la, B, C, dy,
                                                         ds)))
    xb.requires_grad_(True)
    with pytest.raises(RuntimeError, match="cut silently"):
        ops.ssd_intra_chunk_bwd(xb, la, B, C, dy, ds)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_ssm_loss_backward_on_the_card_launches_k6_and_k6b(cuda, arch):
    """A reduced ssm / hybrid model's loss and gradient on the card (K6
    twice a Mamba2 layer with remat, K6b once; the hybrid's shared
    attention through K4 and K5) agree with the plain path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    lm = LM(cfg)
    params = tree_map(lambda p: p.requires_grad_(True),
                      lm.init(0, device=cuda))
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 96)), device=cuda)
    ops.reset_launches()
    loss, _ = lm.loss(params, toks)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    counts = ops.launch_counts()
    assert counts["ssd_intra_chunk"] == 2 * cfg.n_layers
    assert counts["ssd_intra_chunk_bwd"] == cfg.n_layers
    supers = (cfg.n_layers // cfg.shared_attn_every
              if cfg.family == "hybrid" else 0)
    assert counts["flash_attention_bwd"] == supers
    loss_r, _ = lm.loss(params, toks, force="ref")
    grads_r = torch.autograd.grad(loss_r, tree_leaves(params))
    assert ops.launch_counts() == counts
    torch.testing.assert_close(loss, loss_r, rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, grads_r):
        rel = float((g - w).norm() / (w.norm() + 1e-30))
        assert rel <= 1e-4, rel


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


# --------------------------------------------------------------------------
# the batched final-stage engines and the observability guard on the card
# --------------------------------------------------------------------------


def _engine_ctx(device, kind, m=48, h=4, seed=0):
    from repro_torch.core.matroid import TransversalMatroid, make_host_matroid
    from repro_torch.core.solvers import SolveContext

    rng = np.random.default_rng(seed)
    P = rng.normal(size=(m, 6))
    D = np.sqrt(((P[:, None] - P[None]) ** 2).sum(-1)).astype(np.float32)
    if kind == "transversal":
        cats = np.full((m, 2), -1, np.int32)
        cats[:, 0] = rng.integers(0, h, m)
        extra = rng.random(m) < 0.4
        cats[extra, 1] = rng.integers(0, h, int(extra.sum()))
        spec = MatroidSpec("transversal", num_categories=h, gamma=2)
        return SolveContext(D=D, spec=spec, cats=cats, device=device,
                            matroid_fn=lambda s: TransversalMatroid(cats, h))
    cats = rng.integers(0, h, (m, 1)).astype(np.int32)
    caps = np.full(h, 3, np.int32)
    spec = MatroidSpec("partition", num_categories=h, gamma=1)
    return SolveContext(
        D=D, spec=spec, cats=cats, caps=caps, device=device,
        matroid_fn=lambda s: make_host_matroid(spec, cats, caps, m, s.k))


def _engine_specs(variant, m, n=8, seed=1):
    from repro_torch.core.solvers import SolveSpec

    rng = np.random.default_rng(seed)
    return [SolveSpec(k=int(rng.integers(2, 9)), variant=variant,
                      gamma=float(rng.choice([0.0, 0.01])),
                      allow=rng.random(m) < 0.8) for _ in range(n)]


@pytest.mark.parametrize("engine,variant", [("jit_sum", "sum"),
                                            ("jit_greedy", "star"),
                                            ("jit_greedy", "tree")])
@pytest.mark.parametrize("kind", ["partition", "transversal"])
def test_batched_engines_on_the_card_equal_the_cpu(cuda, engine, variant,
                                                   kind):
    """The batched engines sum the selection's distances exactly before
    one rounding, so the card's run decides as the CPU's does."""
    import dataclasses

    from repro_torch.core.solvers import get_engine

    ctx = _engine_ctx(cuda, kind)
    specs = _engine_specs(variant, ctx.size)
    got = get_engine(engine).solve_batch(ctx, specs)
    want = get_engine(engine).solve_batch(
        dataclasses.replace(ctx, device="cpu"), specs)
    for a, b in zip(got, want):
        assert a.local_indices.tolist() == b.local_indices.tolist()
        assert a.value == b.value


def test_stacked_lanes_on_the_card_equal_per_lane_solves(cuda):
    import dataclasses

    from repro_torch.core.solvers import JIT_SUM, solve_stacked

    lanes = []
    for t in range(3):
        ctx = _engine_ctx(cuda, "partition", seed=10 + t)
        lanes.append((ctx, _engine_specs("sum", ctx.size, n=1 + 3 * t,
                                         seed=t)))
    stacked = solve_stacked(lanes)
    for (ctx, specs), sols in zip(lanes, stacked):
        per_lane = JIT_SUM.solve_batch(ctx, specs)
        cpu = JIT_SUM.solve_batch(dataclasses.replace(ctx, device="cpu"),
                                  specs)
        for a, b, c in zip(sols, per_lane, cpu):
            assert a.local_indices.tolist() == b.local_indices.tolist()
            assert a.local_indices.tolist() == c.local_indices.tolist()
            assert a.value == b.value == c.value


def test_obs_guard_raises_during_cuda_graph_capture(cuda):
    from repro_torch import obs

    reg = obs.MetricsRegistry()
    c = reg.counter("captured")
    buf = obs.TraceBuffer(capacity=4)
    x = torch.ones(8, device=cuda)
    y = x * 2  # warm up outside the capture
    torch.cuda.synchronize()
    with pytest.raises(obs.TracerLeakError):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            y = x * 2
            c.inc()
    with pytest.raises(obs.TracerLeakError):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            with buf.span("captured"):
                y = x + 1
    torch.cuda.synchronize()
    assert c.value == 0 and buf.drain() == []
    c.inc()  # outside the capture: host-side as ever
    assert c.value == 1 and y.shape == x.shape


def test_service_on_the_card_equals_the_cpu(cuda):
    """``DiversityService`` on the card: ingest and submit launch K3, a
    cold tenant entry launches K1 once (a warm one none), the entry's D
    stays on the card, and the stream, its epochs and the host engine's
    selections equal the same service on the CPU."""
    from repro_torch.serve.diversity import DiversityQuery, DiversityService

    rng = np.random.default_rng(0)
    base = rng.normal(size=(12, 64)) * 3.0
    P = (base[rng.integers(0, 12, 3000)]
         + 0.05 * rng.normal(size=(3000, 64))).astype(np.float32)
    cats = rng.integers(0, 4, (3000, 1)).astype(np.int32)
    caps = np.full(4, 3, np.int32)
    spec = MatroidSpec("partition", num_categories=4, gamma=1)
    out = {}
    for dev in ("cuda", "cpu"):
        svc = DiversityService(spec, 6, tau=16, caps=caps, device=dev)
        svc.frontend.register_tenant("cos", metric="cosine")
        ops.reset_launches()
        for off in range(0, 1500, 500):
            svc.ingest(P[off:off + 500], cats[off:off + 500])
        for off in range(1500, 3000, 500):
            svc.runtime.submit(P[off:off + 500], cats[off:off + 500])
            # one publish a batch on either device: without the barrier
            # the worker's publish-on-drain depends on how fast it drains
            svc.runtime.flush()
        epoch = svc.runtime.flush()
        qs = [DiversityQuery(k=kk) for kk in (3, 6)]
        res = {t: svc.frontend.query_batch(qs, tenant=t, engine="host",
                                           min_epoch=epoch)
               for t in ("default", "cos")}
        launches = ops.launch_counts()
        svc.frontend.query_batch(qs, tenant="cos", engine="host")
        warm = ops.launch_counts()
        entry = svc.cache.lookup(svc.frontend.tenants.get("cos").key,
                                 svc.runtime.fingerprint)
        out[dev] = (svc, epoch, res, launches, warm, entry)
        svc.close()
    svc, epoch, res, launches, warm, entry = out["cuda"]
    csvc, cepoch, cres, _, _, _ = out["cpu"]
    assert launches["center_precheck"] >= 3000 // 128
    assert launches["pairwise_sqdist"] == svc.cache.stats.builds == 2
    assert warm == launches  # the warm entry launched nothing
    assert entry.D.is_cuda
    assert epoch == cepoch
    assert svc.runtime.fingerprint == csvc.runtime.fingerprint
    assert np.array_equal(svc.snapshot()[2], csvc.snapshot()[2])
    for t in res:
        for a, b in zip(res[t], cres[t]):
            assert a.indices.tolist() == b.indices.tolist(), t


@pytest.mark.parametrize("writer", ["cpu", "cuda"])
def test_durable_directory_restores_across_devices(cuda, tmp_path, writer):
    """A checkpoint names no device: a directory written on one device
    (a checkpoint, then a WAL tail) restores on the other to the same
    stream and epoch fingerprint as its own device's restore, with the
    state on the ``device=`` given, K3 launched for every replayed block
    on the card, and the same host-engine selections."""
    from repro_torch.serve.diversity import (
        DiversityQuery,
        DiversityService,
        DurabilityConfig,
    )

    rng = np.random.default_rng(3)
    base = rng.normal(size=(12, 64)) * 3.0
    P = (base[rng.integers(0, 12, 3000)]
         + 0.05 * rng.normal(size=(3000, 64))).astype(np.float32)
    cats = rng.integers(0, 4, (3000, 1)).astype(np.int32)
    caps = np.full(4, 3, np.int32)
    spec = MatroidSpec("partition", num_categories=4, gamma=1)
    d = tmp_path / "written"
    dur = DurabilityConfig(dir=str(d), checkpoint_every=10 ** 9)
    svc = DiversityService(spec, 6, tau=16, caps=caps, durability=dur,
                           device=writer)
    for off in range(0, 1500, 500):
        svc.ingest(P[off:off + 500], cats[off:off + 500])
    assert svc.runtime.checkpoint(force=True) is not None
    for off in range(1500, 3000, 500):
        svc.runtime.submit(P[off:off + 500], cats[off:off + 500])
    svc.runtime.flush()
    live = svc.runtime.latest()
    # "kill": no close, the tail stays in the WAL
    qs = [DiversityQuery(k=kk) for kk in (3, 6)]
    out = {}
    for dev in ("cuda", "cpu"):
        copy = tmp_path / dev  # each restore's parting save stays its own
        shutil.copytree(d, copy)
        ops.reset_launches()
        back = DiversityService.restore(str(copy), device=dev)
        launches = ops.launch_counts()
        rep = back.runtime.restore_report
        assert rep["replayed_batches"] == 3
        assert back.runtime.state.dp.device.type == dev
        out[dev] = (back.runtime.latest(), back.query_batch(qs,
                                                            engine="host"))
        if dev == "cuda":
            assert launches["center_precheck"] >= 3 * -(-500 // 128)
        back.close()
    for dev, (snap, _res) in out.items():
        assert snap.fingerprint == live.fingerprint, dev
        assert np.array_equal(snap.src_idx, live.src_idx), dev
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert a.indices.tolist() == b.indices.tolist()


def _mr_instance(seed=0, n=1600, d=8):
    """tests/test_distributed.py's MapReduce instance."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, 2)) @ rng.normal(size=(2, d))
    P = (base + 0.05 * rng.normal(size=(n, d))).astype(np.float32)
    cats = rng.integers(0, 4, (n, 1)).astype(np.int32)
    return P, cats, np.full(4, 2, np.int32)


@pytest.mark.parametrize("round2", [None, 16])
def test_mapreduce_on_the_card_equals_the_cpu(cuda, round2):
    """``solve_dmmc(setting="mapreduce")`` on 8 in-process positions of one
    card: K2 once a shard a center, K1 for the final stage, and the CPU
    mesh's union, selection and overflow."""
    from repro_torch.core import solve_dmmc
    from repro_torch.launch import make_mesh

    P, cats, caps = _mr_instance()
    spec = MatroidSpec("partition", num_categories=4, gamma=1)
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = make_mesh((8,), ("data",), devices=[dev] * 8)
        ops.reset_launches()
        out[dev] = solve_dmmc(P, 4, spec, cats=cats, caps=caps, tau=64,
                              setting="mapreduce", mesh=mesh,
                              round2_tau=round2, device=dev)
        if dev == "cuda":
            launches = ops.launch_counts()
    got, want = out["cuda"], out["cpu"]
    assert launches["gmm_update"] == 8 * 8 + (0 if round2 is None else 16)
    assert launches["pairwise_sqdist"] >= 1
    assert np.array_equal(got.coreset_indices, want.coreset_indices)
    assert np.array_equal(got.indices, want.indices)
    assert got.info == want.info and got.info["overflow"] == 0


def test_global_gmm_on_the_card_matches_gmm_fixed(cuda):
    """``distributed_coreset`` on 8 positions of one card picks the centers
    of ``gmm_fixed`` on the whole array and launches K2 8 x tau times;
    the traversal reads nothing back to the host."""
    import warnings

    from repro_torch.core import distributed_coreset, gmm_fixed
    from repro_torch.core.distributed_gmm import _global_gmm_shard
    from repro_torch.launch import make_mesh

    P, cats, caps = _mr_instance(3)
    n, tau = P.shape[0], 16
    spec = MatroidSpec("partition", num_categories=4, gamma=1)
    x = torch.as_tensor(P, device="cuda")
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    mesh = make_mesh((8,), ("data",), devices=["cuda"] * 8)
    ops.reset_launches()
    cs, radius, delta = distributed_coreset(
        mesh, x, cats, valid, spec, caps, 4, tau)
    launches = ops.launch_counts()
    ref = gmm_fixed(x, valid, tau)
    assert launches["gmm_update"] == 8 * tau
    assert abs(float(radius) - float(ref.radius)) <= 1e-5 * float(ref.radius)
    assert abs(float(delta) - float(ref.delta)) <= 1e-5 * float(ref.delta)
    assert int(cs.valid.sum()) > 0
    shards, valids = list(torch.chunk(x, 8)), list(torch.chunk(valid, 8))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            centers = _global_gmm_shard(mesh, shards, valids, tau,
                                        ("data",))[3]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert centers.tolist() == ref.centers.tolist()
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message)]
    assert not syncs, syncs[:3]


def test_shard_map_runtime_on_the_card_equals_vmap(cuda):
    """``placement="shard_map"`` on one card is one group: the ``vmap``
    runtime's stacked state, bit for bit; against the CPU the fingerprint
    and the integer fields (the float fields sum in other orders)."""
    from repro_torch.serve.diversity import StreamRuntime

    P, cats, caps = _mr_instance(1, n=2000, d=32)
    spec = MatroidSpec("partition", num_categories=4, gamma=1)
    states = {}
    for pl, dev in (("vmap", "cuda"), ("shard_map", "cuda"),
                    ("shard_map", "cpu")):
        rt = StreamRuntime(spec, 4, tau=8, caps=caps, num_shards=4,
                           placement=pl, block_size=64, device=dev)
        for off in range(0, 2000, 500):
            rt.ingest(P[off:off + 500], cats[off:off + 500])
        states[pl, dev] = (rt.state, rt.fingerprint)
        rt.close()
    a, fa = states["vmap", "cuda"]
    for key in (("shard_map", "cuda"), ("shard_map", "cpu")):
        b, fb = states[key]
        assert fa == fb, key
        for x, y in zip(a, b):
            if key[1] == "cuda" or not x.is_floating_point():
                assert torch.equal(x.cpu(), y.cpu()), key


def test_seq_coreset_transversal_on_the_card_equals_the_cpu(cuda):
    from repro_torch.core import seq_coreset

    rng = np.random.default_rng(5)
    P, _, _ = _mr_instance(5)
    n = P.shape[0]
    cats = rng.integers(0, 4, (n, 2)).astype(np.int32)
    cats[rng.random(n) < 0.5, 1] = -1
    spec = MatroidSpec("transversal", num_categories=4, gamma=2)
    got = seq_coreset(P, cats, np.ones(n, bool), spec, None, 4, 12,
                      device="cuda")[0]
    want = seq_coreset(P, cats, np.ones(n, bool), spec, None, 4, 12,
                       device="cpu")[0]
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y), x.dtype


def _moe_inputs(E, seed):
    from repro_torch.models.moe import moe_init
    from repro_torch.models.model import _draw

    gen = torch.Generator().manual_seed(seed)
    p = {k: _draw(spec, gen, torch.device("cpu"))
         for k, spec in moe_init(48, 80, E, torch.float32).items()}
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (3, 64, 48), dtype=np.float32))
    return x, p


@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (2, 0.5), (2, 1.25)])
def test_moe_apply_on_the_card_equals_the_cpu(cuda, top_k, cf):
    """The MoE FFN (plain torch: dispatch, expert products, combine) on
    the card against the CPU, f32: the same routes, slots and drops (some
    tokens dropped), y and aux within 1e-5 of their scale; each gradient
    within 1e-4 relative L2 of the f64 gradient (the CPU in float64), or
    no farther from it than twice the CPU's own f32 gradient (with top-1
    routing the gate is p / p, whose derivative cancels to rounding noise
    in the router's gradient); bit-identical on a repeat."""
    from repro_torch.models.moe import moe_apply, moe_route

    x, p = _moe_inputs(8, 11)
    r = moe_route(x, p["router"], top_k=top_k, capacity_factor=cf)
    rc = moe_route(x.to(cuda), p["router"].to(cuda), top_k=top_k,
                   capacity_factor=cf)
    assert torch.equal(rc.eidx.cpu(), r.eidx)
    assert torch.equal(rc.keep.cpu(), r.keep) and not bool(r.keep.all())
    runs = []
    for dev, dtype in (("cpu", torch.float64), ("cpu", torch.float32),
                       (cuda, torch.float32), (cuda, torch.float32)):
        xd = x.to(dev, dtype).requires_grad_(True)
        pd = {k: v.to(dev, dtype).requires_grad_(True) for k, v in p.items()}
        y, aux = moe_apply(xd, pd, top_k=top_k, capacity_factor=cf)
        keys = sorted(pd)
        grads = torch.autograd.grad(y.square().sum() + aux,
                                    [xd] + [pd[k] for k in keys])
        runs.append([t.detach().cpu().double() for t in (y, aux, *grads)])
    truth, want, got, again = runs
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    scale = float(want[0].abs().max())
    torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                               atol=1e-5 * scale)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)

    def rel(a, b):
        return float((a - b).norm() / (b.norm() + 1e-30))

    for a, b, t in zip(got[2:], want[2:], truth[2:]):
        assert rel(a, t) <= max(1e-4, 2 * rel(b, t)), (rel(a, t), rel(b, t))


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "llama-3.2-vision-90b"])
def test_moe_pair_and_vlm_engine_on_the_card_equal_the_cpu(cuda, arch):
    """A reduced ``moe_pair`` model (top-1 of 4 experts) and a reduced
    ``vlm_super`` model (cross attention over 8 image tokens) through
    ``Engine.generate`` on the card, K4 launched once an attention layer of
    the prefill: the CPU engine's tokens, the logits within 1e-4 of their
    largest; the image cache stays at ``n_img_tokens``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.models.model import tree_map
    from repro_torch.serve.engine import Engine

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    lm = LM(cfg)
    params = lm.init(0, device="cpu")
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 24)))
    img = None
    if cfg.family == "vlm":
        img = torch.as_tensor(0.1 * rng.standard_normal(
            (2, cfg.n_img_tokens, cfg.d_model), dtype=np.float32))
    want, wl = Engine(lm, params, 32, device="cpu").generate(
        toks, 6, img, return_logits=True)
    params_c = tree_map(lambda t: t.to(cuda), params)
    ops.reset_launches()
    got, gl = Engine(lm, params_c, 32, device=cuda).generate(
        toks.to(cuda), 6, None if img is None else img.to(cuda),
        return_logits=True)
    attn = sum(count * {"moe_pair": 2, "vlm_super": cfg.cross_attn_every
                        }[kind] for kind, count in lm.plan)
    assert ops.launch_counts()["flash_attention_fwd"] == attn
    assert torch.equal(got.cpu(), want)
    scale = float(wl.abs().max())
    torch.testing.assert_close(gl.cpu(), wl, rtol=1e-4, atol=1e-4 * scale)
    _, caches = lm.prefill(params_c, toks.to(cuda),
                           None if img is None else img.to(cuda),
                           cache_len=32)
    if cfg.family == "vlm":
        for t in caches[0]["cross"]:
            assert t.shape[2] == cfg.n_img_tokens


def _sharded_setup(arch, cuda):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.train import AdamWConfig

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10,
                    master_dtype="float32")
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (8, 32)), device=cuda)
    return lm, c, {"tokens": toks}


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / (b.norm() + 1e-30))


# relative L2 a leaf between a bf16 tensor-parallel step and the unsharded
# one (see the test below), about twice the worst reading on an H100: a
# parameter's change (embed's, 0.127: AdamW's first update is +-lr a
# coordinate, and a near-zero gradient's sign flips with the order of the
# bf16 sums) and a moment (v of embed, 0.0167)
BF16_TP_CHANGE_TOL = 0.25
BF16_TP_MOMENT_TOL = 5e-2


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b"])
def test_sharded_step_on_two_positions_equals_unsharded(cuda, arch):
    """FSDP on an in-process mesh of 2 positions on the card, f32, two
    steps (K4 and K5; K6 and K6b for zamba2): the unsharded step's losses
    within 1e-6 and every leaf within 1e-4 relative L2 (the sums' order:
    the card's GEMMs also pick their reduction by shape, a half batch's or
    the whole's; 1.03e-5 measured on zamba2's shared ``wo`` moment, 3.5e-6
    on the CPU, tests/test_torch_train_sharded.py); a 1-position mesh bit
    for bit."""
    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.checkpoint import _paths

    lm, c, batch = _sharded_setup(arch, cuda)
    plain = init_train_state(lm, 0, c, device=cuda)
    step = make_train_step(lm, c)
    want = []
    for _ in range(2):
        plain, m = step(plain, batch)
        want.append(float(m["loss"]))
    for n in (1, 2):
        mesh = make_mesh((n,), ("data",), devices=[cuda] * n)
        state = init_train_state(lm, 0, c, mesh=mesh)
        step = make_train_step(lm, c, mesh=mesh)
        ops.reset_launches()
        got = []
        for _ in range(2):
            state, m = step(state, batch)
            got.append(float(m["loss"]))
        assert ops.launch_counts()["flash_attention_bwd"] > 0
        full = sh.gather_tree(state)
        for (k, a), (_, b) in zip(_paths(full), _paths(plain)):
            if n == 1:
                assert torch.equal(a, b), k
            else:
                assert _rel(a, b) <= 1e-4, (k, _rel(a, b))
        if n == 1:
            assert got == want
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_sharded_restore_from_two_positions_onto_one(cuda, tmp_path):
    """Two steps on 2 positions of the card, a checkpoint, restored onto
    1 position for a third: within 1e-6 (loss) and 1e-4 (leaves, as
    above) of three unsharded steps."""
    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.train import (
        CheckpointManager, abstract_train_state, init_train_state,
        make_train_step,
    )
    from repro_torch.train.checkpoint import _paths
    from repro_torch.train.train_state import state_specs

    lm, c, batch = _sharded_setup("smollm-135m", cuda)
    specs = state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                       tp=None), c)
    plain = init_train_state(lm, 0, c, device=cuda)
    step = make_train_step(lm, c)
    for _ in range(3):
        plain, pm = step(plain, batch)
    m2 = make_mesh((2,), ("data",), devices=[cuda] * 2)
    state = init_train_state(lm, 0, c, mesh=m2, specs=specs)
    step = make_train_step(lm, c, mesh=m2)
    for _ in range(2):
        state, _m = step(state, batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    mgr.wait()
    m1 = make_mesh((1,), ("data",), devices=[cuda])
    state = mgr.restore(2, abstract_train_state(lm, c), mesh=m1,
                        specs=specs)
    assert state.devices[0] == cuda
    state, m = make_train_step(lm, c, mesh=m1)(state, batch)
    np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]),
                               rtol=1e-6)
    for (k, a), (_, b) in zip(_paths(sh.gather_tree(state)), _paths(plain)):
        assert _rel(a, b) <= 1e-4, (k, _rel(a, b))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tp_step_on_card_positions_equals_unsharded(cuda, dtype):
    """Tensor parallel on an in-process (2, 2) ("data", "model") mesh of
    card positions, one step of reduced smollm-135m (2 query heads and 1
    kv head a position through K4 and K5): K4 and K5 launch 4 x as often
    as on the unsharded kernel step, each on a quarter of its B x heads
    rows; the collective bytes are the dry run's; the loss and every leaf
    agree with the unsharded step: in f32 as the FSDP test above (1e-6,
    1e-4). In bf16 the loss within 1e-3 (the row slices' f32 products
    summed, one rounding, as the whole product); a parameter's step's
    change (new minus initial, in f64; one AdamW update is ~1e-3 of a
    weight's norm, so a limit on the new weights would pass a missing
    update) within ``BF16_TP_CHANGE_TOL`` and a moment within
    ``BF16_TP_MOMENT_TOL`` relative L2 a leaf (the backward's bf16 sums
    differ in order and grouping). The worst leaf of each is printed."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, make_mesh
    from repro_torch.launch.mesh import (collective_bytes,
                                         reset_collective_bytes)
    from repro_torch.models import LM
    from repro_torch.models import sharding as sh
    from repro_torch.train import (AdamWConfig, StepConfig,
                                   init_train_state, make_train_step)
    from repro_torch.train.checkpoint import _paths
    from repro_torch.train.train_state import state_specs

    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              dtype=dtype)
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (8, 64)), device=cuda)
    init = dict(_paths(init_train_state(lm, 0, c, device=cuda)["params"],
                       "params/"))
    ops.reset_launches()
    plain, pm = make_train_step(lm, c)(init_train_state(lm, 0, c,
                                                        device=cuda),
                                       {"tokens": toks})
    want = ops.launch_counts()
    mesh = make_mesh((2, 2), ("data", "model"), devices=[cuda] * 4)
    specs = state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                       tp="model"), c)
    state = init_train_state(lm, 0, c, mesh=mesh, specs=specs)
    rows = {"fwd": set(), "bwd": set()}
    fwd, bwd = ops.flash_attention_fwd, ops.flash_attention_bwd

    def spy(fn, key):
        def call(q, *a, **kw):
            rows[key].add(q.shape[0])
            return fn(q, *a, **kw)
        return call

    ops.reset_launches()
    reset_collective_bytes()
    ops.flash_attention_fwd = spy(fwd, "fwd")
    ops.flash_attention_bwd = spy(bwd, "bwd")
    try:
        state, m = make_train_step(lm, c, mesh=mesh)(state, {"tokens": toks})
    finally:
        ops.flash_attention_fwd, ops.flash_attention_bwd = fwd, bwd
    got = ops.launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert got[name] == 4 * want[name] > 0, (name, got, want)
    assert rows == {"fwd": {8 // 2 * cfg.n_heads // 2},
                    "bwd": {8 // 2 * cfg.n_heads // 2}}
    dry = dict(dryrun.fsdp_collectives(lm, StepConfig(), 2, 8, tp=2))
    dry.update(dryrun.tp_collectives(lm, StepConfig(), 2, 2, (8, 64)))
    assert collective_bytes() == dry
    f32 = dtype == "float32"
    np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]),
                               rtol=1e-6 if f32 else 1e-3)
    errs, tols = {}, {}
    for (k, a), (_, b) in zip(_paths(sh.gather_tree(state)), _paths(plain)):
        tols[k] = 1e-4 if f32 else BF16_TP_MOMENT_TOL
        if not f32 and k in init:
            a, b = a.double() - init[k].double(), b.double() - init[k].double()
            tols[k] = BF16_TP_CHANGE_TOL
        errs[k] = _rel(a, b)
    for part in ("params", "opt"):
        worst = max((k for k in errs if k.startswith(part)), key=errs.get)
        print(f"tp step {dtype}: worst {part} leaf {worst} "
              f"{errs[worst]:.6g}")
    for k, e in errs.items():
        assert e <= tols[k], (k, e, tols[k])


@pytest.mark.parametrize("arch,shape,over", [
    ("llama-3.2-vision-90b", (1, 2), {}),  # the vlm, whole kv heads
    ("llama-3.2-vision-90b", (1, 4), {}),  # a kv head on two positions
    ("smollm-135m", (1, 4), {"n_heads": 6, "n_kv": 2}),  # divides neither
    ("smollm-135m", (1, 8), {}),  # four positions hold no head
])
def test_tp_step_heads_on_card_positions_equals_unsharded(cuda, arch, shape,
                                                          over):
    """Tensor parallel for the vlm and with the heads resharded (ROADMAP.md
    steps 13.10 and 13.11) on an in-process mesh of card positions, one
    f32 step of the reduced config: K4 and K5 launch on each position that
    holds a head, each call on B x its heads' rows (the vlm's cross
    attention not causal), as often as on the unsharded step per
    position; the collective bytes are the dry run's; the unsharded step's
    loss within 1e-6 and every leaf within 1e-4 relative L2, as the FSDP
    test above."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, make_mesh
    from repro_torch.launch.mesh import (collective_bytes,
                                         reset_collective_bytes)
    from repro_torch.models import LM
    from repro_torch.models import sharding as sh
    from repro_torch.models.model import head_range
    from repro_torch.train import (AdamWConfig, StepConfig,
                                   init_train_state, make_train_step)
    from repro_torch.train.checkpoint import _paths
    from repro_torch.train.train_state import state_specs

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **over)
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(5)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (8, 64)),
                                       device=cuda)}
    if cfg.family == "vlm":
        batch["img"] = torch.as_tensor(
            rng.standard_normal((8, cfg.n_img_tokens, cfg.d_model)) * 0.1,
            dtype=torch.float32, device=cuda)
    ops.reset_launches()
    plain, pm = make_train_step(lm, c)(init_train_state(lm, 0, c,
                                                        device=cuda), batch)
    want = ops.launch_counts()
    n = math.prod(shape)
    mesh = make_mesh(shape, ("data", "model"), devices=[cuda] * n)
    specs = state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                       tp="model"), c)
    state = init_train_state(lm, 0, c, mesh=mesh, specs=specs)
    rows = {"fwd": set(), "bwd": set()}
    fwd, bwd = ops.flash_attention_fwd, ops.flash_attention_bwd

    def spy(fn, key):
        def call(q, *a, **kw):
            rows[key].add(q.shape[0])
            return fn(q, *a, **kw)
        return call

    ops.reset_launches()
    reset_collective_bytes()
    ops.flash_attention_fwd = spy(fwd, "fwd")
    ops.flash_attention_bwd = spy(bwd, "bwd")
    try:
        state, m = make_train_step(lm, c, mesh=mesh)(state, batch)
    finally:
        ops.flash_attention_fwd, ops.flash_attention_bwd = fwd, bwd
    got = ops.launch_counts()
    heads = [hi - lo for lo, hi in (head_range(cfg.n_heads, shape[1], j)
                                    for j in range(shape[1]))]
    with_heads = sum(1 for h in heads if h)
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert got[name] == with_heads * want[name] > 0, (name, got, want)
    assert rows["fwd"] == rows["bwd"] == {8 * h for h in heads if h}
    dry = dict(dryrun.fsdp_collectives(lm, StepConfig(), shape[0], 8,
                                       tp=shape[1]))
    dry.update(dryrun.tp_collectives(lm, StepConfig(), shape[0], shape[1],
                                     (8, 64)))
    assert collective_bytes() == dry
    np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]),
                               rtol=1e-6)
    for (k, a), (_, b) in zip(_paths(sh.gather_tree(state)), _paths(plain)):
        assert _rel(a, b) <= 1e-4, (k, _rel(a, b))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_tp_step_ssm_on_card_positions_equals_plain(cuda, arch):
    """The ssm and hybrid families tensor parallel on an in-process (1, 2)
    mesh of card positions, one f32 step of the reduced config: K6 twice
    and K6b once a Mamba2 layer a position, every call on a position's 4
    of the 8 heads; the same step on the plain versions (``force="ref"``)
    launches nothing, and the kernel step's loss is within 1e-5 relative
    and every leaf within 1e-4 relative L2 of it (K6 and K6b multiply in
    3xTF32), as the FSDP test above."""
    from repro_torch.launch import make_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.mamba import mamba_dims
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.checkpoint import _paths
    from repro_torch.train.train_state import state_specs

    lm, c, batch = _sharded_setup(arch, cuda)
    cfg = lm.cfg
    mesh = make_mesh((1, 2), ("data", "model"), devices=[cuda] * 2)
    specs = state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                       tp="model"), c)
    heads = set()
    fwd, bwd = ops.ssd_intra_chunk, ops.ssd_intra_chunk_bwd

    def spy(fn):
        def call(xbar, *a, **kw):
            heads.add(xbar.shape[1])
            return fn(xbar, *a, **kw)
        return call

    res = {}
    ops.ssd_intra_chunk, ops.ssd_intra_chunk_bwd = spy(fwd), spy(bwd)
    try:
        for force in (None, "ref"):
            state = init_train_state(lm, 0, c, mesh=mesh, specs=specs)
            ops.reset_launches()
            state, m = make_train_step(lm, c, mesh=mesh, force=force)(
                state, batch)
            res[force] = (float(m["loss"]), ops.launch_counts(),
                          _paths(sh.gather_tree(state)))
    finally:
        ops.ssd_intra_chunk, ops.ssd_intra_chunk_bwd = fwd, bwd
    layers = sum(n * (cfg.shared_attn_every if kind == "zamba_super" else 1)
                 for kind, n in lm.plan if kind in ("mamba", "zamba_super"))
    (loss, n, got), (loss_r, n_r, want) = res[None], res["ref"]
    assert n["ssd_intra_chunk"] == 2 * layers * 2, n
    assert n["ssd_intra_chunk_bwd"] == layers * 2, n
    assert heads == {mamba_dims(cfg)[1] // 2}
    assert not any(n_r.values()), n_r
    np.testing.assert_allclose(loss, loss_r, rtol=1e-5)
    for (k, a), (_, b) in zip(got, want):
        assert _rel(a, b) <= 1e-4, (k, _rel(a, b))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_mesh_steps_on_card_positions_equal_unsharded(cuda, arch):
    """The moe family on in-process meshes of card positions, f32, two
    steps: FSDP on (2,) (a routing pass, the expert counts summed, the
    gradient passes replaying its routes) and (2, 2) (the experts split
    over "model"): K4 3 x and K5 once a layer a position a step (the
    routing pass, the forward and its recompute; the backward); the
    collective bytes are the dry run's; the unsharded step's losses within
    1e-6 and every leaf within 1e-4 relative L2, as the FSDP test above
    (the reduced configs route with margins ~5e-5 on this data, above the
    f32 sums' differences)."""
    from repro_torch.launch import dryrun, make_mesh
    from repro_torch.launch.mesh import (collective_bytes,
                                         reset_collective_bytes)
    from repro_torch.models import sharding as sh
    from repro_torch.train import StepConfig, init_train_state, \
        make_train_step
    from repro_torch.train.checkpoint import _paths
    from repro_torch.train.train_state import state_specs

    lm, c, batch = _sharded_setup(arch, cuda)
    plain = init_train_state(lm, 0, c, device=cuda)
    step = make_train_step(lm, c)
    want = []
    for _ in range(2):
        plain, m = step(plain, batch)
        want.append(float(m["loss"]))
    attn = sum(n * (2 if kind == "moe_pair" else 1) for kind, n in lm.plan)
    for shape in ((2,), (2, 2)):
        tp = shape[1] if len(shape) == 2 else 1
        mesh = make_mesh(shape, ("data", "model")[:len(shape)],
                         devices=[cuda] * (2 * tp))
        specs = state_specs(sh.param_specs(
            lm.abstract_params(), ("data",),
            tp="model" if tp > 1 else None), c)
        state = init_train_state(lm, 0, c, mesh=mesh, specs=specs)
        step = make_train_step(lm, c, mesh=mesh)
        ops.reset_launches()
        got = []
        for i in range(2):
            reset_collective_bytes()
            state, m = step(state, batch)
            got.append(float(m["loss"]))
            if i == 0:
                moved = collective_bytes()
        n = ops.launch_counts()
        assert n["flash_attention_fwd"] == 2 * 3 * attn * 2 * tp, n
        assert n["flash_attention_bwd"] == 2 * attn * 2 * tp, n
        dry = dict(dryrun.fsdp_collectives(lm, StepConfig(), 2, 8, tp=tp))
        dry.update(dryrun.tp_collectives(lm, StepConfig(), 2, tp, (8, 32)))
        assert moved == dry
        np.testing.assert_allclose(got, want, rtol=1e-6)
        for (k, a), (_, b) in zip(_paths(sh.gather_tree(state)),
                                  _paths(plain)):
            assert _rel(a, b) <= 1e-4, (shape, k, _rel(a, b))


# --------------------------------------------------------------------------
# the dry run (launch/dryrun.py) held to the card
# --------------------------------------------------------------------------


def _dryrun_cell(batch, seq):
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.train import AdamWConfig
    from repro_torch.train.train_state import StepConfig

    opt = AdamWConfig()
    cell = dryrun.count_cell(
        get_config("smollm-135m"), ShapeConfig("t", "train", seq, batch),
        dryrun.meta_mesh((1, 1), ("data", "model")), opt_cfg=opt,
        step_cfg=StepConfig())
    return cell, opt


def test_dryrun_argument_bytes_equal_the_allocated_state(cuda):
    """smollm-135m's state and a 4 x 1,024 batch: what the dry run counts
    on meta tensors against what the card allocates, within 1% (the
    caching allocator leaves a large tensor the rest of its block: 0.36%
    at chip_smoke.py's 16 x 2,048)."""
    from repro_torch.train import init_train_state

    cell, opt = _dryrun_cell(4, 1024)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(cuda)
    state = init_train_state(cell["lm"], 0, opt, device=cuda)
    tokens = torch.zeros((4, 1024), dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    got = torch.cuda.memory_allocated(cuda) - before
    want = cell["memory"]["argument_bytes"]
    assert abs(got - want) <= 1e-2 * want, (got, want)
    del state, tokens


def test_dryrun_peak_matches_the_plain_step_on_the_card(cuda):
    """The traced plain-path step's predicted peak against the same step's
    measured peak on the card (smollm-135m, 4 x 1,024): within the band
    chip_smoke.py holds (0.90-1.05)."""
    from repro_torch.train import init_train_state, make_train_step

    cell, opt = _dryrun_cell(4, 1024)
    mem = cell["memory"]
    predicted = (mem["argument_bytes"] + mem["output_bytes"]
                 + mem["temp_bytes"] - mem["alias_bytes"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(cuda)
    state = init_train_state(cell["lm"], 0, opt, device=cuda)
    tokens = torch.zeros((4, 1024), dtype=torch.int32, device=cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    step = make_train_step(cell["lm"], opt, force="ref")
    state, _m = step(state, {"tokens": tokens})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - before
    assert 0.90 <= predicted / peak <= 1.05, (predicted, peak)
    del state, tokens


@pytest.mark.parametrize("arch,shape,over", [
    ("zamba2-7b", (2, 2), {}),  # Mamba2 heads and the shared block's
    ("smollm-135m", (1, 4), {"n_heads": 6, "n_kv": 2}),  # kv regrouped
    ("phi3.5-moe-42b-a6.6b", (2, 2), {}),  # experts over "model"
    ("llama-3.2-vision-90b", (1, 4), {}),  # the image cache's kv heads
])
def test_serve_tp_on_card_positions_equals_unsharded(cuda, arch, shape,
                                                     over):
    """Serving on a ("data", "model") mesh of card positions (ROADMAP.md
    step 13.12), f32 reduced config, 4 x 64 prompts and 4 new tokens:
    ``Engine(mesh=)`` gives the unsharded engine's tokens, every step's
    logits within 1e-5 of its largest; K4 once an attention layer and K6
    once a Mamba2 layer, per position that holds heads and data row; the
    collective bytes are the dry run's ``serve_collectives``."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, make_mesh
    from repro_torch.launch.mesh import (collective_bytes,
                                         reset_collective_bytes)
    from repro_torch.models import LM
    from repro_torch.models.model import head_range
    from repro_torch.serve.engine import Engine

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **over)
    lm = LM(cfg)
    params = lm.init(0, device=cuda)
    rng = np.random.default_rng(3)
    B, P, steps = 4, 64, 4
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)), device=cuda)
    img = (torch.as_tensor(rng.standard_normal(
        (B, cfg.n_img_tokens, cfg.d_model)) * 0.1, dtype=torch.float32,
        device=cuda) if cfg.family == "vlm" else None)
    ops.reset_launches()
    tok0, lg0 = Engine(lm, params, P + steps, device=cuda).generate(
        tokens, steps, img, return_logits=True)
    want = ops.launch_counts()
    n_dp, tp = shape
    mesh = make_mesh(shape, ("data", "model"),
                     devices=[cuda] * math.prod(shape))
    eng = Engine(lm, params, P + steps, mesh=mesh, device=cuda)
    ops.reset_launches()
    reset_collective_bytes()
    tok1, lg1 = eng.generate(tokens, steps, img, return_logits=True)
    got, moved = ops.launch_counts(), collective_bytes()
    torch.cuda.synchronize()
    assert torch.equal(tok1, tok0)
    scale = float(lg0.abs().max())
    assert float((lg1 - lg0).abs().max()) <= 1e-5 * scale
    with_heads = sum(1 for j in range(tp)
                     if head_range(cfg.n_heads, tp, j)[1]
                     > head_range(cfg.n_heads, tp, j)[0])
    assert got["flash_attention_fwd"] == \
        n_dp * with_heads * want["flash_attention_fwd"]
    assert got["ssd_intra_chunk"] == n_dp * tp * want["ssd_intra_chunk"]
    rows = B // n_dp
    dry = dict(dryrun.serve_collectives(lm, tp, rows, P, "prefill"))
    for k, v in dryrun.serve_collectives(lm, tp, rows, P, "decode").items():
        dry[k] = dry.get(k, 0) + (steps - 1) * v
    assert moved == dry


@pytest.mark.parametrize("arch,shape,over,mode", [
    ("smollm-135m", (1, 4), {"n_heads": 9, "n_kv": 3}, "auto"),  # "hd"
    ("smollm-135m", (1, 4), {"n_heads": 9, "n_kv": 3}, "seq"),
    ("zamba2-7b", (2, 2), {}, "hd"),  # beside the Mamba2 states
    ("llama-3.2-vision-90b", (1, 4), {}, "seq"),  # the image cache's heads
])
def test_serve_tp_layouts_on_card_positions_equals_unsharded(
        cuda, arch, shape, over, mode):
    """Serving on a ("data", "model") mesh of card positions in the
    reference's "hd" and "seq" kv cache layouts (ROADMAP.md step 13.13),
    f32 reduced config, 4 x 64 prompts and 4 new tokens into caches of
    ``tp x 65`` slots (under "seq" the first decode write is position 0's
    last slot, the second position 1's first): ``Engine(mesh=,
    cache_mode=)`` gives the unsharded engine's tokens, every step's
    logits within 1e-5 of its largest; K4 once an attention layer per
    position that holds heads and data row; the collective bytes are the
    dry run's ``serve_collectives(..., mode)``."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, make_mesh
    from repro_torch.launch.mesh import (collective_bytes,
                                         reset_collective_bytes)
    from repro_torch.models import LM
    from repro_torch.models.model import head_range
    from repro_torch.serve.engine import Engine

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **over)
    lm = LM(cfg)
    params = lm.init(0, device=cuda)
    rng = np.random.default_rng(3)
    B, P, steps = 4, 64, 4
    n_dp, tp = shape
    L = tp * (P + 1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)), device=cuda)
    img = (torch.as_tensor(rng.standard_normal(
        (B, cfg.n_img_tokens, cfg.d_model)) * 0.1, dtype=torch.float32,
        device=cuda) if cfg.family == "vlm" else None)
    ops.reset_launches()
    tok0, lg0 = Engine(lm, params, L, device=cuda).generate(
        tokens, steps, img, return_logits=True)
    want = ops.launch_counts()
    mesh = make_mesh(shape, ("data", "model"),
                     devices=[cuda] * math.prod(shape))
    eng = Engine(lm, params, L, mesh=mesh, device=cuda, cache_mode=mode)
    ops.reset_launches()
    reset_collective_bytes()
    tok1, lg1 = eng.generate(tokens, steps, img, return_logits=True)
    got, moved = ops.launch_counts(), collective_bytes()
    torch.cuda.synchronize()
    assert torch.equal(tok1, tok0)
    scale = float(lg0.abs().max())
    assert float((lg1 - lg0).abs().max()) <= 1e-5 * scale
    with_heads = sum(1 for j in range(tp)
                     if head_range(cfg.n_heads, tp, j)[1]
                     > head_range(cfg.n_heads, tp, j)[0])
    assert got["flash_attention_fwd"] == \
        n_dp * with_heads * want["flash_attention_fwd"]
    assert got["ssd_intra_chunk"] == n_dp * tp * want["ssd_intra_chunk"]
    rows = B // n_dp
    dry = dict(dryrun.serve_collectives(lm, tp, rows, P, "prefill", mode, L))
    for k, v in dryrun.serve_collectives(lm, tp, rows, P, "decode", mode,
                                         L).items():
        dry[k] = dry.get(k, 0) + (steps - 1) * v
    assert moved == dry
    assert moved["all-to-all"] and moved["all-reduce"]
