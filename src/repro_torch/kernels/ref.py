"""Plain PyTorch versions of the hand-written kernels.

Reference: ``repro/kernels/ref.py`` (``pairwise_sqdist``, ``gmm_update``,
the precheck oracles ``_nearest_stats`` :31, ``center_precheck`` :59,
``center_precheck_matmul`` :79, ``ssd_intra_chunk`` :132,
``ssd_reference_scan`` :162 and ``flash_attention_fwd`` :196), the
backward of ``repro/kernels/flash.py`` (``flash_attention_bwd`` :219),
which has no jnp oracle there (its test differentiates the dense
formula), the backward of the SSD intra-chunk step
(``ssd_intra_chunk_bwd``, K6b's plain version), which the reference
leaves to ``jax.grad`` of its jnp form, and the block precheck that the
reference jits around its precheck kernel
(``repro/core/streaming.py:_block_precheck`` :732, up to its count
tables). These are the CPU path of ``ops`` and the oracle that the
CUDA/Triton kernels are held against on the card (``force="ref"``).
"""
from __future__ import annotations

import math

import torch


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(n, d), (m, d) -> (n, m) squared Euclidean distances, f32 accumulate."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    xn = torch.sum(x * x, dim=-1)
    yn = torch.sum(y * y, dim=-1)
    d2 = xn[:, None] + yn[None, :] - 2.0 * (x @ y.T)
    return torch.clamp_min(d2, 0.0)


def gmm_update(
    x: torch.Tensor,  # (n, d)
    z: torch.Tensor,  # (d,)
    min_dist: torch.Tensor,  # (n,) f32
    valid: torch.Tensor,  # (n,) bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (new_min (n,), far_idx int32, far_val f32) as device tensors.

    new_min[i] = min(min_dist[i], d(x_i, z)); far = argmax over valid points
    of new_min, invalid rows counting as -1. ``torch.argmax`` returns the
    first maximum, the same tie rule as ``jnp.argmax``.
    """
    x = x.to(torch.float32)
    z = z.to(torch.float32)
    diff = x - z[None, :]
    d = torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0))
    new_min = torch.minimum(min_dist, d)
    masked = torch.where(valid, new_min, -1.0)
    far = torch.argmax(masked).view(1)
    far_val = masked.index_select(0, far).view(())  # no host read
    return new_min, far.to(torch.int32).view(()), far_val


_F32_MAX = float(torch.finfo(torch.float32).max)


def _nearest_stats(
    d: torch.Tensor,  # (B, T) masked distances
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    """(dmin, z, second, z2, third) row reduction shared by both precheck
    oracles (reference ``repro/kernels/ref.py:_nearest_stats``): the three
    smallest distances and the indices of the two smallest, each the first
    column attaining its minimum (``jnp.argmin``'s tie rule). ``z`` is
    excluded from ``second`` by setting its column to float32 max, so a row
    with a single finite column gets ``second`` = max and ``z2`` = 0."""
    tcap = d.shape[1]
    cols = torch.arange(tcap, dtype=torch.int32, device=d.device)[None, :]
    big = torch.tensor(_F32_MAX, dtype=d.dtype, device=d.device)
    dmin = torch.amin(d, dim=1, keepdim=True)
    z = torch.amin(torch.where(d == dmin, cols, tcap), dim=1, keepdim=True)
    d_noz = torch.where(cols == z, big, d)
    second = torch.amin(d_noz, dim=1, keepdim=True)
    z2 = torch.amin(torch.where(d_noz == second, cols, tcap), dim=1,
                    keepdim=True)
    third = torch.amin(torch.where(cols == z2, big, d_noz), dim=1)
    return (dmin[:, 0], z[:, 0].to(torch.int32), second[:, 0],
            z2[:, 0].to(torch.int32), third)


def _masked(d: torch.Tensor, cvalid: torch.Tensor) -> torch.Tensor:
    return torch.where(cvalid[None, :], d,
                       torch.tensor(_F32_MAX, dtype=d.dtype, device=d.device))


def center_precheck(
    block: torch.Tensor,  # (B, d)
    centers: torch.Tensor,  # (T, d)
    cvalid: torch.Tensor,  # (T,) bool
):
    """Exact oracle (reference ``center_precheck``): the per-point broadcast
    arithmetic of ``core.streaming._dists_to_centers`` for every row, then
    ``_nearest_stats``. Materialises a (B, T, d) tensor; margin 0."""
    diff = centers[None, :, :] - block[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    return _nearest_stats(_masked(torch.sqrt(torch.clamp_min(d2, 0.0)),
                                  cvalid))


def center_precheck_matmul(
    block: torch.Tensor,  # (B, d)
    centers: torch.Tensor,  # (T, d)
    cvalid: torch.Tensor,  # (T,) bool
):
    """Matmul-form precheck (reference ``center_precheck_matmul``), the
    plain version of kernel K3: ||x||^2 + ||c||^2 - 2 x.c in f32, clamped,
    sqrt, invalid centers at float32 max, then ``_nearest_stats``. Subject
    to cancellation error; callers pair it with ``ops._pdist_e2``'s
    margin."""
    block = block.to(torch.float32)
    centers = centers.to(torch.float32)
    xn = torch.sum(block * block, dim=1)
    cn = torch.sum(centers * centers, dim=1)
    d2 = xn[:, None] + cn[None, :] - 2.0 * (block @ centers.T)
    return _nearest_stats(_masked(torch.sqrt(torch.clamp_min(d2, 0.0)),
                                  cvalid))


SLACK = 2.0 ** -16  # relative band around a refined decision boundary


def point_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The per-point distance of the streaming scan: sqrt(max(sum((x -
    y)^2), 0)) over the last axis."""
    return torch.sqrt(torch.clamp_min(torch.sum((x - y) ** 2, dim=-1), 0.0))


def block_precheck(
    block: torch.Tensor,  # (B, d)
    centers: torch.Tensor,  # (T, d)
    cvalid: torch.Tensor,  # (T,) bool
    x1,  # (d,) first stream point (diameter variant), or None (radius)
    thr: float,  # the open threshold
    r2,  # 2 R (diameter variant), or None
    stats,  # ops.center_precheck(block, centers, cvalid) on any path
) -> tuple[torch.Tensor, torch.Tensor]:
    """The device half of the streaming scan's block precheck (reference
    ``repro/core/streaming.py:_block_precheck``), the plain version of K3's
    fused route. Returns (z int32 (B,), flags bool (B,)): each row's
    nearest center and whether the exact per-point step must replay it.

    The two candidates of the precheck are refined with the per-point
    arithmetic; a row replays on an exact candidate tie, a third center
    within twice the precheck's margin, the open threshold (dmin > thr)
    and, for the diameter variant, the R-update trigger (d(x, x1) > r2).
    On the card the refinement's (B, d) reductions and the per-point
    step's (T, d) ones may differ in the last bits, so a row within a
    relative ``SLACK`` of any of those boundaries replays too: a replay
    decides exactly, so this only adds replays."""
    dmin_e, z1, _second, z2, third_e, margin = stats
    z1, z2 = z1.long(), z2.long()
    d1e = torch.where(cvalid[z1], point_dist(centers[z1], block), _F32_MAX)
    d2e = torch.where(cvalid[z2], point_dist(centers[z2], block), _F32_MAX)
    z = torch.where(d2e < d1e, z2, z1)
    dmin = torch.minimum(d1e, d2e)
    flags = ((d1e == d2e) | ((third_e - dmin_e) <= 2.0 * margin)
             | (dmin > thr)
             | ((d1e - d2e).abs() <= SLACK * dmin)
             | ((dmin - thr).abs() <= SLACK * thr))
    if x1 is not None:
        d1 = point_dist(block, x1[None, :])
        flags |= (d1 > r2) | ((d1 - r2).abs() <= SLACK * r2)
    return z.to(torch.int32), flags


NEG_INF = -1e30
_CHUNK_ELEMS = 2**28  # f32 elements of one temporary of the chunked oracles


BF16_P_TILE = 64  # kv rows a step of K4's tensor-core route


def flash_attention_fwd(
    q: torch.Tensor,  # (BH, Sq, hd)
    k: torch.Tensor,  # (BH, Skv, hd)
    v: torch.Tensor,  # (BH, Skv, hd)
    causal: bool = True,
    bf16_p: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense-softmax attention, the plain version of K4. Returns (o in q's
    dtype, lse (BH, Sq) f32).

    Scores are (q . k) / sqrt(hd) in f32; the causal mask is ``qpos >=
    kpos`` from 0 (top-left aligned), masked scores are -1e30. ``lse`` is
    ``repro/models/attention.py:69-70``'s: m + log(max(l, 1e-30)) where l > 0,
    else -1e30. q rows are walked in chunks so that one (BH, rows, Skv) f32
    score block stays near 1 GB; a chunk changes no row's formula.

    ``bf16_p``: round P to bf16 before P V as K4's tensor-core route does
    (the JAX model does too, ``repro/models/attention.py:56-58``): an
    online softmax over 64-key tiles, P = exp(s - m) against the running
    max of its tile, l and the product summed in f32. Off by default: the
    Pallas kernel keeps P in f32.
    """
    bh, sq, hd = q.shape
    skv = k.shape[1]
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    scale = 1.0 / (hd ** 0.5)
    o = torch.empty((bh, sq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    rows = max(1, _CHUNK_ELEMS // max(1, bh * skv))
    kpos = torch.arange(skv, device=q.device)
    for r0 in range(0, sq, rows):
        r1 = min(sq, r0 + rows)
        s = torch.einsum("bqh,bkh->bqk", q[:, r0:r1].to(torch.float32),
                         kf) * scale
        if causal:
            qpos = torch.arange(r0, r1, device=q.device)
            s = torch.where((qpos[:, None] >= kpos[None, :])[None], s,
                            NEG_INF)
        if bf16_p:
            m, l, acc = _online_softmax_bf16_p(s, vf)
        else:
            m = torch.amax(s, dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = torch.sum(p, dim=-1, keepdim=True)
            acc = torch.einsum("bqk,bkh->bqh", p, vf)
            del p
        del s
        o[:, r0:r1] = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
        lse[:, r0:r1] = torch.where(
            l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), NEG_INF)[..., 0]
    return o, lse


def _online_softmax_bf16_p(s, vf):
    """(m, l, P V) of scores s (BH, rows, Skv) over 64-key tiles, P
    rounded to bf16 against each tile's running max (K4's tensor-core
    arithmetic)."""
    bh, rows, skv = s.shape
    m = torch.full((bh, rows, 1), NEG_INF, dtype=torch.float32,
                   device=s.device)
    l = torch.zeros((bh, rows, 1), dtype=torch.float32, device=s.device)
    acc = torch.zeros((bh, rows, vf.shape[-1]), dtype=torch.float32,
                      device=s.device)
    for k0 in range(0, skv, BF16_P_TILE):
        st = s[:, :, k0:k0 + BF16_P_TILE]
        m_new = torch.maximum(m, torch.amax(st, dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * corr + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum(
            "bqk,bkh->bqh", p.to(torch.bfloat16).float(),
            vf[:, k0:k0 + BF16_P_TILE])
        m = m_new
    return m, l, acc


def flash_attention_bwd(
    q: torch.Tensor,  # (BH, Sq, hd)
    k: torch.Tensor,  # (BH, Skv, hd)
    v: torch.Tensor,  # (BH, Skv, hd)
    o: torch.Tensor,  # (BH, Sq, hd)
    lse: torch.Tensor,  # (BH, Sq) f32
    do: torch.Tensor,  # (BH, Sq, hd)
    causal: bool = True,
    bf16_p: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-recompute backward of attention, the plain version of K5.
    Returns (dq, dk, dv) in the inputs' dtypes.

    P is recomputed from (q, k, lse) with the forward's scale and mask
    (masked scores -1e30, so their P is 0); dsum = rowsum(do * o);
    ds = P * (do v^T - dsum) * scale; dq = ds k, dk = ds^T q, dv = P^T do,
    all in f32. q rows are walked in chunks as in ``flash_attention_fwd``,
    so one (BH, rows, Skv) f32 block stays near 1 GB; dk and dv sum the
    chunks in f32.

    ``bf16_p``: round P and dS to bf16 as the operands of dv = P^T do,
    dq = dS k and dk = dS^T q, as K5's tensor-core route does (the sums
    stay f32). Off by default: the Pallas kernels keep P and dS in f32.
    """
    bh, sq, hd = q.shape
    skv = k.shape[1]
    f32 = torch.float32
    kf = k.to(f32)
    vf = v.to(f32)
    scale = 1.0 / (hd ** 0.5)
    dsum = torch.sum(do.to(f32) * o.to(f32), dim=-1)  # (BH, Sq)
    dq = torch.empty((bh, sq, hd), dtype=q.dtype, device=q.device)
    dk = torch.zeros((bh, skv, hd), dtype=f32, device=q.device)
    dv = torch.zeros((bh, skv, hd), dtype=f32, device=q.device)
    rows = max(1, _CHUNK_ELEMS // max(1, bh * skv))
    kpos = torch.arange(skv, device=q.device)
    for r0 in range(0, sq, rows):
        r1 = min(sq, r0 + rows)
        qc = q[:, r0:r1].to(f32)
        doc = do[:, r0:r1].to(f32)
        s = torch.einsum("bqh,bkh->bqk", qc, kf) * scale
        if causal:
            qpos = torch.arange(r0, r1, device=q.device)
            s = torch.where((qpos[:, None] >= kpos[None, :])[None], s,
                            NEG_INF)
        p = torch.exp(s - lse[:, r0:r1, None].to(f32))
        del s
        dp = torch.einsum("bqh,bkh->bqk", doc, vf)
        ds = p * (dp - dsum[:, r0:r1, None]) * scale
        del dp
        if bf16_p:
            p = p.to(torch.bfloat16).to(f32)
            ds = ds.to(torch.bfloat16).to(f32)
        dv += torch.einsum("bqk,bqh->bkh", p, doc)
        del p
        dq[:, r0:r1] = torch.einsum("bqk,bkh->bqh", ds, kf).to(q.dtype)
        dk += torch.einsum("bqk,bqh->bkh", ds, qc)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def ssd_intra_chunk(
    xbar: torch.Tensor,  # (..., q, p)
    loga: torch.Tensor,  # (..., q)
    B: torch.Tensor,  # (..., q, n), broadcast to xbar's leading dims
    C: torch.Tensor,  # (..., q, n)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 intra-chunk step per cell, the plain version of K6. Returns
    (y_intra (..., q, p), state (..., n, p)), both f32 and contiguous.

    cum = cumsum(loga); L[t, s] = exp(cum[t] - cum[s]) for s <= t, else 0;
    y = (C B^T * L) xbar; state = (B * exp(cum[-1] - cum))^T xbar. The
    leading dims are walked in chunks along the first so that one (q, q)
    block per cell stays near 1 GB in all; B and C may be stride-0 views.
    """
    *lead, q, p = xbar.shape
    n = B.shape[-1]
    B = B.expand(*lead, q, n)
    C = C.expand(*lead, q, n)
    f32 = torch.float32
    y = torch.empty((*lead, q, p), dtype=f32, device=xbar.device)
    st = torch.empty((*lead, n, p), dtype=f32, device=xbar.device)
    if not lead:
        return _ssd_cells(xbar, loga, B, C, y, st)
    cells_per_row = math.prod(lead[1:])
    rows = max(1, _CHUNK_ELEMS // max(1, cells_per_row * q * q))
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=xbar.device))
    for r0 in range(0, lead[0], rows):
        r1 = min(lead[0], r0 + rows)
        _ssd_cells(xbar[r0:r1], loga[r0:r1], B[r0:r1], C[r0:r1],
                   y[r0:r1], st[r0:r1], tril)
    return y, st


def _ssd_cells(xbar, loga, B, C, y, st, tril=None):
    f32 = torch.float32
    x = xbar.to(f32)
    Bf = B.to(f32)
    cum = torch.cumsum(loga.to(f32), dim=-1)
    q = x.shape[-2]
    if tril is None:
        tril = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                     device=x.device))
    diff = cum[..., :, None] - cum[..., None, :]
    L = torch.where(tril, torch.exp(diff), 0.0)
    del diff
    G = C.to(f32) @ Bf.transpose(-1, -2)  # (..., q, q)
    y.copy_((G * L) @ x)
    del G, L
    decay_to_end = torch.exp(cum[..., -1:] - cum)  # (..., q)
    st.copy_((Bf * decay_to_end[..., None]).transpose(-1, -2) @ x)
    return y, st


def ssd_intra_chunk_bwd(
    xbar: torch.Tensor,  # (..., q, p)
    loga: torch.Tensor,  # (..., q)
    B: torch.Tensor,  # (..., q, n), broadcast to xbar's leading dims
    C: torch.Tensor,  # (..., q, n)
    dy: torch.Tensor,  # (..., q, p) the gradient of y_intra
    dstate: torch.Tensor,  # (..., n, p) the gradient of state
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The vector-Jacobian product of ``ssd_intra_chunk``'s (y, state),
    the plain version of K6b. Returns (dxbar (..., q, p), dloga (..., q),
    dB, dC), f32; dB and dC have B's and C's shapes, summed over each
    leading axis along which they broadcast (a size-1 or missing axis).

    Per cell, with cum, L, G = C B^T, M = G * L and w = exp(cum[-1] - cum)
    as in the forward: dM = dy xbar^T (masked by L below);
    dxbar = M^T dy + (B * w) dstate; dG = dM * L, dC = dG B,
    dB = dG^T C + w * (xbar dstate^T); with u_s = sum_n (xbar
    dstate^T)[s, n] B[s, n], dcum_t = sum_s (dM * M)[t, s] - sum_t' (dM *
    M)[t', t] - w_t u_t, plus sum_s w_s u_s at t = q - 1; dloga is the
    reverse cumsum of dcum. The leading dims are walked in chunks along
    the first, as the forward does, so that one (q, q) block per cell
    stays near 1 GB; dB and dC are reduced to their shapes per chunk.
    """
    *lead, q, p = xbar.shape
    n = B.shape[-1]
    nd = len(lead) + 2
    b_shape = (1,) * (nd - B.dim()) + tuple(B.shape)
    c_shape = (1,) * (nd - C.dim()) + tuple(C.shape)
    Bx = B.expand(*lead, q, n)
    Cx = C.expand(*lead, q, n)
    f32 = torch.float32
    dev = xbar.device
    dx = torch.empty((*lead, q, p), dtype=f32, device=dev)
    dl = torch.empty((*lead, q), dtype=f32, device=dev)
    if not lead:
        dB, dC = _ssd_cells_bwd(xbar, loga, Bx, Cx, dy, dstate, dx, dl)
        return dx, dl, dB, dC
    dB = torch.zeros(b_shape, dtype=f32, device=dev)
    dC = torch.zeros(c_shape, dtype=f32, device=dev)
    cells_per_row = math.prod(lead[1:])
    rows = max(1, _CHUNK_ELEMS // max(1, cells_per_row * q * q))
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    for r0 in range(0, lead[0], rows):
        r1 = min(lead[0], r0 + rows)
        sl = slice(r0, r1)
        db, dc = _ssd_cells_bwd(xbar[sl], loga[sl], Bx[sl], Cx[sl], dy[sl],
                                dstate[sl], dx[sl], dl[sl], tril)
        for full, part, shape in ((dB, db, b_shape), (dC, dc, c_shape)):
            if shape[0] == 1:  # broadcast over the first axis: add
                full += part.sum_to_size(full.shape)
            else:
                full[sl] = part.sum_to_size((r1 - r0, *shape[1:]))
    return dx, dl, dB.reshape(B.shape), dC.reshape(C.shape)


def _ssd_cells_bwd(xbar, loga, B, C, dy, dstate, dx, dl, tril=None):
    """Per-cell gradients of a chunk of cells: fills dx and dl, returns
    the per-cell dB and dC."""
    f32 = torch.float32
    x = xbar.to(f32)
    Bf = B.to(f32)
    Cf = C.to(f32)
    g = dy.to(f32)
    ds = dstate.to(f32)
    cum = torch.cumsum(loga.to(f32), dim=-1)
    q = x.shape[-2]
    if tril is None:
        tril = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                     device=x.device))
    L = torch.where(tril, torch.exp(cum[..., :, None] - cum[..., None, :]),
                    0.0)
    G = Cf @ Bf.transpose(-1, -2)
    M = G * L
    dM = g @ x.transpose(-1, -2)  # only s <= t matters: L and M vanish above
    w = torch.exp(cum[..., -1:] - cum)  # (..., q)
    dx.copy_(M.transpose(-1, -2) @ g + (Bf * w[..., None]) @ ds)
    dMM = dM * M
    del M
    dG = dM * L
    del dM, L
    dC = dG @ Bf
    xd = x @ ds.transpose(-1, -2)  # (..., q, n)
    dB = dG.transpose(-1, -2) @ Cf + w[..., None] * xd
    del dG
    wu = w * torch.sum(xd * Bf, dim=-1)
    dc = dMM.sum(dim=-1) - dMM.sum(dim=-2) - wu
    del dMM
    dc[..., -1] += wu.sum(dim=-1)
    dl.copy_(torch.flip(torch.cumsum(torch.flip(dc, (-1,)), dim=-1), (-1,)))
    return dB, dC


def ssd_reference_scan(
    xbar: torch.Tensor,  # (l, p)
    loga: torch.Tensor,  # (l,)
    B: torch.Tensor,  # (l, n)
    C: torch.Tensor,  # (l, n)
    s0=None,  # (n, p)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step recurrent oracle of SSD: s_t = a_t s_{t-1} + B_t (x)
    xbar_t, y_t = C_t @ s_t. Returns (ys (l, p), s_final (n, p))."""
    f32 = torch.float32
    l, p = xbar.shape
    n = B.shape[1]
    s = (torch.zeros((n, p), dtype=f32, device=xbar.device) if s0 is None
         else s0.to(f32))
    ys = []
    for t in range(l):
        s = torch.exp(loga[t].to(f32)) * s + B[t].to(f32)[:, None] * xbar[
            t].to(f32)[None, :]
        ys.append(C[t].to(f32) @ s)
    return torch.stack(ys), s
