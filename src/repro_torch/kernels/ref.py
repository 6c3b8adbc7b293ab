"""Plain PyTorch versions of the hand-written kernels.

Reference: ``repro/kernels/ref.py`` (``pairwise_sqdist``, ``gmm_update``,
the precheck oracles ``_nearest_stats`` :31, ``center_precheck`` :59,
``center_precheck_matmul`` :79, ``ssd_intra_chunk`` :132,
``ssd_reference_scan`` :162 and ``flash_attention_fwd`` :196), and the
backward of ``repro/kernels/flash.py`` (``flash_attention_bwd`` :219),
which has no jnp oracle there (its test differentiates the dense
formula). These are
the CPU path of ``ops`` and the oracle that the CUDA/Triton kernels are
held against on the card (``force="ref"``).
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
    far_idx = torch.argmax(masked).to(torch.int32)
    far_val = masked[far_idx.long()]
    return new_min, far_idx, far_val


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


NEG_INF = -1e30
_CHUNK_ELEMS = 2**28  # f32 elements of one temporary of the chunked oracles


def flash_attention_fwd(
    q: torch.Tensor,  # (BH, Sq, hd)
    k: torch.Tensor,  # (BH, Skv, hd)
    v: torch.Tensor,  # (BH, Skv, hd)
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense-softmax attention, the plain version of K4. Returns (o in q's
    dtype, lse (BH, Sq) f32).

    Scores are (q . k) / sqrt(hd) in f32; the causal mask is ``qpos >=
    kpos`` from 0 (top-left aligned), masked scores are -1e30. ``lse`` is
    ``repro/models/attention.py:69-70``'s: m + log(max(l, 1e-30)) where l > 0,
    else -1e30. q rows are walked in chunks so that one (BH, rows, Skv) f32
    score block stays near 1 GB; a chunk changes no row's formula.
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
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m)
        del s
        l = torch.sum(p, dim=-1, keepdim=True)
        o[:, r0:r1] = (torch.einsum("bqk,bkh->bqh", p, vf)
                       / torch.clamp_min(l, 1e-30)).to(q.dtype)
        lse[:, r0:r1] = torch.where(
            l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), NEG_INF)[..., 0]
    return o, lse


def flash_attention_bwd(
    q: torch.Tensor,  # (BH, Sq, hd)
    k: torch.Tensor,  # (BH, Skv, hd)
    v: torch.Tensor,  # (BH, Skv, hd)
    o: torch.Tensor,  # (BH, Sq, hd)
    lse: torch.Tensor,  # (BH, Sq) f32
    do: torch.Tensor,  # (BH, Sq, hd)
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-recompute backward of attention, the plain version of K5.
    Returns (dq, dk, dv) in the inputs' dtypes.

    P is recomputed from (q, k, lse) with the forward's scale and mask
    (masked scores -1e30, so their P is 0); dsum = rowsum(do * o);
    ds = P * (do v^T - dsum) * scale; dq = ds k, dk = ds^T q, dv = P^T do,
    all in f32. q rows are walked in chunks as in ``flash_attention_fwd``,
    so one (BH, rows, Skv) f32 block stays near 1 GB; dk and dv sum the
    chunks in f32.
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
        dv += torch.einsum("bqk,bqh->bkh", p, doc)
        dp = torch.einsum("bqh,bkh->bqk", doc, vf)
        ds = p * (dp - dsum[:, r0:r1, None]) * scale
        del p, dp
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
