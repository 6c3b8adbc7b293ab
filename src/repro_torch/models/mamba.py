"""Mamba2 block (state-space duality, arXiv:2405.21060) in chunked form.

Reference: ``repro/models/mamba.py`` (``mamba_dims`` :19, ``mamba_init``
:25, ``_causal_conv`` :50, ``ssd_chunked`` :60, ``_split_proj`` :122,
``mamba_apply`` :131, ``mamba_decode`` :172). The intra-chunk step of
``ssd_chunked`` goes through ``SSDIntraChunk``, whose forward is
``ops.ssd_intra_chunk`` (kernel K6) and whose backward is
``ops.ssd_intra_chunk_bwd`` (kernel K6b; the reference differentiates its
jnp form with ``jax.grad``), on a strided view of the activations: cells
are (batch * chunk, head), and B and C, shared by all heads (ngroups = 1),
go in as a stride-0 head broadcast, never copied per head, and their
gradients come back summed over the heads. The decays and the
inter-chunk recurrence over (H, P, N) states and its contribution y_off
stay in plain torch, as the kernel's docstring leaves them to the caller,
and autograd differentiates them as they are. Under no_grad, y_off is
added in place chunk by chunk inside that loop, so the states entering
each chunk are never stacked; under autograd the chunks' y_off are
stacked and added once (an in-place add into a view of the Function's
output would make autograd copy the whole gradient once a chunk).

Over a model axis (ROADMAP.md step 13.8; the reference's
``param_specs(..., tp="model")`` with GSPMD placing the work),
``tp_mamba_apply`` runs one block on each position's H/tp heads. The
slices of ``A_log``, ``D``, ``dt_bias``, the gated ``norm`` and
``out_proj``'s rows are exactly position j's head group (heads ``[j H/tp,
(j+1) H/tp)``, channels ``[j d_inner/tp, ...)``). The slices of
``in_proj``, ``conv_w`` and ``conv_b`` cut across their z | x | B | C |
dt groups, and B and C are shared by every head: so these three leaves
are gathered whole over the axis (``ModelGroup.all_gather``: weights
cross, not the (B, S, 2 d_inner + 2N + H) activations), and each position
takes its z, x and dt columns and B and C whole. K6 and K6b run on the
position's (B * chunks, H/tp) cells as ever; K6b's dB and dC sum over the
position's own heads only, and the rest of the sum over the axis comes
from the gather's backward and the normed input's copy-in. The gated
norm's mean over all of d_inner is each position's f32 sum of squares,
summed by a reduce-out and copied back in (so its backward is a sum too),
over d_inner; ``out_proj``'s row slices' products stay in f32
(``common.WideProduct``) and one reduce-out sums them, rounded once.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import Init, WideProduct, normal, ones, rms_norm, zeros


def mamba_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    return d_inner, H, cfg.ssm_state


def mamba_init(cfg, dtype) -> dict:
    d = cfg.d_model
    d_inner, H, N = mamba_dims(cfg)
    conv_ch = d_inner + 2 * N
    proj_out = 2 * d_inner + 2 * N + H  # z, x, B, C, dt
    f32 = torch.float32
    return {
        "in_proj": normal((d, proj_out), (1.0 / d) ** 0.5, dtype),
        "conv_w": normal((cfg.d_conv, conv_ch), 0.1, dtype),
        "conv_b": zeros((conv_ch,), dtype),
        "A_log": Init((H,), f32, "log_uniform", (1.0, 16.0)),
        "D": ones((H,), f32),
        "dt_bias": Init((H,), f32, "inv_softplus_uniform", (1e-3, 0.1)),
        "norm": ones((d_inner,), dtype),
        "out_proj": normal((d_inner, d), (1.0 / d_inner) ** 0.5, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv. x: (B, S, C), w: (K, C)."""
    K = w.shape[0]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = sum(pad[:, j:j + x.shape[1], :] * w[j][None, None, :]
            for j in range(K))
    return y + b[None, None, :]


class SSDIntraChunk(torch.autograd.Function):
    """(y_intra, state) of the SSD intra-chunk step over (xbar, loga, B, C)
    cells, as ``ops.ssd_intra_chunk`` takes them.

    Forward: ``ops.ssd_intra_chunk`` (K6); it saves the four inputs, not
    y. Backward: ``ops.ssd_intra_chunk_bwd`` (K6b) with the same
    ``force``, so ``force="ref"`` differentiates the plain path end to
    end. An output gradient autograd does not have (an unused state)
    arrives as zeros.
    """

    @staticmethod
    def forward(ctx, xbar, loga, B, C, force: Optional[str]):
        y, state, _, _ = ops.ssd_intra_chunk(xbar, loga, B, C, force=force,
                                             device=xbar.device)
        ctx.save_for_backward(xbar, loga, B, C)
        ctx.force = force
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        xbar, loga, B, C = ctx.saved_tensors
        dx, dl, dB, dC = ops.ssd_intra_chunk_bwd(
            xbar, loga, B, C, dy, dstate, force=ctx.force,
            device=xbar.device)
        return dx, dl, dB, dC, None


def ssd_chunked(
    xbar: torch.Tensor,  # (B, S, H, P) dt-scaled inputs
    loga: torch.Tensor,  # (B, S, H) log decays (<= 0)
    Bm: torch.Tensor,  # (B, S, N)
    Cm: torch.Tensor,  # (B, S, N)
    chunk: int,
    s0: Optional[torch.Tensor] = None,  # (B, H, P, N)
    *,
    force: Optional[str] = None,
):
    """Chunked SSD. Returns (y (B,S,H,P), final_state (B,H,P,N) f32)."""
    Bsz, S, H, P = xbar.shape
    N = Bm.shape[-1]
    assert S % chunk == 0, (S, chunk)
    nc, Q = S // chunk, chunk
    f32 = torch.float32

    # cells (batch * chunk, head): views of the (B, S, H, .) activations
    xb = xbar.to(f32).reshape(Bsz * nc, Q, H, P).permute(0, 2, 1, 3)
    la = loga.to(f32).reshape(Bsz * nc, Q, H).permute(0, 2, 1)
    Bc = Bm.to(f32).reshape(Bsz * nc, 1, Q, N)
    Cf = Cm.to(f32)
    Cc = Cf.reshape(Bsz * nc, 1, Q, N)
    y_diag, states = SSDIntraChunk.apply(xb, la, Bc, Cc, force)
    cum = torch.cumsum(la, dim=-1)
    # (B*nc, H, Q, P) -> (B, nc, Q, H, P); a view when y kept xb's layout
    y = y_diag.permute(0, 2, 1, 3).reshape(Bsz, nc, Q, H, P)
    states = states.reshape(Bsz, nc, H, N, P)
    decay_start = torch.exp(cum).reshape(Bsz, nc, H, Q)
    total = torch.exp(cum[..., -1]).reshape(Bsz, nc, H)
    Cf = Cf.reshape(Bsz, nc, Q, N)

    s = (torch.zeros((Bsz, H, P, N), dtype=f32, device=xbar.device)
         if s0 is None else s0.to(f32))
    graph = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (xbar, loga, Bm, Cm, s0))
    offs = []
    for c in range(nc):
        # y_off[t] = exp(cum[t]) C_t . s_entering
        y_off = torch.einsum("btn,bhpn->bthp", Cf[:, c], s)
        y_off = y_off * decay_start[:, c].transpose(1, 2)[..., None]
        if graph:
            offs.append(y_off)
        else:
            y[:, c] += y_off
        s = s * total[:, c, :, None, None] + states[:, c].transpose(-1, -2)
    if graph:
        y = y + torch.stack(offs, dim=1)
    return y.reshape(Bsz, S, H, P).to(xbar.dtype), s


def _split_proj(zxbcdt, d_inner, N, H):
    z = zxbcdt[..., :d_inner]
    xc = zxbcdt[..., d_inner:2 * d_inner]
    Bc = zxbcdt[..., 2 * d_inner:2 * d_inner + N]
    Cc = zxbcdt[..., 2 * d_inner + N:2 * d_inner + 2 * N]
    dt = zxbcdt[..., 2 * d_inner + 2 * N:]
    return z, xc, Bc, Cc, dt


def mamba_apply(
    x: torch.Tensor,  # (B, S, d)
    p: dict,
    cfg,
    *,
    chunk: int = 256,
    want_cache: bool = False,
    force: Optional[str] = None,
):
    """Full-sequence Mamba2 block. Returns (y, cache | None).

    cache = (ssm_state (B,H,P,N) f32, conv_cache (B, d_conv-1, conv_ch)).
    """
    B, S, d = x.shape
    d_inner, H, N = mamba_dims(cfg)
    P = cfg.ssm_head_dim
    f32 = torch.float32
    zxbcdt = x @ p["in_proj"]
    z, xc, Bc, Cc, dt = _split_proj(zxbcdt, d_inner, N, H)
    conv_in = torch.cat([xc, Bc, Cc], dim=-1)
    conv_out = F.silu(
        _causal_conv(conv_in, p["conv_w"], p["conv_b"]).to(f32)
    ).to(x.dtype)
    xc = conv_out[..., :d_inner]
    Bc = conv_out[..., d_inner:d_inner + N]
    Cc = conv_out[..., d_inner + N:]

    xh = xc.reshape(B, S, H, P)
    dtf = F.softplus(dt.to(f32) + p["dt_bias"])  # (B,S,H)
    loga = -torch.exp(p["A_log"])[None, None] * dtf
    xbar = xh.to(f32) * dtf[..., None]

    c = min(chunk, S)
    while S % c:
        c //= 2
    y, s_fin = ssd_chunked(xbar, loga, Bc, Cc, c, force=force)
    y = y + p["D"][None, None, :, None] * xh.to(f32)
    y = y.reshape(B, S, d_inner)
    y = y * F.silu(z.to(f32))
    y = rms_norm(y.to(x.dtype), p["norm"])
    out = y @ p["out_proj"]
    if not want_cache:
        return out, None
    conv_cache = conv_in[:, S - (cfg.d_conv - 1):, :]
    return out, (s_fin, conv_cache)


def _head_cols(w: torch.Tensor, dim: int, parts) -> torch.Tensor:
    """The (start, length) ranges ``parts`` of ``w`` along ``dim``,
    concatenated."""
    return torch.cat([w.narrow(dim, a, n) for a, n in parts], dim)


def _tp_leaves(ps: list, group) -> tuple[list, list, list]:
    """``in_proj``, ``conv_w`` and ``conv_b`` whole on each local position
    (regrouped over the axis)."""
    return (group.all_gather([p["in_proj"] for p in ps], 1),
            group.all_gather([p["conv_w"] for p in ps], 1),
            group.all_gather([p["conv_b"] for p in ps], 0))


def _tp_cols(cfg, tp: int, j: int) -> tuple[list, list]:
    """Position ``j``'s (start, length) column ranges of ``in_proj`` (z
    and x of its heads, B and C whole, its dt) and of the conv (x of its
    heads, B and C whole)."""
    d_inner, H, N = mamba_dims(cfg)
    hl, dl = H // tp, d_inner // tp
    return ([(j * dl, dl), (d_inner + j * dl, dl), (2 * d_inner, 2 * N),
             (2 * d_inner + 2 * N + j * hl, hl)],
            [(j * dl, dl), (d_inner, 2 * N)])


def _tp_gated_out(ys: list, ps: list, h_parts: list, group, d_inner: int):
    """The gated norm and ``out_proj`` over a model axis: ``ys`` are the
    positions' ``y * silu(z)`` of their heads in f32; the mean of squares
    over all of d_inner is a reduce-out of their f32 sums (copied back
    in), and the row slices' f32 products are summed by a reduce-out."""
    f32 = torch.float32
    yfs = [y.to(h.dtype).to(f32) for y, h in zip(ys, h_parts)]
    sqs = [torch.sum(yf * yf, dim=-1, keepdim=True) for yf in yfs]
    var = [t / d_inner for t in group.copy_in(group.reduce_out(sqs))]
    outs = []
    for yf, v, p, h in zip(yfs, var, ps, h_parts):
        yn = (yf * torch.rsqrt(v + 1e-6) * p["norm"].to(f32)).to(h.dtype)
        outs.append(WideProduct.apply(yn, p["out_proj"]))
    return group.reduce_out(outs)


def tp_mamba_apply(
    h_parts: list,  # each local position's copy of the normed input (B,S,d)
    ps: list,  # each local position's model slices of the block's leaves
    cfg,
    group,  # launch.mesh.ModelGroup
    *,
    chunk: int = 256,
    want_cache: bool = False,
    force: Optional[str] = None,
):
    """``mamba_apply`` over a model axis (see the module): (the sum over
    the positions of their heads' ``out_proj`` products, in f32, on the
    first local position's device; each local position's cache or None).
    A position's cache is the final SSD state of its heads (B, H/tp, P,
    N) f32 and the conv window of its conv columns, its heads' x channels
    and B and C whole (B, d_conv - 1, d_inner/tp + 2N)."""
    B, S, _d = h_parts[0].shape
    d_inner, H, N = mamba_dims(cfg)
    P = cfg.ssm_head_dim
    tp = group.size
    hl, dl = H // tp, d_inner // tp
    f32 = torch.float32
    c = min(chunk, S)
    while S % c:
        c //= 2
    ys, caches = [], []
    for h, p, w, cw, cb, j in zip(h_parts, ps, *_tp_leaves(ps, group),
                                  group.index):
        in_cols, conv_cols = _tp_cols(cfg, tp, j)
        zxbcdt = h @ _head_cols(w, 1, in_cols)
        z = zxbcdt[..., :dl]
        dt = zxbcdt[..., 2 * dl + 2 * N:]
        conv_in = zxbcdt[..., dl:2 * dl + 2 * N]
        conv_out = F.silu(_causal_conv(
            conv_in, _head_cols(cw, 1, conv_cols),
            _head_cols(cb, 0, conv_cols)).to(f32)).to(h.dtype)
        xc = conv_out[..., :dl]
        Bc = conv_out[..., dl:dl + N]
        Cc = conv_out[..., dl + N:]
        xh = xc.reshape(B, S, hl, P)
        dtf = F.softplus(dt.to(f32) + p["dt_bias"])
        loga = -torch.exp(p["A_log"])[None, None] * dtf
        xbar = xh.to(f32) * dtf[..., None]
        y, s_fin = ssd_chunked(xbar, loga, Bc, Cc, c, force=force)
        y = y + p["D"][None, None, :, None] * xh.to(f32)
        ys.append(y.reshape(B, S, dl) * F.silu(z.to(f32)))
        if want_cache:
            caches.append((s_fin, conv_in[:, S - (cfg.d_conv - 1):, :]))
    out = _tp_gated_out(ys, ps, h_parts, group, d_inner)
    return out, (caches if want_cache else None)


def mamba_decode(
    x: torch.Tensor,  # (B, 1, d)
    p: dict,
    cfg,
    cache,  # (ssm_state (B,H,P,N), conv_cache (B, d_conv-1, conv_ch))
):
    """One token against the caches. Returns (y, new cache), both new
    tensors (the caller may copy the cache back in place)."""
    B, _, d = x.shape
    d_inner, H, N = mamba_dims(cfg)
    P = cfg.ssm_head_dim
    f32 = torch.float32
    ssm, conv_cache = cache
    zxbcdt = x @ p["in_proj"]
    z, xc, Bc, Cc, dt = _split_proj(zxbcdt[:, 0], d_inner, N, H)
    conv_new = torch.cat([xc, Bc, Cc], dim=-1)  # (B, conv_ch)
    win = torch.cat([conv_cache, conv_new[:, None]], dim=1)  # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out.to(f32)).to(x.dtype)
    xc = conv_out[..., :d_inner]
    Bc = conv_out[..., d_inner:d_inner + N].to(f32)
    Cc = conv_out[..., d_inner + N:].to(f32)

    xh = xc.reshape(B, H, P).to(f32)
    dtf = F.softplus(dt.to(f32) + p["dt_bias"])  # (B,H)
    a = torch.exp(-torch.exp(p["A_log"])[None] * dtf)  # (B,H)
    xbar = xh * dtf[..., None]
    ssm = ssm * a[..., None, None] + xbar[..., None] * Bc[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", ssm, Cc) + p["D"][None, :, None] * xh
    y = y.reshape(B, d_inner) * F.silu(z.to(f32))
    y = rms_norm(y.to(x.dtype), p["norm"])
    out = (y @ p["out_proj"])[:, None, :]
    return out, (ssm, win[:, 1:])


def tp_mamba_decode(
    h_parts: list,  # each local position's copy of the normed input (B,1,d)
    ps: list,  # each local position's model slices of the block's leaves
    cfg,
    group,  # launch.mesh.ModelGroup
    caches: list,  # each local position's cache (tp_mamba_apply's)
):
    """``mamba_decode`` over a model axis: each position steps its heads'
    SSD state and its conv columns' window, then the gated norm and
    ``out_proj`` as in ``tp_mamba_apply``. Returns (the reduce-out of the
    positions' f32 ``out_proj`` products (B, 1, d), each position's new
    cache, new tensors)."""
    B = h_parts[0].shape[0]
    d_inner, H, N = mamba_dims(cfg)
    P = cfg.ssm_head_dim
    tp = group.size
    hl, dl = H // tp, d_inner // tp
    f32 = torch.float32
    ys, new = [], []
    for h, p, w, cw, cb, j, (ssm, conv_cache) in zip(
            h_parts, ps, *_tp_leaves(ps, group), group.index, caches):
        in_cols, conv_cols = _tp_cols(cfg, tp, j)
        zxbcdt = h[:, 0] @ _head_cols(w, 1, in_cols)
        z = zxbcdt[..., :dl]
        dt = zxbcdt[..., 2 * dl + 2 * N:]
        win = torch.cat([conv_cache, zxbcdt[:, None, dl:2 * dl + 2 * N]],
                        dim=1)  # (B, K, dl + 2N)
        conv_out = (torch.einsum("bkc,kc->bc", win,
                                 _head_cols(cw, 1, conv_cols))
                    + _head_cols(cb, 0, conv_cols))
        conv_out = F.silu(conv_out.to(f32)).to(h.dtype)
        xh = conv_out[..., :dl].reshape(B, hl, P).to(f32)
        Bc = conv_out[..., dl:dl + N].to(f32)
        Cc = conv_out[..., dl + N:].to(f32)
        dtf = F.softplus(dt.to(f32) + p["dt_bias"])  # (B, H/tp)
        a = torch.exp(-torch.exp(p["A_log"])[None] * dtf)
        xbar = xh * dtf[..., None]
        ssm = ssm * a[..., None, None] + xbar[..., None] * Bc[:, None, None, :]
        y = torch.einsum("bhpn,bn->bhp", ssm, Cc) + p["D"][None, :, None] * xh
        ys.append((y.reshape(B, dl) * F.silu(z.to(f32)))[:, None])
        new.append((ssm, win[:, 1:]))
    return _tp_gated_out(ys, ps, h_parts, group, d_inner), new
