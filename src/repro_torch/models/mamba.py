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
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops
from .common import Init, normal, ones, rms_norm, zeros


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
