"""Shared transformer building blocks: RMSNorm, RoPE, attention (through
kernel K4), SwiGLU/GELU MLPs, and the parameter specs they draw from.

Reference: ``repro/models/common.py`` (``rms_norm`` :19, ``rope`` :26,
``blockwise_attention`` :53, ``decode_attention`` :159, ``mlp_apply``
:194, ``mlp_init`` :206, ``attn_init`` :225, ``attn_qkv`` :238).
``mlp_hidden`` and ``WideProduct`` serve tensor-parallel training: the MLP
on a model slice of its columns, and a row slice's product in f32. The cast
points are the reference's: rms_norm and RoPE in f32 and back to x's
dtype, SiLU/GELU in f32, decode attention upcast to f32. Matmuls keep the
config dtype (bf16 by default) and go to ``torch.matmul``, as the
reference leaves them to XLA.

Parameters are described before they exist: an ``*_init`` returns a tree
of ``Init`` specs (shape, dtype, distribution), which ``LM.init`` draws
from a ``torch.Generator`` and ``LM.param_count`` sums without
allocating. ``blockwise_attention_ref`` is the reference's autodiff
oracle (:73), K4's plain version under autograd; the plain path of K4
inside the model is ``force="ref"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class Init:
    """One parameter before it is drawn: shape, dtype, distribution.

    kind: "normal" (arg = std), "ones", "zeros", "log_uniform" (log of
    U(lo, hi)), "inv_softplus_uniform" (log(exp(U(lo, hi)) - 1)). ``lead``
    counts the leading stack axes (one block per index), which are drawn
    one block at a time.
    """

    shape: tuple
    dtype: torch.dtype
    kind: str
    arg: tuple = ()
    lead: int = 0

    def stacked(self, count: int) -> "Init":
        return dataclasses.replace(self, shape=(count, *self.shape),
                                   lead=self.lead + 1)

    def numel(self) -> int:
        return math.prod(self.shape)


def normal(shape, std: float, dtype) -> Init:
    return Init(tuple(shape), dtype, "normal", (float(std),))


def ones(shape, dtype) -> Init:
    return Init(tuple(shape), dtype, "ones")


def zeros(shape, dtype) -> Init:
    return Init(tuple(shape), dtype, "zeros")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int. Rotates in f32."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=x.device),
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.split(x.to(torch.float32), half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def blockwise_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    *,
    causal: bool,
    force: Optional[str] = None,
) -> torch.Tensor:
    """Attention over the sequence through K4 (see ``attention.py``). The
    reference's block sizes and masked-block skipping are schedule choices
    of its TPU kernel and change no result; K4 skips masked tiles always."""
    from .attention import flash_attention

    return flash_attention(q, k, v, causal=causal, force=force)


def blockwise_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    *,
    causal: bool,
    q_offset: int = 0,
    q_block: int = 512,
    kv_block: int = 1024,
    skip_masked_blocks: bool = False,
) -> torch.Tensor:
    """The reference's autodiff oracle over K4's plain version
    (``kernels/ref.py``), differentiated by autograd: the kv heads
    repeated for GQA, query i at position ``q_offset + i`` (the queries
    padded in front by ``q_offset`` rows, dropped after). With a bf16 v,
    P is rounded to bf16 before P V, as the reference casts it to v's
    dtype. The block sizes and ``skip_masked_blocks`` change no value
    but rounding and are taken for the reference's signature."""
    from ..kernels import ref

    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    pad = q_offset if causal else 0
    qh = F.pad(q, (0, 0, 0, 0, pad, 0)).transpose(1, 2).reshape(
        B * H, Sq + pad, hd)
    kh, vh = (t.repeat_interleave(H // KV, dim=2).transpose(1, 2).reshape(
        B * H, Skv, hd) for t in (k, v))
    o, _ = ref.flash_attention_fwd(qh, kh, vh, causal=causal,
                                   bf16_p=v.dtype == torch.bfloat16)
    return o.reshape(B, H, Sq + pad, hd)[:, :, pad:].transpose(1, 2)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, S, KV, hd)
    v_cache: torch.Tensor,  # (B, S, KV, hd)
    pos: int,  # current position (attend to <= pos)
) -> torch.Tensor:
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    scale = 1.0 / (hd ** 0.5)
    qr = q.reshape(B, KV, rep, hd)
    s = torch.einsum("bgrh,bsgh->bgrs", qr.to(torch.float32),
                     k_cache.to(torch.float32)) * scale
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgh->bgrh", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def mlp_hidden(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    """The MLP's activation, the input of ``w_out``: on the columns of
    ``w_in`` (and ``w_gate``) that ``p`` holds, all or a model slice."""
    if kind == "swiglu":
        gate = x @ p["w_gate"]
        up = x @ p["w_in"]
        return F.silu(gate.to(torch.float32)).to(x.dtype) * up
    if kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu((x @ p["w_in"]).to(torch.float32),
                      approximate="tanh").to(x.dtype)
    raise ValueError(kind)


def mlp_apply(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    return mlp_hidden(x, p, kind) @ p["w_out"]


class WideProduct(torch.autograd.Function):
    """``x @ w`` (x: (..., K), w: (K, N)) with the product kept in f32
    where x and w are bf16 or f16 (f32 accumulation, no rounding to their
    dtype), for a row slice of ``wo`` or ``w_out`` whose products the
    model axis sums: the sum then rounds once, as the whole product does.
    The backward is the plain product's (dy rounded to x's dtype)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.flatten(0, -2)
        if x.shape[-1] == 0:  # a position with no heads: a zero partial
            y = torch.zeros((x2.shape[0], w.shape[-1]), dtype=torch.float32,
                            device=x.device)
        elif x.dtype == torch.float32:
            y = x2 @ w
        elif x.is_cuda:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        else:  # no mm.dtype on the CPU: bf16 products are exact in f32
            y = x2.to(torch.float32) @ w.to(torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy2 = dy.to(x.dtype).reshape(-1, dy.shape[-1])
        dx = dy2 @ w.t()
        dw = x.flatten(0, -2).t() @ dy2
        return dx.reshape(x.shape), dw


def mlp_init(d: int, f: int, kind: str, dtype) -> dict:
    s_in = (2.0 / d) ** 0.5
    s_out = (2.0 / f) ** 0.5
    p = {
        "w_in": normal((d, f), s_in, dtype),
        "w_out": normal((f, d), s_out, dtype),
    }
    if kind == "swiglu":
        p["w_gate"] = normal((d, f), s_in, dtype)
    return p


def attn_init(d: int, n_heads: int, n_kv: int, head_dim: int, dtype) -> dict:
    s = (1.0 / d) ** 0.5
    return {
        "wq": normal((d, n_heads * head_dim), s, dtype),
        "wk": normal((d, n_kv * head_dim), s, dtype),
        "wv": normal((d, n_kv * head_dim), s, dtype),
        "wo": normal((n_heads * head_dim, d), s, dtype),
    }


def attn_qkv(x: torch.Tensor, p: dict, n_heads: int, n_kv: int,
             head_dim: int):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(B, S, n_kv, head_dim)
    return q, k, v
