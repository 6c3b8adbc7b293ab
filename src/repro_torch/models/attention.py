"""Attention over a sequence, through the flash-attention forward (K4) and
backward (K5).

Reference: ``repro/models/attention.py`` (``flash_attention`` :221 and
its custom VJP ``_flash`` :88-128, ``_flash_bwd`` :131). (B, S, H, hd)
with GQA kv heads goes to the kernels' (B*H, S, hd) with the kv heads
expanded (``jnp.repeat`` order: query head h reads kv head h // rep), and
back. ``FlashAttention`` is the custom VJP: its forward saves (q, k, v, o,
lse), O(S * hd) and never O(S^2), and its backward recomputes the scores
from (q, k, lse) in K5. The GQA expansion happens before the Function,
so autograd sums dk and dv over the ``rep`` query heads of each kv head,
as ``_flash_bwd`` does at :212-214. It is ``repeat_interleave``'s layout
written as an expand and a reshape: the backward of ``repeat_interleave``
is an ``index_add_`` (float atomics on the card, so its sums change from
run to run), that of an expand a plain reduction, the same every run. The
reference's block sizes and masked-block skipping are schedule choices
and change no result; K4 and K5 always skip masked tiles. No heads at all
(a tensor-parallel position that holds none, ``models.model``) launch no
kernel: o is empty, and so are the gradients.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops


class FlashAttention(torch.autograd.Function):
    """o = softmax(q k^T / sqrt(hd), masked) v over (BH, S, hd) tensors.

    Forward: ``ops.flash_attention_fwd`` (K4); backward:
    ``ops.flash_attention_bwd`` (K5) with the same ``force``, so
    ``force="ref"`` differentiates the plain path end to end.
    """

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, force: Optional[str]):
        ctx.causal, ctx.force = causal, force
        if q.shape[0] == 0:  # no heads: nothing to launch
            ctx.save_for_backward(q, k, v)
            return torch.empty_like(q)
        o, lse = ops.flash_attention_fwd(q, k, v, causal=causal, force=force,
                                         device=q.device)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        saved = ctx.saved_tensors  # once: a checkpoint unpacks them once
        if len(saved) == 3:
            return (*(torch.zeros_like(t) for t in saved), None, None)
        q, k, v, o, lse = saved
        dq, dk, dv = ops.flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            force=ctx.force, device=q.device)
        return dq, dk, dv, None, None


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B * H, S, hd), contiguous as the kernels take it
    (at B = 1 the reshape alone is a strided view)."""
    B, S, H, hd = t.shape
    return t.transpose(1, 2).reshape(B * H, S, hd).contiguous()


def _repeat_heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV * rep, hd), head h reading kv head
    h // rep (``torch.repeat_interleave(t, rep, dim=2)``)."""
    B, S, KV, hd = t.shape
    return t[:, :, :, None].expand(B, S, KV, rep, hd).reshape(
        B, S, KV * rep, hd)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    *,
    causal: bool,
    force: Optional[str] = None,
) -> torch.Tensor:
    """Returns o (B, Sq, H, hd) in q's dtype; differentiable in q, k, v."""
    B, Sq, H, hd = q.shape
    rep = H // k.shape[2] if k.shape[2] else 1
    if rep > 1:
        k, v = (_repeat_heads(t, rep) for t in (k, v))
    o = FlashAttention.apply(_heads_first(q), _heads_first(k),
                             _heads_first(v), causal, force)
    return o.reshape(B, H, Sq, hd).transpose(1, 2)
