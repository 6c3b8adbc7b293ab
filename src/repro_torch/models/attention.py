"""Attention over a sequence, through the flash-attention forward (K4).

Reference: ``repro/models/attention.py`` (``flash_attention`` :221), in
its forward layout only: (B, S, H, hd) with GQA kv heads goes to the
kernel's (B*H, S, hd) with the kv heads expanded (``jnp.repeat`` order:
query head h reads kv head h // rep), and back. The reference's custom
VJP (a backward that recomputes the scores from (q, k, lse)) waits for the
training slice and kernel K5.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = t.shape
    return t.transpose(1, 2).reshape(B * H, S, hd)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    *,
    causal: bool,
    force: Optional[str] = None,
) -> torch.Tensor:
    """Returns o (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    rep = H // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    o, _lse = ops.flash_attention_fwd(
        _heads_first(q), _heads_first(k), _heads_first(v), causal=causal,
        force=force, device=q.device,
    )
    return o.reshape(B, H, Sq, hd).transpose(1, 2)
