"""Mixture-of-Experts FFN with group-local capacity dispatch.

Reference: ``repro/models/moe.py`` (``moe_init`` :19, ``moe_apply`` :33).
Positions and capacity are computed within each sequence (group = batch
row): token t's choice j goes to slot ``pos`` of its expert, the number of
earlier (token, choice) pairs of the row routed there, and is dropped when
``pos >= cap``. The expert products are batched matmuls over the expert
axis, as the reference's einsums (no Pallas kernel there, none here).
Top-1 (llama4-style) and top-2 (phi-3.5-style) routing; the Shazeer
load-balancing aux loss.

Top-k is a stable descending sort, so tied probabilities go to the lower
expert index as ``jax.lax.top_k`` breaks them (``torch.topk`` does not
promise an order among ties). The scatter into the (B, E, cap, d)
buffer adds exactly one nonzero term to each used slot (a dropped token
adds zero to slot ``cap - 1``, as in the reference), and the gather's
backward likewise, so the result does not depend on the order of the adds.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import normal


def moe_init(d: int, f: int, n_experts: int, dtype) -> dict:
    """Specs of one MoE FFN: the router in f32, the experts' weights with
    the expert axis as a stack axis (drawn one expert at a time)."""
    s_in = (2.0 / d) ** 0.5
    s_out = (2.0 / f) ** 0.5
    return {
        "router": normal((d, n_experts), 0.02, torch.float32),
        "w_in": normal((d, f), s_in, dtype).stacked(n_experts),
        "w_gate": normal((d, f), s_in, dtype).stacked(n_experts),
        "w_out": normal((f, d), s_out, dtype).stacked(n_experts),
    }


class Route(NamedTuple):
    """Where each (token, choice) of a (B, S) batch goes: ``probs`` (B, S,
    E) f32, ``gate`` (B, S, k) normalised, ``eidx`` (B, S, k) experts,
    ``pos`` (B, S * k) slot before the drop, ``keep`` (B, S * k), ``cap``."""

    probs: torch.Tensor
    gate: torch.Tensor
    eidx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int


def capacity(seq_len: int, top_k: int, capacity_factor: float,
             n_experts: int) -> int:
    """Slots an expert holds for one sequence (reference :43)."""
    return max(1, int(seq_len * top_k * capacity_factor / n_experts + 0.999))


def moe_route(x: torch.Tensor, router: torch.Tensor, *, top_k: int,
              capacity_factor: float, eidx: torch.Tensor = None) -> Route:
    """The route of every (token, choice). ``eidx`` (B, S, k), if given,
    replaces the top-k choice (gates, slots and drops follow from it): a
    replay of another run's routes, where a near-tie of the router's
    probabilities went the other way there."""
    B, S, _ = x.shape
    E = router.shape[1]
    cap = capacity(S, top_k, capacity_factor, E)
    logits = x.to(router.dtype) @ router  # (B, S, E), f32 as the router
    probs = torch.softmax(logits, dim=-1)
    if eidx is None:
        srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, eidx = srt[..., :top_k], order[..., :top_k]
    else:
        eidx = eidx.to(device=x.device, dtype=torch.long)
        gate = torch.gather(probs, -1, eidx)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    flat_e = eidx.reshape(B, S * top_k)
    onehot = F.one_hot(flat_e, E)  # (B, T, E)
    pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
    return Route(probs, gate, eidx, pos, pos < cap, cap)


def moe_apply(x: torch.Tensor, p: dict, *, top_k: int,
              capacity_factor: float = 1.25) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Returns (y (B, S, d) in x's dtype, aux 0-d f32)."""
    B, S, d = x.shape
    E = p["router"].shape[1]
    T = S * top_k
    r = moe_route(x, p["router"], top_k=top_k,
                  capacity_factor=capacity_factor)
    flat_e = r.eidx.reshape(B, T)
    pos_c = torch.clamp_max(r.pos, r.cap - 1)
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, T)

    # scatter each (token, choice) into (B, E, cap, d); the token per
    # choice is an expand, whose backward is a plain sum
    xr = x[:, :, None].expand(B, S, top_k, d).reshape(B, T, d)
    w = r.keep.to(x.dtype)[..., None]
    buf = torch.zeros((B, E, r.cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((b_idx, flat_e, pos_c), xr * w, accumulate=True)

    # the experts, batched over E
    up = torch.einsum("becd,edf->becf", buf, p["w_in"])
    gt = torch.einsum("becd,edf->becf", buf, p["w_gate"])
    h = F.silu(gt.to(torch.float32)).to(x.dtype) * up
    out_buf = torch.einsum("becf,efd->becd", h, p["w_out"])

    # combine: gather each (token, choice) result and mix by its gate
    yg = out_buf[b_idx, flat_e, pos_c]  # (B, T, d)
    yg = yg * w * r.gate.reshape(B, T, 1).to(x.dtype)
    y = yg.reshape(B, S, top_k, d).sum(dim=2)

    # load-balance aux loss (Shazeer): E * sum_e f_e * p_e, f_e from the
    # first choice
    density = F.one_hot(r.eidx[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    p_mean = r.probs.mean(dim=(0, 1))
    aux = E * torch.sum(density * p_mean)
    return y, aux
