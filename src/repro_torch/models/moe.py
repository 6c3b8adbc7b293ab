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

``moe_apply`` is three parts that the sharded train step also uses on
their own (ROADMAP.md steps 13.5 and 13.9): ``moe_route``; ``moe_experts``,
which runs the experts a position holds, ``[first, first + n)`` of E, on
the (token, choice) pairs routed to them and gives zero for the others
(the whole stack on one position); and ``load_balance_aux`` from
first-choice counts handed in. The counts are f32 sums of 0/1 below
2^24, so summing them across data positions is exact in any order.
``Routes`` records each MoE layer's experts and counts in a first
(no-gradient) forward and replays them in a second, where the counts of
every data position's rows have been summed in between: the reference's
aux over the whole (micro)batch, with each position's own ``p_mean``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

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


def first_counts(eidx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(E,) f32: the tokens of a (B, S, k) route whose first choice is
    each expert; exact below 2^24 tokens."""
    return F.one_hot(eidx[..., 0], n_experts).to(torch.float32).sum(
        dim=(0, 1))


def load_balance_aux(probs: torch.Tensor, counts: torch.Tensor,
                     n_tokens: int) -> torch.Tensor:
    """The Shazeer aux, E * sum_e f_e * p_e: f the first-choice ``counts``
    over ``n_tokens`` (the whole (micro)batch's, which may span data
    positions), p the mean of ``probs`` (B, S, E) over these tokens."""
    density = counts / n_tokens
    p_mean = probs.mean(dim=(0, 1))
    return probs.shape[-1] * torch.sum(density * p_mean)


def moe_experts(x: torch.Tensor, p: dict, r: Route,
                first: int = 0) -> torch.Tensor:
    """The experts of ``p`` (a stack of n: experts ``[first, first + n)``
    of the route's E) applied to the (token, choice) pairs ``r`` routes to
    them and kept, each mixed by its ``r.gate``; (B, S, d) in x's dtype,
    with zero for the pairs routed to other experts. Only the stack's
    slots are filled and only its products run. With the whole stack it is
    the reference's dispatch, products and combine."""
    B, S, d = x.shape
    top_k = r.eidx.shape[-1]
    T = S * top_k
    n = p["w_in"].shape[0]
    flat_e = r.eidx.reshape(B, T)
    keep = r.keep
    if first or n != r.probs.shape[-1]:
        # another position's pairs add zero, to a slot of expert `first`
        flat_e = flat_e - first
        own = (flat_e >= 0) & (flat_e < n)
        keep = keep & own
        flat_e = torch.where(own, flat_e, 0)
    pos_c = torch.clamp_max(r.pos, r.cap - 1)
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, T)

    # scatter each (token, choice) into (B, n, cap, d); the token per
    # choice is an expand, whose backward is a plain sum
    xr = x[:, :, None].expand(B, S, top_k, d).reshape(B, T, d)
    w = keep.to(x.dtype)[..., None]
    buf = torch.zeros((B, n, r.cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((b_idx, flat_e, pos_c), xr * w, accumulate=True)

    # the experts, batched over the stack
    up = torch.einsum("becd,edf->becf", buf, p["w_in"])
    gt = torch.einsum("becd,edf->becf", buf, p["w_gate"])
    h = F.silu(gt.to(torch.float32)).to(x.dtype) * up
    out_buf = torch.einsum("becf,efd->becd", h, p["w_out"])

    # combine: gather each (token, choice) result and mix by its gate
    yg = out_buf[b_idx, flat_e, pos_c]  # (B, T, d)
    yg = yg * w * r.gate.reshape(B, T, 1).to(x.dtype)
    return yg.reshape(B, S, top_k, d).sum(dim=2)


class Routes:
    """The routes of one batch's MoE layers, by layer key: recorded by a
    first forward (``eidx``: each layer's (B, S, k) experts; ``counts``:
    its (E,) first-choice counts) and replayed by a second, which takes
    the aux's density from ``total`` (the counts summed over the data
    positions, over ``n_tokens`` tokens) once ``set_total`` has set it."""

    def __init__(self):
        self.eidx: dict = {}
        self.counts: dict = {}
        self.total: Optional[dict] = None
        self.n_tokens: Optional[int] = None

    def stacked_counts(self) -> torch.Tensor:
        """(layers, E): the recorded counts in key order."""
        return torch.stack([self.counts[k] for k in sorted(self.counts)])

    def set_total(self, total: torch.Tensor, n_tokens: int) -> None:
        """``total``: ``stacked_counts`` summed over the data positions."""
        self.total = dict(zip(sorted(self.counts), total))
        self.n_tokens = int(n_tokens)


def route_layer(x: torch.Tensor, router: torch.Tensor, *, top_k: int,
                capacity_factor: float, routes: Optional[Routes] = None,
                key=None) -> tuple[Route, torch.Tensor, int]:
    """One MoE layer's route and its aux's (counts, tokens). Without
    ``routes``, the layer's own; with them, the experts recorded under
    ``key`` replayed (recorded first if there are none) and the counts
    summed over the data positions once they are set."""
    B, S = x.shape[:2]
    E = router.shape[1]
    if routes is None:
        r = moe_route(x, router, top_k=top_k, capacity_factor=capacity_factor)
        return r, first_counts(r.eidx, E), B * S
    if key in routes.eidx:
        r = moe_route(x, router, top_k=top_k, capacity_factor=capacity_factor,
                      eidx=routes.eidx[key])
    else:
        r = moe_route(x, router, top_k=top_k, capacity_factor=capacity_factor)
        routes.eidx[key] = r.eidx
        routes.counts[key] = first_counts(r.eidx, E)
    if routes.total is None:
        return r, routes.counts[key], B * S
    return r, routes.total[key].to(x.device), routes.n_tokens


def moe_apply(x: torch.Tensor, p: dict, *, top_k: int,
              capacity_factor: float = 1.25, routes: Optional[Routes] = None,
              key=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, d) in x's dtype, aux 0-d f32); ``routes`` and
    ``key`` as ``route_layer``'s."""
    r, counts, n_tokens = route_layer(x, p["router"], top_k=top_k,
                                      capacity_factor=capacity_factor,
                                      routes=routes, key=key)
    y = moe_experts(x, p, r)
    # load-balance aux loss (Shazeer), f from the first choice
    return y, load_balance_aux(r.probs, counts, n_tokens)
