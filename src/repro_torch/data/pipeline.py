"""Deterministic, seekable data pipeline with DMMC-based diverse batch
selection (the paper's technique as a training feature).

Reference: ``repro/data/pipeline.py`` (``DataConfig`` :30,
``_candidate_pool`` :43, ``_diverse_pick`` :63, ``Pipeline`` :100). Each
step draws a candidate pool of ``candidates_per_batch * global_batch``
sequences with a domain and an embedding each, builds a partition matroid
over the domains (balance caps), runs SeqCoreset on the device (GMM on
K2, the EXTRACT mask and ``compress`` in torch) and picks the batch from
the coreset farthest-first under the caps.

The reference's ``_candidate_pool`` is split in two here:

* ``candidate_pool``: the port's own pool, the reference's formula for
  domains, tokens and embeddings drawn from a ``torch.Generator`` on the
  device seeded from (seed, step), so a restart at step s reproduces the
  stream (seekable). ``jax.random`` streams cannot be reproduced in torch,
  so the pool differs from the reference's by design.
* ``diverse_pick``: the counterpart of ``_diverse_pick``, held to it on
  the same input by the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.coreset import seq_coreset
from ..core.matroid import MatroidSpec
from ..device import CUDA, DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    num_domains: int = 16
    candidates_per_batch: int = 4  # pool = candidates_per_batch * batch
    embed_dim: int = 32
    selector_tau: int = 32
    seed: int = 0
    diverse_selection: bool = True


def _generator(seed: int, stream: int, dev: torch.device) -> torch.Generator:
    """A generator for (seed, stream): the 64-bit seed keeps the two apart,
    so no two (seed, step) pairs share a stream."""
    mixed = ((seed & 0x7FFFFFFF) << 32) | (stream & 0xFFFFFFFF)
    return torch.Generator(device=dev).manual_seed(mixed)


def candidate_pool(cfg: DataConfig, step: int, *,
                   device: DeviceLike = CUDA):
    """The step's pool: (tokens int32 (C, S), domains int32 (C,), emb f32
    (C, embed_dim)), C = candidates_per_batch * global_batch."""
    dev = resolve_device(device)
    g = _generator(cfg.seed, step, dev)
    C = cfg.global_batch * cfg.candidates_per_batch
    domains = torch.randint(0, cfg.num_domains, (C,), generator=g,
                            device=dev)
    # domain-conditioned token distribution (unigram shift per domain)
    shift = domains[:, None] * (cfg.vocab // cfg.num_domains)
    tokens = (torch.randint(0, cfg.vocab // 2, (C, cfg.seq_len), generator=g,
                            device=dev) + shift // 2) % cfg.vocab
    # cheap embedding: domain centres (one draw per seed) plus noise
    centers = torch.randn(cfg.num_domains, cfg.embed_dim,
                          generator=_generator(cfg.seed, 2**32 - 1, dev),
                          device=dev)
    emb = centers[domains] + 0.3 * torch.randn(C, cfg.embed_dim, generator=g,
                                               device=dev)
    return tokens.to(torch.int32), domains.to(torch.int32), emb


def diverse_pick(points: torch.Tensor, cats: torch.Tensor,
                 caps: torch.Tensor, k: int, tau: int, h: int,
                 cap_total: int, *, force: Optional[str] = None
                 ) -> torch.Tensor:
    """SeqCoreset + greedy farthest-first selection under partition caps.

    points (n, d) f32, cats (n, 1), caps (h,) on one device. Returns
    indices (k,) int32 into points: each pick is the coreset point of the
    largest distance to the picks so far (the first index on ties) whose
    domain is under its cap (with nothing left, the first coreset slot,
    as in the reference). Runs on the points' device with no host round
    trip but GMM's loop bound.
    """
    dev = points.device
    n = points.shape[0]
    spec = MatroidSpec("partition", num_categories=h, gamma=1)
    cs, _res, _ovf = seq_coreset(
        points, cats, torch.ones((n,), dtype=torch.bool, device=dev), spec,
        caps, k, tau, cap=cap_total, force=force, device=dev)
    m = cs.points.shape[0]
    big = 1e30
    c = cs.cats[:, 0].to(torch.int64)
    caps_c = caps.to(torch.int64)[c]
    chosen = torch.zeros((k,), dtype=torch.int32, device=dev)
    counts = torch.zeros((h,), dtype=torch.int64, device=dev)
    min_d = torch.full((m,), big, dtype=torch.float32, device=dev)
    for i in range(k):
        ok = cs.valid & (counts[c] < caps_c) & (min_d > -1.0)
        score = torch.where(ok, min_d, -big)
        j = torch.argmax(score).view(1)  # the first maximum
        chosen[i:i + 1] = cs.src_idx.index_select(0, j)
        counts.index_add_(0, c.index_select(0, j),
                          torch.ones((1,), dtype=torch.int64, device=dev))
        diff = cs.points - cs.points.index_select(0, j)
        d = torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0))
        min_d = torch.minimum(min_d, d)
        min_d.index_fill_(0, j, -2.0)  # never pick it again
    return chosen


class Pipeline:
    """step -> batch dict. Stateless with respect to the step (seekable)."""

    def __init__(self, cfg: DataConfig, *, force: Optional[str] = None,
                 device: DeviceLike = CUDA):
        self.cfg = cfg
        self.force = force
        self.device = resolve_device(device)
        h = cfg.num_domains
        B = cfg.global_batch
        # balance caps: ceil(B / h) * 2 slack
        self.caps = torch.full((h,), max(1, (B + h - 1) // h * 2),
                               dtype=torch.int32, device=self.device)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        tokens, domains, emb = candidate_pool(cfg, step, device=self.device)
        if cfg.diverse_selection:
            idx = diverse_pick(
                emb, domains[:, None], self.caps, cfg.global_batch,
                cfg.selector_tau, cfg.num_domains,
                cap_total=cfg.global_batch * cfg.selector_tau,
                force=self.force)
            idx = torch.clamp_min(idx, 0).long()
        else:
            idx = torch.arange(cfg.global_batch, device=self.device)
        return {"tokens": tokens[idx], "domains": domains[idx], "step": step}
