"""Coreset construction of the sequential setting (paper §3.1 + Alg. 1).

Reference: ``repro/core/coreset.py`` (``Coreset``, ``default_capacity``,
``seq_coreset_host`` :167). ``seq_coreset_host`` is the paper's Algorithm
1 verbatim: GMM on the device (K2), then the numpy EXTRACT (exact Kuhn
matching for transversal U_i + category top-up, and the general-matroid
fallback T_i = C_i) over the cluster assignment, which is the only array
that crosses to the host.

``seq_coreset`` is the reference's jit SeqCoreset (:136):
``extraction_mask`` (:71, uniform and partition) and ``compress`` (:97)
run in torch on the points' device after GMM on K2, and nothing crosses
to the host but GMM's loop bound. The transversal mask and
``concat_coresets`` come with the MapReduce slice (ROADMAP.md step 11).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import CUDA, DeviceLike, resolve_device
from . import geometry
from .gmm import GMMResult, gmm
from .matroid import (
    Matroid,
    MatroidSpec,
    make_host_matroid,
    partition_extract_mask,
    rank_in_group,
)


class Coreset(NamedTuple):
    points: torch.Tensor  # f32[cap, d]
    cats: torch.Tensor  # int32[cap, gamma]
    valid: torch.Tensor  # bool[cap]
    src_idx: torch.Tensor  # int32[cap] index into the original dataset (-1 pad)

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def size(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int32))


def default_capacity(spec: MatroidSpec, k: int, tau: int) -> int:
    """Static buffer capacity per construction (Thms 1/2 size bounds)."""
    if spec.kind in ("uniform", "partition"):
        return k * tau  # exact upper bound (Thm 1)
    if spec.kind == "transversal":
        # the matching-free jit rule keeps min(k, count) points of EVERY
        # category present in a cluster -> per-cluster bound is k * h (the
        # paper's Thm-2 set with exact matching is the tighter gamma*k^2;
        # the host construction achieves it). Cap the buffer accordingly.
        per_cluster = k * max(
            min(spec.num_categories, 4 * max(spec.gamma, 1) * k * k), 1
        )
        return min(per_cluster, k * max(spec.num_categories, 1)) * tau
    # general matroids can degenerate to whole clusters; host path only.
    raise ValueError(f"no static capacity for matroid kind {spec.kind!r}")


def extraction_mask(
    spec: MatroidSpec,
    assign: torch.Tensor,
    cats: torch.Tensor,
    caps: Optional[torch.Tensor],
    valid: torch.Tensor,
    k: int,
    tau: int,
) -> torch.Tensor:
    """Per-point keep mask implementing EXTRACT (uniform, partition)."""
    if spec.kind == "uniform":
        # the unconstrained diversity coreset: k points per cluster
        return valid & (rank_in_group(assign, valid, tau) < k)
    if spec.kind == "partition":
        return partition_extract_mask(assign, cats, caps, valid, k, tau,
                                      spec.num_categories)
    if spec.kind == "transversal":
        raise NotImplementedError(
            "the device EXTRACT of a transversal matroid is not ported yet: "
            "ROADMAP.md step 11 (use seq_coreset_host)")
    raise ValueError(f"device EXTRACT not defined for {spec.kind!r}")


def compress(
    points: torch.Tensor,
    cats: torch.Tensor,
    mask: torch.Tensor,
    cap: int,
    base_index: Optional[torch.Tensor] = None,
) -> Coreset:
    """The first ``cap`` masked rows, in index order, packed into a
    fixed-capacity Coreset (-1 / 0 fill), with no host round trip."""
    n = mask.shape[0]
    dev = mask.device
    pos = torch.cumsum(mask.to(torch.int64), dim=0) - 1
    slot = torch.where(mask & (pos < cap), pos, cap)  # cap: a discard slot
    idx = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev)
    idx.scatter_(0, slot, torch.arange(n, dtype=torch.int64, device=dev))
    idx = idx[:cap]
    valid = idx >= 0
    safe = torch.clamp_min(idx, 0)
    src = idx if base_index is None else torch.where(valid, base_index + idx,
                                                     -1)
    return Coreset(
        points=torch.where(valid[:, None], points[safe], 0.0),
        cats=torch.where(valid[:, None], cats[safe], -1).to(torch.int32),
        valid=valid,
        src_idx=src.to(torch.int32),
    )


def seq_coreset(
    points,  # (n, d) metric-normalized
    cats,  # (n, gamma)
    valid,  # (n,)
    spec: MatroidSpec,
    caps,  # (h,) or None
    k: int,
    tau: int,
    *,
    eps: float = 0.0,
    use_radius_target: bool = False,
    cap: Optional[int] = None,
    base_index: Optional[torch.Tensor] = None,
    force: Optional[str] = None,
    device: DeviceLike = CUDA,
) -> tuple[Coreset, GMMResult, torch.Tensor]:
    """SeqCoreset on the device. Returns (coreset, gmm_result,
    overflow_count); overflow_count > 0 means ``cap`` was too small for
    the selection (never for partition/uniform at the default capacity).
    """
    dev = resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    cats = torch.as_tensor(cats, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    if caps is not None:
        caps = torch.as_tensor(caps, device=dev)
    res = gmm(points, valid, tau_max=tau, k=k, eps=eps,
              use_radius_target=use_radius_target, force=force, device=dev)
    mask = extraction_mask(spec, res.assign, cats, caps, valid, k, tau)
    cap_ = cap if cap is not None else default_capacity(spec, k, tau)
    cs = compress(points, cats, mask, cap_, base_index)
    overflow = torch.clamp_min(torch.sum(mask.to(torch.int32)) - cap_, 0)
    return cs, res, overflow


def _cats_2d(cats: Optional[np.ndarray], n: int) -> np.ndarray:
    if cats is None:
        return np.zeros((n, 1), np.int32)
    cats_np = np.asarray(cats, np.int32)
    return cats_np[:, None] if cats_np.ndim == 1 else cats_np


def extract_host(
    res: GMMResult,
    cats: Optional[np.ndarray],
    spec: MatroidSpec,
    caps: Optional[np.ndarray],
    k: int,
    oracle=None,
) -> tuple[np.ndarray, dict]:
    """EXTRACT of Algorithm 1 over a GMM clustering (any device).

    Returns (selected indices into S, info dict), as ``seq_coreset_host``.
    """
    assign = res.assign.cpu().numpy()
    n = assign.shape[0]
    num_centers = int(res.num_centers)
    cats_np = _cats_2d(cats, n)
    matroid: Matroid = make_host_matroid(spec, cats_np, caps, n, k, oracle)

    selected: list[int] = []
    for c in range(num_centers):
        members = np.flatnonzero(assign == c)
        u = matroid.greedy_independent(members.tolist(), k)  # largest <= k
        if spec.kind in ("uniform", "partition") or len(u) == k:
            t_i = list(u)
        elif spec.kind == "transversal":
            # top-up: min(k, |A ∩ C_i|) points of every category A of U_i
            t_i = list(u)
            chosen = set(u)
            a_prime = {
                int(a) for x in u for a in cats_np[x] if a >= 0
            }
            counts = {a: 0 for a in a_prime}
            for x in t_i:
                for a in cats_np[x]:
                    if int(a) in counts:
                        counts[int(a)] += 1
            for x in members:
                x = int(x)
                if x in chosen:
                    continue
                want = [
                    int(a) for a in cats_np[x]
                    if int(a) in counts and counts[int(a)] < k
                ]
                if want:
                    t_i.append(x)
                    chosen.add(x)
                    for a in cats_np[x]:
                        if int(a) in counts:
                            counts[int(a)] += 1
        else:  # general matroid: keep whole cluster when |U_i| < k (Thm 3)
            t_i = members.tolist()
        selected.extend(int(x) for x in t_i)

    info = dict(
        tau=num_centers,
        radius=float(res.radius),
        delta=float(res.delta),
        size=len(selected),
        centers=res.centers[:num_centers].cpu().numpy(),
    )
    return np.asarray(sorted(set(selected)), np.int64), info


def seq_coreset_host(
    points,
    cats: Optional[np.ndarray],
    spec: MatroidSpec,
    caps: Optional[np.ndarray],
    k: int,
    *,
    eps: Optional[float] = None,
    tau: Optional[int] = None,
    tau_max: int = 4096,
    metric: geometry.Metric = "euclidean",
    oracle=None,
    force: Optional[str] = None,
    device: DeviceLike = CUDA,
) -> tuple[np.ndarray, dict]:
    """Algorithm 1 verbatim. Returns (selected indices into S, info dict).

    Exactly one of eps / tau must be given (radius-target vs fixed-tau
    mode). Beyond the reference's keys, ``info`` holds the GMM centers in
    the order chosen (``centers``) and the seconds spent in GMM on the
    device and in the host EXTRACT (``gmm_s``, ``extract_s``).
    """
    if (eps is None) == (tau is None):
        raise ValueError("give exactly one of eps / tau")
    dev = resolve_device(device)
    pts = geometry.normalize_for_metric(
        torch.as_tensor(points, dtype=torch.float32, device=dev), metric
    )
    n = pts.shape[0]
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    t0 = time.perf_counter()
    if eps is not None:
        res = gmm(pts, valid, tau_max=min(tau_max, n), k=k, eps=eps,
                  use_radius_target=True, force=force, device=dev)
    else:
        res = gmm(pts, valid, tau_max=min(tau, n), force=force, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # EXTRACT's host copy would wait anyway
    t1 = time.perf_counter()
    idx, info = extract_host(res, cats, spec, caps, k, oracle)
    info.update(gmm_s=t1 - t0, extract_s=time.perf_counter() - t1)
    return idx, info
