"""Gonzalez farthest-first traversal (GMM) — the paper's clustering engine.

Reference: ``repro/core/gmm.py`` (``gmm`` :42, ``gmm_fixed``,
``gmm_radius``). Two stopping rules, both from the paper:

* **radius-target** (Alg. 1): iterate until the clustering radius drops to
  ``eps * delta / (16 k)`` where ``delta = d(z1, z2) in [Delta/2, Delta]``;
* **fixed tau** (the experiments' knob): run exactly ``tau`` iterations.

Each added center is one launch of the fused step ``kernels.ops.gmm_update``
(K2): distance to the new center, running min, and the argmax that picks
the next center, in one read of the point matrix. The reference's
``lax.while_loop`` becomes a Python loop of launches; the state stays on
the device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import CUDA, DeviceLike, resolve_device
from ..kernels import ops


class GMMResult(NamedTuple):
    centers: torch.Tensor  # int32[tau_max] point indices, -1 padded
    num_centers: int
    assign: torch.Tensor  # int32[n] cluster id (position in `centers`)
    min_dist: torch.Tensor  # f32[n] distance to own center
    radius: torch.Tensor  # f32 scalar (over valid points)
    delta: torch.Tensor  # f32 scalar, d(z1, z2) in [Delta/2, Delta]


def gmm(
    points,  # (n, d), already metric-normalized
    valid,  # (n,) bool
    tau_max: int,
    *,
    k: int = 1,
    eps: float = 0.0,
    use_radius_target: bool = False,
    force: Optional[str] = None,
    device: DeviceLike = CUDA,
) -> GMMResult:
    """Farthest-first traversal with masked (padded) inputs.

    With ``use_radius_target``: stop at radius <= eps * delta / (16 k)
    (Alg. 1 line: ``while r(C, Z) > eps*delta/(16k)``), capped at tau_max.
    Otherwise: run to exactly min(tau_max, #valid) centers.
    """
    dev = resolve_device(device)
    points = torch.as_tensor(points, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    n = points.shape[0]
    n_valid = int(valid.sum())  # the loop bound: read once
    has_any = n_valid > 0
    anchor = torch.argmax(valid.to(torch.int32)).view(1)  # first valid (z1)

    def step(center_idx, min_dist):
        z = points.index_select(0, center_idx).view(-1)
        return ops.gmm_update(points, z, min_dist, valid, force=force,
                              device=dev)

    inf = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    min_dist, nxt, delta = step(anchor, inf)
    centers = torch.full((tau_max,), -1, dtype=torch.int32, device=dev)
    centers[:1] = anchor
    assign = torch.zeros((n,), dtype=torch.int32, device=dev)
    if use_radius_target:
        target = torch.tensor(eps, dtype=torch.float32, device=dev) * delta
        target = target / (16.0 * k)
    radius = delta

    t = 1
    while t < min(tau_max, n_valid):
        # fixed tau needs no device read (radius > -1 holds for any valid
        # point); radius-target reads the radius once per iteration for the
        # stopping test, one small sync per added center
        if use_radius_target and not bool(radius > target):
            break
        centers[t:t + 1] = nxt
        new_min, nxt, radius = step(nxt.view(1), min_dist)
        assign.masked_fill_(new_min < min_dist, t)  # strict, as the reference
        min_dist = new_min
        t += 1

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return GMMResult(
        centers=centers,
        num_centers=t if has_any else 0,
        assign=assign,
        min_dist=min_dist,
        radius=torch.clamp_min(radius, 0.0) if has_any else zero,
        delta=delta if has_any else zero,
    )


def gmm_fixed(points, valid, tau: int, *, force: Optional[str] = None,
              device: DeviceLike = CUDA) -> GMMResult:
    """Experiments' knob: exactly tau clusters (Section 5 parameterization)."""
    return gmm(points, valid, tau_max=tau, force=force, device=device)


def gmm_radius(points, valid, k: int, eps: float, tau_max: int, *,
               force: Optional[str] = None,
               device: DeviceLike = CUDA) -> GMMResult:
    """Alg. 1 stopping rule: radius <= eps*delta/(16k), capped at tau_max."""
    return gmm(
        points, valid, tau_max=tau_max, k=k, eps=eps, use_radius_target=True,
        force=force, device=device,
    )
