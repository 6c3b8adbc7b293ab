"""Public wrappers around the hand-written kernels.

Reference: ``repro/kernels/ops.py`` (``pairwise_sqdist`` :40,
``pairwise_dist`` :48, ``gmm_update`` :117).

Dispatch: inputs are first moved to ``device`` (CUDA unless the caller asks
for the CPU). A CPU tensor runs the plain version in ``ref.py``; a CUDA
tensor launches the kernel, or the kernel's wrapper raises. ``force="ref"``
is the one way to run the plain version on the card (the chip smoke run
and the tests compare the two with it). No environment variable picks a
path, and nothing falls back from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import gmm_step as _gmm_step
from . import pdist as _pdist
from . import ref as _ref
from ..device import CUDA, DeviceLike, resolve_device

_KERNELS = {"pairwise_sqdist": _pdist, "gmm_update": _gmm_step}


def _use_ref(t: torch.Tensor, force: Optional[str]) -> bool:
    if force not in (None, "ref"):
        raise ValueError(f"unknown force={force!r}; expected None or 'ref'")
    if force == "ref" or t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def pairwise_sqdist(x, y, *, force: Optional[str] = None,
                    device: DeviceLike = CUDA):
    """(n, d), (m, d) -> (n, m) f32 squared Euclidean distances (K1)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    if _use_ref(x, force):
        return _ref.pairwise_sqdist(x, y)
    return _pdist.pairwise_sqdist(x, y)


def pairwise_dist(x, y, *, force: Optional[str] = None,
                  device: DeviceLike = CUDA):
    return torch.sqrt(pairwise_sqdist(x, y, force=force, device=device))


def gmm_update(x, z, min_dist, valid, *, force: Optional[str] = None,
               device: DeviceLike = CUDA):
    """Fused GMM step (K2): (new_min (n,), far_idx int32, far_val f32)."""
    dev = resolve_device(device)
    x, z, min_dist, valid = (
        torch.as_tensor(t, device=dev) for t in (x, z, min_dist, valid)
    )
    if _use_ref(x, force):
        return _ref.gmm_update(x, z, min_dist, valid)
    return _gmm_step.gmm_update(x, z, min_dist, valid)


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last ``reset_launches``."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launches() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
