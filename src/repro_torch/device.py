"""Where the port runs: the card, unless the caller asks for the CPU.

Every entry point takes ``device=`` and defaults to ``CUDA``. Asking for
the card on a host without one raises; nothing falls back to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

CUDA = torch.device("cuda")

DeviceLike = Union[torch.device, str]


def resolve_device(device: DeviceLike = CUDA) -> torch.device:
    """The device to run on; raises for CUDA on a host without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return dev


def disable_tf32() -> None:
    """Turn TF32 off for matmuls and cuDNN, process-wide.

    The plain versions of the kernels and the parity contract with the
    reference need IEEE f32 products. The port's entry points
    (``solve_dmmc``, ``chip_smoke.py``) call this once.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
