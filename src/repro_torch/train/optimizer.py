"""AdamW on the port's parameter trees.

Reference: ``repro/train/optimizer.py`` (``AdamWConfig`` :21, ``lr_at``
:37, ``adamw_init`` :51, ``global_norm`` :65, ``adamw_update`` :72). The
arithmetic is the reference's: global-norm clipping in f32, moments in
``moment_dtype``, the update on an f32 compute path rounded to the
parameter's dtype (or kept in an f32 ``master`` copy). The step-dependent
scalars (learning rate, bias corrections) are 0-d f32 tensors on the
parameters' device, so a step reads nothing back to the host.

Unlike the reference, ``adamw_update`` writes the new parameters and
moments into the tensors it is given (in place, under ``torch.no_grad``),
which saves a copy of the model and of both moments each step; it
returns the same trees. Weight decay applies where ``p.ndim >= 2``, the
reference's mask: a stacked segment's RMSNorm gain, shape (count, d), is
decayed, while ``final_norm`` (d,) is not. Kept as it is for parity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..models.model import DTYPES, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    master_dtype: Optional[str] = None  # "float32" to keep a master copy
    warmup_steps: int = 100
    schedule: str = "cosine"  # cosine | constant
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), 0-d f32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max((s + 1.0) / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    mdt = DTYPES[cfg.moment_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    dev = tree_leaves(params)[0].device
    state = {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if cfg.master_dtype is not None:
        state["master"] = tree_map(
            lambda p: p.detach().to(DTYPES[cfg.master_dtype]).clone(),
            params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-d tensor)."""
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Any, state: dict, params: Any,
                 cfg: AdamWConfig) -> tuple[Any, dict, dict]:
    """Returns (params, state, stats); params and the moments are updated
    in place and returned, ``state["step"]`` is a new 0-d int32 tensor."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=sf.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=sf.device), sf)
    master = state.get("master")
    srcs = tree_leaves(master if master is not None else params)
    outs = tree_leaves(params)
    masters = tree_leaves(master) if master is not None else [None] * len(outs)
    f32 = torch.float32
    for src, out, mst, g, m, v in zip(srcs, outs, masters,
                                      tree_leaves(grads),
                                      tree_leaves(state["m"]),
                                      tree_leaves(state["v"])):
        g = g.to(f32) * scale
        mf = m.to(f32) * b1 + g * (1 - b1)
        vf = v.to(f32) * b2 + g * g * (1 - b2)
        mhat = mf / bc1
        vhat = vf / bc2
        pf = src.to(f32)
        upd = mhat / (torch.sqrt(vhat) + cfg.eps)
        if out.dim() >= 2:
            upd = upd + cfg.weight_decay * pf
        pf = pf - lr * upd
        out.copy_(pf)
        if mst is not None:
            mst.copy_(pf)
        m.copy_(mf)
        v.copy_(vf)
    new_state = dict(state, step=step)
    return params, new_state, dict(grad_norm=gnorm, lr=lr)
