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

Sharded (FSDP: grads, state and params as ``models.sharding.ShardedTree``s
on one mesh): the clip norm is the square root of the mesh's sum of each
position's sum of squares (a slice that several positions hold counted
once), and each position updates its own slices in place. The decay mask
is still the leaf's rank, which a slice keeps.

A stacked segment's leaf can be large (mamba2-2.7b's stacked ``in_proj``
is 1.7 B entries: 6.9 GB for each f32 temporary), so the update and the
norm walk a leaf of more than ``_SLICE_ELEMS`` entries in slices along
its first (the stacked) axis. The update is elementwise, so slicing
changes no bit of it; the norm sums the slices' sums of squares in order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..models.model import DTYPES, tree_leaves, tree_map
from ..models.sharding import ShardedTree, entry_axes, spec_leaves


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


_SLICE_ELEMS = 2**28  # entries of a leaf's f32 temporaries at a time


def _slices(t: torch.Tensor) -> list:
    """Indices of slices along ``t``'s first axis, each with at most
    ``_SLICE_ELEMS`` entries (one row at least); the whole tensor if it is
    small enough."""
    if t.numel() <= _SLICE_ELEMS:
        return [...]
    rows = max(1, _SLICE_ELEMS // max(1, t[0].numel()))
    return [slice(r, r + rows) for r in range(0, t.shape[0], rows)]


def _sum_squares(leaves: list, dev: torch.device) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for leaf in leaves:
        for sl in _slices(leaf):
            total = total + torch.sum(leaf[sl].to(torch.float32) ** 2)
    return total


def _counted(spec, mesh, position: int) -> bool:
    """Whether ``position`` adds a leaf of ``spec`` to the norm: each
    slice once, so of the positions holding the same slice (those that
    differ only along axes the spec does not name) the first."""
    named = {a for e in spec for a in entry_axes(e)}
    coords = dict(zip(mesh.axis_names, mesh.coords(position)))
    return all(coords[a] == 0 for a in mesh.axis_names if a not in named)


def _sharded_norms(tree: ShardedTree) -> list[torch.Tensor]:
    """The global norm of a sharded tree, one copy a local position: the
    square root of the mesh's sum of each position's sum of squares."""
    mesh = tree.mesh
    specs = spec_leaves(tree.shards[0], tree.specs)
    parts = [_sum_squares([leaf for leaf, spec in zip(tree_leaves(shard),
                                                      specs)
                           if _counted(spec, mesh, p)], dev)
             for p, dev, shard in zip(tree.positions, tree.devices,
                                      tree.shards)]
    return [torch.sqrt(t) for t in mesh.psum(parts, mesh.axis_names)]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (0-d tensor); of a
    ``ShardedTree``, over the whole tree (on its first local device)."""
    if isinstance(tree, ShardedTree):
        return _sharded_norms(tree)[0]
    leaves = tree_leaves(tree)
    return torch.sqrt(_sum_squares(leaves, leaves[0].device))


@torch.no_grad()
def adamw_update(grads: Any, state: Any, params: Any,
                 cfg: AdamWConfig) -> tuple[Any, Any, dict]:
    """Returns (params, state, stats); params and the moments are updated
    in place and returned, ``state["step"]`` is a new 0-d int32 tensor.
    Sharded (``ShardedTree`` grads, state and params on one mesh): the
    clip norm is the whole tree's, and each position updates its own
    slices; stats come from the first local position."""
    if not isinstance(params, ShardedTree):
        return _update(grads, state, params, cfg, global_norm(grads))
    outs = [_update(g, s, p, cfg, gn) for g, s, p, gn in zip(
        grads.shards, state.shards, params.shards, _sharded_norms(grads))]
    return (params, ShardedTree(state.mesh, state.specs,
                                [o[1] for o in outs]), outs[0][2])


def _update(grads: Any, state: dict, params: Any, cfg: AdamWConfig,
            gnorm: torch.Tensor) -> tuple[Any, dict, dict]:
    step = state["step"] + 1
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
        decay = out.dim() >= 2
        for sl in _slices(out):
            gs = g[sl].to(f32) * scale
            mf = m[sl].to(f32) * b1 + gs * (1 - b1)
            vf = v[sl].to(f32) * b2 + gs * gs * (1 - b2)
            mhat = mf / bc1
            vhat = vf / bc2
            pf = src[sl].to(f32)
            upd = mhat / (torch.sqrt(vhat) + cfg.eps)
            if decay:
                upd = upd + cfg.weight_decay * pf
            pf = pf - lr * upd
            out[sl].copy_(pf)
            if mst is not None:
                mst[sl].copy_(pf)
            m[sl].copy_(mf)
            v[sl].copy_(vf)
    new_state = dict(state, step=step)
    return params, new_state, dict(grad_norm=gnorm, lr=lr)
