"""Train-step builder: microbatched gradient accumulation + AdamW.

Reference: ``repro/train/train_state.py`` (``StepConfig`` :22,
``init_train_state`` :29, ``make_train_step`` :45). ``make_train_step``
returns ``(state, batch) -> (state, metrics)``. Gradients come from
``torch.autograd.grad`` over the parameter leaves (taken as detached
views that require grad, so the state's own tensors never carry an
autograd flag). A batch is ``{"tokens"[, "img"]}``, the image embeddings
of a vlm going to ``LM.loss`` beside the tokens; with M > 1 microbatches
both are split along their first axis alike and ``g / M`` is summed in
``accum_dtype``, as the reference's scan does. The update is ``optimizer.adamw_update``, in place.
``StepConfig.skip_masked`` is passed to ``LM.loss`` as in the reference;
it changes no value, because K4 and K5 always skip the tiles the causal
mask hides.

Sharded over a data axis (FSDP; the reference's ``grad_specs`` and
launcher with ``tp=None``): ``init_train_state(..., mesh=mesh)`` places
parameters, moments and master copy by ``state_specs`` (each position
holds its slice), and ``make_train_step(..., mesh=mesh)`` runs on each
local position in turn: gather the parameters, ``LM.loss`` on the
position's rows of each microbatch (the tokens and a vlm's ``img`` split
alike; the batch is split when it divides by M x the positions, the
reference launcher's rule, else every position takes it whole), sum the
gradients into the positions' slices in position order (a
reduce-scatter) divided by the positions, in ``accum_dtype``, take the
mean of the losses, and run AdamW on the slices. That is the unsharded
step up to the order of the sums, and on one position the unsharded step
bit for bit. A MoE model on more than one position is refused: its aux
needs the expert densities summed across positions mid-forward (ROADMAP.md
step 13.5).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..device import CUDA, DeviceLike
from ..models.model import DTYPES, LM, tree_leaves, tree_map
from ..models.sharding import (
    P,
    ShardedTree,
    entry_axes,
    gather_tree,
    param_specs,
    shard_tree,
    slices_of,
    spec_leaves,
)
from .optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    accum_dtype: str = "float32"
    skip_masked: bool = False  # causal block skipping (changes no value)


def state_specs(pspecs, opt_cfg: AdamWConfig) -> dict:
    """The train state's spec tree from the parameters' (the reference
    launcher's ``sspecs``): moments and a master copy as the parameters,
    the counters replicated."""
    opt = {"m": pspecs, "v": pspecs, "step": P()}
    if opt_cfg.master_dtype is not None:
        opt["master"] = pspecs
    return {"params": pspecs, "opt": opt, "step": P()}


def _fsdp_specs(lm: LM, opt_cfg: AdamWConfig, mesh, specs):
    if specs is not None:
        return specs
    return state_specs(param_specs(lm.abstract_params(), mesh.axis_names,
                                   tp=None), opt_cfg)


def init_train_state(lm: LM, generator, opt_cfg: AdamWConfig, *,
                     device: DeviceLike = CUDA, mesh=None,
                     specs=None) -> Any:
    """{"params", "opt": {"m", "v", "step"[, "master"]}, "step"}: the
    reference's tree, with parameters from ``lm.init(generator)``. With a
    ``mesh``, a ``ShardedTree`` placed by ``specs`` (a ``state_specs``
    tree; default FSDP over every axis of the mesh): the tree is drawn
    whole on the first local position's device, as unsharded, and split."""
    if mesh is not None:
        device = mesh.devices[mesh.local_positions()[0]]
    params = lm.init(generator, device=device)
    state = {
        "params": params,
        "opt": adamw_init(params, opt_cfg),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }
    if mesh is None:
        return state
    return shard_tree(state, _fsdp_specs(lm, opt_cfg, mesh, specs), mesh,
                      donate=True)


def abstract_train_state(lm: LM, opt_cfg: AdamWConfig, *, mesh=None,
                         specs=None) -> Any:
    """The train state's tree as ``meta`` tensors (shapes and dtypes only),
    what ``CheckpointManager.restore`` fills; with a ``mesh``, each local
    position's slices (as ``init_train_state``)."""
    params = lm.abstract_params()
    mdt = DTYPES[opt_cfg.moment_dtype]

    def like(dtype):
        return tree_map(lambda p: torch.empty(p.shape, dtype=dtype,
                                              device="meta"), params)

    def step():
        return torch.empty((), dtype=torch.int32, device="meta")

    opt = {"m": like(mdt), "v": like(mdt), "step": step()}
    if opt_cfg.master_dtype is not None:
        opt["master"] = like(DTYPES[opt_cfg.master_dtype])
    state = {"params": params, "opt": opt, "step": step()}
    if mesh is None:
        return state
    return shard_tree(state, _fsdp_specs(lm, opt_cfg, mesh, specs), mesh)


def make_train_step(lm: LM, opt_cfg: AdamWConfig,
                    step_cfg: StepConfig = StepConfig(), *,
                    grad_specs=None, mesh=None,
                    force: Optional[str] = None):
    """``force="ref"`` runs the step on the plain versions of the kernels
    (forward and backward). With a ``mesh`` the step takes and returns a
    ``ShardedTree`` state on it (``init_train_state(..., mesh=mesh)``),
    whose parameter specs ``grad_specs`` (default: the state's) must be."""
    M = step_cfg.microbatches
    adt = DTYPES[step_cfg.accum_dtype]
    if mesh is None and grad_specs is not None:
        raise ValueError("grad_specs shard the gradients over a mesh: pass "
                         "mesh= (and a state placed on it)")
    if mesh is not None and mesh.size > 1 and lm.cfg.n_experts:
        raise NotImplementedError(
            f"{lm.cfg.name} on a data axis of {mesh.size}: the MoE aux "
            f"(E * sum(density * p_mean)) is taken over the whole batch, "
            f"which needs the expert densities summed across positions in "
            f"the middle of the forward (ROADMAP.md step 13.5, MoE over a "
            f"data axis); train it on one position")

    def grad_fn(params, tokens, img):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = lm.loss(live, tokens, img,
                                skip_masked=step_cfg.skip_masked,
                                force=force)
        leaves = tree_leaves(live)
        by_id = {id(t): g for t, g in
                 zip(leaves, torch.autograd.grad(loss, leaves))}
        grads = tree_map(lambda t: by_id[id(t)], live)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(state: dict, batch: dict):
        if isinstance(state, ShardedTree):
            raise ValueError("a sharded state: build the step with its "
                             "mesh (make_train_step(..., mesh=state.mesh))")
        tokens = torch.as_tensor(batch["tokens"])
        img = batch.get("img")
        params = state["params"]
        if M == 1:
            _loss, metrics, grads = grad_fn(params, tokens, img)
        else:
            B = tokens.shape[0]
            assert B % M == 0, (B, M)
            mb = B // M
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=adt, device=p.device),
                params)
            loss_acc = None
            for i in range(M):
                part = slice(i * mb, (i + 1) * mb)
                loss, _m, g = grad_fn(params, tokens[part],
                                      None if img is None else img[part])
                for a, gg in zip(tree_leaves(grads), tree_leaves(g)):
                    a.add_(gg.to(adt) / M)
                loss_acc = (loss / M if loss_acc is None
                            else loss_acc + loss / M)
            metrics = dict(ce=loss_acc, aux=torch.zeros_like(loss_acc))
        new_params, new_opt, stats = adamw_update(grads, state["opt"],
                                                  params, opt_cfg)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, dict(loss=metrics["ce"], **stats)

    if mesh is None:
        return train_step

    positions = mesh.local_positions()

    def reduce_grads(parts: list, specs: list, split: bool) -> list:
        """Each local position's slices of the positions' mean gradient:
        summed in position order in ``accum_dtype`` and divided by the
        positions where the batch is split; else (every position's
        gradient is the whole batch's) its own slices, as they are."""
        cols = [[] for _ in parts]
        for spec, leaves in zip(specs, zip(*map(tree_leaves, parts))):
            if not split:
                for col, g, p in zip(cols, leaves, positions):
                    col.append(g[slices_of(g.shape, spec, mesh, p)])
                continue
            dims = [d for d, e in enumerate(spec) if entry_axes(e)]
            red = (mesh.psum_scatter(list(leaves), entry_axes(spec[dims[0]]),
                                     dims[0], dtype=adt) if dims else
                   mesh.psum([g.to(adt) for g in leaves], mesh.axis_names))
            for col, r in zip(cols, red):
                col.append(r / mesh.size)
        return [_unflatten(parts[0], col) for col in cols]

    def sharded_step(state: ShardedTree, batch: dict):
        if not isinstance(state, ShardedTree) or state.mesh is not mesh:
            raise ValueError("this step trains a ShardedTree state on its "
                             "mesh (init_train_state(..., mesh=mesh))")
        pspecs = state.specs["params"]
        specs = spec_leaves(state.shards[0]["params"], pspecs)
        if grad_specs is not None and specs != spec_leaves(
                state.shards[0]["params"], grad_specs):
            raise ValueError("grad_specs differ from the state's "
                             "parameter specs")
        _check_fsdp(specs, mesh)
        tokens = torch.as_tensor(batch["tokens"])
        img = batch.get("img")
        B = tokens.shape[0]
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             f"microbatches")
        split = mesh.size > 1 and B % (M * mesh.size) == 0
        n = mesh.size if split else 1
        rows = B // M // n
        full = gather_tree(state["params"])
        on_dev = {state.devices[0]: full}
        for dev in state.devices:
            if dev not in on_dev:
                on_dev[dev] = tree_map(lambda t: t.to(dev), full)
        grads, loss_acc = None, None
        for i in range(M):
            parts, losses = [], []
            for p, dev in zip(positions, state.devices):
                r0 = (i * n + (mesh.shard_index(p, mesh.axis_names)
                               if split else 0)) * rows
                sl = slice(r0, r0 + rows)
                loss, m, g = grad_fn(on_dev[dev], tokens[sl],
                                     None if img is None else img[sl])
                parts.append(g)
                losses.append(m["ce"] if M == 1 else loss)
            red = reduce_grads(parts, specs, split)
            del parts
            loss_i = (mesh.psum(losses, mesh.axis_names)[0] / n if split
                      else losses[0])
            if M == 1:
                grads, loss_acc = red, loss_i
                continue
            if grads is None:
                grads = [tree_map(lambda t: torch.zeros(
                    t.shape, dtype=adt, device=t.device), r) for r in red]
            for a, r in zip(grads, red):
                for x, y in zip(tree_leaves(a), tree_leaves(r)):
                    x.add_(y.to(adt) / M)
            loss_acc = (loss_i / M if loss_acc is None
                        else loss_acc + loss_i / M)
        del full, on_dev
        g_tree = ShardedTree(mesh, pspecs, grads)
        new_params, new_opt, stats = adamw_update(
            g_tree, state["opt"], state["params"], opt_cfg)
        steps = ShardedTree(mesh, state.specs["step"],
                            [s["step"] + 1 for s in state.shards])
        new_state = ShardedTree.join({"params": new_params, "opt": new_opt,
                                      "step": steps})
        return new_state, dict(loss=loss_acc, **stats)

    return sharded_step


def _unflatten(like, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    order = {id(t): i for i, t in enumerate(tree_leaves(like))}
    return tree_map(lambda t: leaves[order[id(t)]], like)


def _check_fsdp(specs: list, mesh) -> None:
    """The step trains FSDP: a leaf is whole or split along one dim over
    every axis of the mesh of size > 1 (tensor parallelism is step
    13.6)."""
    busy = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
    for spec in specs:
        dims = [e for e in spec if entry_axes(e)]
        if not dims:
            continue
        named = tuple(a for a in entry_axes(dims[0]) if mesh.shape[a] > 1)
        if len(dims) > 1 or named != busy:
            raise NotImplementedError(
                f"spec {spec} on mesh {mesh.shape}: the train step shards "
                f"a leaf along one dim over every data axis (FSDP); tensor "
                f"parallel training is ROADMAP.md step 13.6")

