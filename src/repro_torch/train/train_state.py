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
bit for bit.

A MoE model over a data axis (ROADMAP.md step 13.5 item 1): the
reference's aux, ``E * sum(density * p_mean)``, is taken over the whole
(micro)batch, and the density of layer l needs every position's routes
at layer l. Only the density crosses positions, and it has no gradient;
so, with the positions' rows equal, the mean over positions of ``E *
sum(density_global * p_mean_own)`` is the reference's aux, and the ``/
n`` reduce gives its gradient. Each microbatch, where its rows split over
the positions, first runs a routing pass (``LM.route``: the blocks
without gradients, no head) on every position's rows, recording each MoE
layer's experts and first-choice counts; sums the counts over the data
positions in position order (``mesh.psum``, one all-reduce of (MoE
layers, E) f32 counts, exact in any order); then runs each position's
gradient pass replaying those routes with the summed density, so that
the checkpointed blocks' recompute routes as the first pass did. Where
the batch does not split, each position's counts are already the whole
batch's and nothing is summed.

Tensor parallel over a ("data", "model") mesh (ROADMAP.md step 13.7; the
reference's ``grad_specs=param_specs(..., tp="model")``): where the specs
split a leaf over the model axis alone, each position gathers its model
slices over the data axes only (``sharding.gather_over``), and each data
row in turn runs one forward and backward over its model positions
(``LM.tp_loss``: one autograd graph over the row's positions in process,
a rank's own position across ranks). The gradients are reduce-scattered
over the data axes only, along the dim the data axes split (embed's spec
is ``(model, data)``); a leaf that the data axes do not split is summed
over them only: one the model axis does not split either (a norm) is one
gradient on every model position, not partial sums, and one it splits
alone (a Mamba2 block's ``conv_w``, ``conv_b``, ``A_log``, ``D``,
``dt_bias`` and gated ``norm``) stays the position's model slice. Every
family trains so: a moe's experts split over the model axis (ROADMAP.md
step 13.9, ``models.model._tp_moe_sub``) and its routing pass per data
row (``LM.tp_route``), a Mamba2 block's heads split over it (step 13.8,
``models.mamba.tp_mamba_apply``), a vlm's cross attention on each
position's heads with the data row's image rows (step 13.10), and the
attention heads split over any model axis, ``wk`` and ``wv`` regrouped
where it does not divide ``n_kv`` (step 13.11,
``models.model.head_range``). A model axis that does not divide
``n_experts`` or the Mamba heads raises naming the rule, and a leaf the
specs cannot split evenly is refused where the state is placed. A model
axis of 1 is the FSDP step bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..device import CUDA, DeviceLike
from ..launch.mesh import ModelGroup
from ..models.model import (
    DTYPES,
    LM,
    check_tensor_parallel,
    tree_leaves,
    tree_map,
)
from ..models.sharding import (
    TP,
    P,
    ShardedTree,
    entry_axes,
    gather_over,
    param_specs,
    shard_tree,
    slices_of,
    spec_leaves,
    split_dims,
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

    def grad_fn(params, tokens, img, routes=None):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = lm.loss(live, tokens, img,
                                skip_masked=step_cfg.skip_masked,
                                force=force, routes=routes)
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

    def tp_grad_fn(trees, dims, tokens, img, group, routes):
        """``grad_fn`` over a row of model positions: each position's own
        leaves for the slices the model axis splits, the first position's
        for the rest (its gradient then serves every position)."""
        first = [p.detach().requires_grad_(True)
                 for p in tree_leaves(trees[0])]
        lives = [first] + [
            [p.detach().requires_grad_(True) if mdim is not None else f
             for p, f, (_d, mdim) in zip(tree_leaves(t), first, dims)]
            for t in trees[1:]]
        loss, metrics = lm.tp_loss(
            [_unflatten(t, live) for t, live in zip(trees, lives)], tokens,
            group, img=img, force=force, routes=routes)
        uniq = list({id(t): t for live in lives for t in live}.values())
        by_id = {id(t): g for t, g in
                 zip(uniq, torch.autograd.grad(loss, uniq))}
        grads = [_unflatten(t, [by_id[id(x)] for x in live])
                 for t, live in zip(trees, lives)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

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
        tp_axis = TP if TP in mesh.shape and any(
            entry_axes(e) == (TP,) for spec in specs for e in spec) else None
        daxes = tuple(a for a in mesh.axis_names if a != tp_axis)
        dims = _check_specs(specs, mesh, tp_axis, daxes)
        tp = mesh.shape[tp_axis] if tp_axis else 1
        check_tensor_parallel(lm.cfg, tp)
        tokens = torch.as_tensor(batch["tokens"])
        img = batch.get("img")
        B = tokens.shape[0]
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             f"microbatches")
        n_dp = mesh.axis_size(daxes)
        split = n_dp > 1 and B % (M * n_dp) == 0
        n = n_dp if split else 1
        rows = B // M // n
        routed = bool(lm.cfg.n_experts) and n > 1
        # each local model index's slices, whole along the data axes, on
        # every device of a local position that takes it
        slices = gather_over(state["params"], daxes)
        model_idx = [mesh.shard_index(p, (tp_axis,)) if tp_axis else 0
                     for p in positions]
        on_dev: dict = {}
        for j, dev in zip(model_idx, state.devices):
            if (j, dev) not in on_dev:
                on_dev[j, dev] = tree_map(lambda t: t.to(dev), slices[j])
        del slices
        # local positions by data row (rows and their positions in shard
        # order), and by model index for the data-axis reduce
        by_row: dict = {}
        by_model: dict = {}
        for k, p in enumerate(positions):
            by_row.setdefault(mesh.shard_index(p, daxes), []).append(k)
            by_model.setdefault(model_idx[k], []).append(k)
        rows_in_order = sorted(by_row.items())

        def row_inputs(i, d, ks):
            """A data row's trees, tokens and image rows in microbatch i."""
            r0 = (i * n + (d if split else 0)) * rows
            sl = slice(r0, r0 + rows)
            trees = [on_dev[model_idx[k], state.devices[k]] for k in ks]
            return trees, tokens[sl], None if img is None else img[sl]

        def row_group(r, ks):
            return ModelGroup(mesh, tp_axis, [positions[k] for k in ks],
                              count=r == 0)

        grads, loss_acc = None, None
        for i in range(M):
            parts = [None] * len(positions)
            losses = []
            routes = [None] * len(rows_in_order)
            if routed:
                # the routing pass, and the densities summed over the rows
                for r, (d, ks) in enumerate(rows_in_order):
                    trees, tok, im = row_inputs(i, d, ks)
                    routes[r] = (lm.route(trees[0], tok, im, force=force)
                                 if tp == 1 else
                                 lm.tp_route(trees, tok, row_group(r, ks),
                                             img=im, force=force))
                total = mesh.psum([rt.stacked_counts() for rt in routes],
                                  daxes)
                for rt, t in zip(routes, total):
                    rt.set_total(t, n * rows * tokens.shape[1])
            for r, (d, ks) in enumerate(rows_in_order):
                trees, tok, im = row_inputs(i, d, ks)
                if tp == 1:
                    loss, m, g = grad_fn(trees[0], tok, im, routes[r])
                    g = [g]
                else:
                    loss, m, g = tp_grad_fn(trees, dims, tok, im,
                                            row_group(r, ks), routes[r])
                for k, gk in zip(ks, g):
                    parts[k] = gk
                losses.append(m["ce"] if M == 1 else loss)
            red = reduce_grads(parts, specs, dims, daxes, by_model, split,
                               state.devices)
            del parts
            loss_i = (mesh.psum(losses, daxes)[0] / n if split
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
        del on_dev
        g_tree = ShardedTree(mesh, pspecs, grads)
        new_params, new_opt, stats = adamw_update(
            g_tree, state["opt"], state["params"], opt_cfg)
        steps = ShardedTree(mesh, state.specs["step"],
                            [s["step"] + 1 for s in state.shards])
        new_state = ShardedTree.join({"params": new_params, "opt": new_opt,
                                      "step": steps})
        return new_state, dict(loss=loss_acc, **stats)

    def reduce_grads(parts: list, specs: list, dims: list, daxes: tuple,
                     by_model: dict, split: bool, devices: list) -> list:
        """Each local position's slices of the positions' mean gradient:
        for each model index, its data row's gradients summed over the data
        axes in position order in ``accum_dtype`` (a reduce-scatter along
        the dim the data axes split, or a sum where none does) and divided
        by the rows where the batch is split; else (every row's gradient
        is the whole batch's) its own slices, as they are. Counted once:
        the first model index's."""
        n_dp = mesh.axis_size(daxes)
        cols = [[] for _ in parts]
        for spec, (ddim, _m), leaves in zip(specs, dims,
                                            zip(*map(tree_leaves, parts))):
            for c, ks in enumerate(by_model[j] for j in sorted(by_model)):
                g = [leaves[k] for k in ks]
                if not split:
                    for k, x in zip(ks, g):
                        cols[k].append(x[slices_of(x.shape, spec, mesh,
                                                   positions[k], daxes)])
                    continue
                red = (mesh.psum_scatter(g, entry_axes(spec[ddim]), ddim,
                                         dtype=adt, count=c == 0)
                       if ddim is not None else
                       mesh.psum([x.to(adt) for x in g], daxes, count=c == 0))
                for k, r in zip(ks, red):
                    cols[k].append(r.to(devices[k]) / n_dp)
        return [_unflatten(parts[0], col) for col in cols]

    return sharded_step


def _unflatten(like, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    order = {id(t): i for i, t in enumerate(tree_leaves(like))}
    return tree_map(lambda t: leaves[order[id(t)]], like)


def _check_specs(specs: list, mesh, tp_axis, daxes: tuple) -> list:
    """The (data dim, model dim) of each leaf's spec: the step trains a
    leaf split along at most one dim over every data axis of size > 1
    (FSDP) and at most one other dim over the model axis ``tp_axis``, as
    ``param_specs`` lays them out."""
    busy = tuple(a for a in daxes if mesh.shape[a] > 1)
    out = []
    for spec in specs:
        ddim, mdim = split_dims(spec, tp_axis)
        named = () if ddim is None else tuple(
            a for a in entry_axes(spec[ddim]) if mesh.shape[a] > 1)
        if ddim is not None and named != busy:
            raise NotImplementedError(
                f"spec {spec} on mesh {mesh.shape}: the train step shards a "
                f"leaf along one dim over every data axis (FSDP) and along "
                f"another over the model axis {TP!r} (tensor parallel)")
        out.append((ddim, mdim))
    return out
