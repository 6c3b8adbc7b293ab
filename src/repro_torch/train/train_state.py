"""Train-step builder: microbatched gradient accumulation + AdamW.

Reference: ``repro/train/train_state.py`` (``StepConfig`` :22,
``init_train_state`` :29, ``make_train_step`` :45). ``make_train_step``
returns ``(state, batch) -> (state, metrics)``. Gradients come from
``torch.autograd.grad`` over the parameter leaves (taken as detached
views that require grad, so the state's own tensors never carry an
autograd flag); with M > 1 microbatches the batch is split along its
first axis and ``g / M`` is summed in ``accum_dtype``, as the reference's
scan does. The update is ``optimizer.adamw_update``, in place. The
reference's ``StepConfig.skip_masked`` has no counterpart: K4 and K5
always skip the tiles the causal mask hides, which changes no value. No
sharding: ``grad_specs`` waits for a model sharded across cards
(ROADMAP.md step 13).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import CUDA, DeviceLike
from ..models.model import DTYPES, LM, tree_leaves, tree_map
from .optimizer import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    accum_dtype: str = "float32"


def init_train_state(lm: LM, generator, opt_cfg: AdamWConfig, *,
                     device: DeviceLike = CUDA) -> dict:
    """{"params", "opt": {"m", "v", "step"[, "master"]}, "step"}: the
    reference's tree, with parameters from ``lm.init(generator)``."""
    params = lm.init(generator, device=device)
    return {
        "params": params,
        "opt": adamw_init(params, opt_cfg),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }


def abstract_train_state(lm: LM, opt_cfg: AdamWConfig) -> dict:
    """The train state's tree as ``meta`` tensors (shapes and dtypes only),
    what ``CheckpointManager.restore`` fills."""
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
    return {"params": params, "opt": opt, "step": step()}


def make_train_step(lm: LM, opt_cfg: AdamWConfig,
                    step_cfg: StepConfig = StepConfig(), *,
                    force: Optional[str] = None):
    """``force="ref"`` runs the step on the plain versions of the kernels
    (forward and backward)."""
    M = step_cfg.microbatches
    adt = DTYPES[step_cfg.accum_dtype]

    def grad_fn(params, tokens):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = lm.loss(live, tokens, force=force)
        leaves = tree_leaves(live)
        by_id = {id(t): g for t, g in
                 zip(leaves, torch.autograd.grad(loss, leaves))}
        grads = tree_map(lambda t: by_id[id(t)], live)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(state: dict, batch: dict):
        tokens = torch.as_tensor(batch["tokens"])
        params = state["params"]
        if M == 1:
            _loss, metrics, grads = grad_fn(params, tokens)
        else:
            B = tokens.shape[0]
            assert B % M == 0, (B, M)
            mb = B // M
            grads = tree_map(
                lambda p: torch.zeros(p.shape, dtype=adt, device=p.device),
                params)
            loss_acc = None
            for i in range(M):
                loss, _m, g = grad_fn(params, tokens[i * mb:(i + 1) * mb])
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

    return train_step
