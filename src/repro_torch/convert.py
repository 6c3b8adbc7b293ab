"""State carried across from the JAX package, as numpy arrays.

This system has no weights. What the sequential slice carries is the
result of each stage: the GMM clustering (``repro.core.gmm.GMMResult``),
a coreset buffer (``repro.core.coreset.Coreset``) and an end-to-end
solution (``repro.core.solve.DMMCSolution``). Each ``*_from_arrays`` takes
a mapping of field name -> array (e.g. ``{f: np.asarray(v) for f, v in
res._asdict().items()}`` on the JAX side) and builds the port's object;
``to_arrays`` goes back. A scan state of the streaming setting
(``repro.core.streaming.state_to_arrays``) is carried across by
``stream_state_from_arrays``, and the port can resume ingesting it.

The LM stack's weights cross by ``lm_params_from_arrays``: the tree of
the reference's ``LM.init`` with numpy leaves (``jax.tree.map(np.asarray,
params)``, bf16 leaves as numpy's bfloat16 extension type) becomes the
port's tree, leaf by leaf, with the stacked leading axes kept; a train
state (``repro.train.train_state.init_train_state``'s tree: parameters,
AdamW moments and step counters) by ``train_state_from_arrays``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from .core import streaming
from .core.coreset import Coreset
from .core.gmm import GMMResult
from .core.solve import DMMCSolution
from .device import CUDA, DeviceLike, resolve_device


def _t(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), device=dev).to(dtype)


def gmm_result_from_arrays(
    arrays: Mapping[str, Any], *, device: DeviceLike = CUDA
) -> GMMResult:
    dev = resolve_device(device)
    return GMMResult(
        centers=_t(arrays["centers"], torch.int32, dev),
        num_centers=int(arrays["num_centers"]),
        assign=_t(arrays["assign"], torch.int32, dev),
        min_dist=_t(arrays["min_dist"], torch.float32, dev),
        radius=_t(arrays["radius"], torch.float32, dev),
        delta=_t(arrays["delta"], torch.float32, dev),
    )


def coreset_from_arrays(
    arrays: Mapping[str, Any], *, device: DeviceLike = CUDA
) -> Coreset:
    dev = resolve_device(device)
    return Coreset(
        points=_t(arrays["points"], torch.float32, dev),
        cats=_t(arrays["cats"], torch.int32, dev),
        valid=_t(arrays["valid"], torch.bool, dev),
        src_idx=_t(arrays["src_idx"], torch.int32, dev),
    )


def solution_from_arrays(arrays: Mapping[str, Any]) -> DMMCSolution:
    """A solution is host data (numpy and floats); no device is involved."""
    return DMMCSolution(
        indices=np.asarray(arrays["indices"], np.int64),
        diversity=float(arrays["diversity"]),
        coreset_indices=np.asarray(arrays["coreset_indices"], np.int64),
        coreset_size=int(arrays["coreset_size"]),
        timings=dict(arrays.get("timings", {})),
        info=dict(arrays.get("info", {})),
    )


def stream_state_from_arrays(
    arrays: Mapping[str, Any], *, device: DeviceLike = CUDA
) -> streaming.StreamState:
    """A scan state from the reference's ``state_to_arrays`` dict: one
    state, or a stacked shard state (every field with a leading shard
    axis), which ``core.streaming.ingest_batch_sharded`` continues."""
    return streaming.state_from_arrays(arrays, device=device)


def _tree_from_arrays(like, tree, dev: torch.device, dtype_of, what: str):
    """A tree of ``like``'s keys and shapes from numpy leaves, each as
    ``dtype_of(like_leaf, array)``; bf16 goes through f32, which is
    exact."""
    def walk(spec, node, path):
        if isinstance(spec, dict):
            if set(spec) != set(node):
                raise ValueError(f"{path or what}: keys {sorted(node)}, "
                                 f"expected {sorted(spec)}")
            return {k: walk(spec[k], node[k], f"{path}.{k}".lstrip("."))
                    for k in spec}
        a = np.asarray(node)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{what}.{path}: shape {a.shape}, expected "
                             f"{tuple(spec.shape)}")
        dtype = dtype_of(spec, a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.as_tensor(np.array(a), device=dev).to(dtype)

    return walk(like, tree, "")


def _array_dtype(_spec, a: np.ndarray) -> torch.dtype:
    if a.dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros((), a.dtype)).dtype


def lm_params_from_arrays(cfg, tree: Mapping[str, Any], *,
                          device: DeviceLike = CUDA) -> dict:
    """The port's LM parameters from the reference's parameter tree.

    Every leaf must have the shape of the port's spec (``LM(cfg)
    .param_specs()``) and becomes a tensor of the spec's dtype.
    """
    from .models.model import LM

    return _tree_from_arrays(LM(cfg).param_specs(), tree,
                             resolve_device(device),
                             lambda spec, _a: spec.dtype, "params")


def train_state_from_arrays(cfg, tree: Mapping[str, Any], *,
                            device: DeviceLike = CUDA) -> dict:
    """The port's train state from the reference's ``{"params", "opt":
    {"m", "v", "step"[, "master"]}, "step"}`` tree with numpy leaves.

    Parameters go through ``lm_params_from_arrays``; each moment (and the
    master copy) keeps its array's dtype (f32, or bf16 as numpy's
    extension type) and must have its parameter's shape; the step
    counters become 0-d int32 tensors.
    """
    from .models.model import LM

    dev = resolve_device(device)
    specs = LM(cfg).param_specs()

    def step(a):
        return torch.as_tensor(np.array(a), device=dev).to(torch.int32)

    opt = tree["opt"]
    out = {name: _tree_from_arrays(specs, opt[name], dev, _array_dtype,
                                   f"opt.{name}")
           for name in ("m", "v", "master") if name in opt}
    out["step"] = step(opt["step"])
    return {"params": lm_params_from_arrays(cfg, tree["params"], device=dev),
            "opt": out, "step": step(tree["step"])}


def to_arrays(obj) -> dict[str, Any]:
    """Field name -> numpy array (or plain value) of a port object."""
    fields = (
        dataclasses.asdict(obj) if dataclasses.is_dataclass(obj)
        else obj._asdict()
    )
    return {
        name: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
        for name, v in fields.items()
    }
