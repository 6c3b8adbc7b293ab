"""Checkpoint manager: atomic, async, keep-N.

Reference: ``repro/train/checkpoint.py`` (``_flatten`` :33,
``_unflatten_into`` :52, ``CheckpointManager`` :70). The layout is the
reference's, byte for byte: ``<dir>/step_<n>/arrays.npz`` +
``manifest.json``, one npz entry per leaf keyed by its path of dict keys
joined by "/" (``"params/seg0/attn/wq"``, ``"opt/m/embed"``,
``"opt/step"``, ``"step"``), bf16 leaves stored as a raw uint16 view and
their dtype recovered from the tree they are restored into. So a
checkpoint written by the JAX package restores into the port and the
reverse. Writes go to ``step_<n>.tmp`` and are published by an atomic
``os.rename``; with ``async_write`` the device-to-host copy is taken in
``save`` and the disk write overlaps the next steps on a thread.

Elastic, as the reference: arrays are stored unsharded. ``save`` of a
sharded state (``models.sharding.ShardedTree``) gathers it first; on a
multi-rank mesh every rank gathers, rank 0 alone writes, and every rank
waits for the publish in ``wait`` (the next ``save`` waits too).
``restore(step, like, mesh=..., specs=...)`` places the tree onto any
mesh (the reference's ``shardings``), whatever mesh wrote it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import CUDA, DeviceLike, resolve_device
from ..models.sharding import ShardedTree, gather_tree, shard_tree

_NUMPY = (np.float32, np.float64, np.int32, np.int64, np.uint32, np.uint64,
          np.int8, np.uint8, np.int16, np.uint16, np.bool_)


def _paths(tree: Any, prefix: str = ""):
    """(key, leaf) in the reference's flattening order (sorted dict keys,
    then sequence positions)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _paths(t, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        # 2-byte floats numpy lacks: a raw uint16 view, as the reference
        return t.view(torch.int16).numpy().view(np.uint16)
    arr = t.numpy()
    if arr.dtype.type not in _NUMPY:
        raise ValueError(f"no checkpoint layout for dtype {t.dtype}")
    return arr


def _from_numpy(arr: np.ndarray, like: torch.Tensor,
                dev: torch.device) -> torch.Tensor:
    if arr.dtype == np.uint16 and like.dtype in (torch.bfloat16,
                                                 torch.float16):
        t = torch.from_numpy(np.array(arr).view(np.int16))
        t = t.view(like.dtype)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    return t.to(dev)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _paths(tree)}


def _unflatten_into(tree: Any, flat: dict[str, np.ndarray],
                    dev: torch.device, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, flat, dev, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten_into(t, flat, dev, f"{prefix}{i}/")
                          for i, t in enumerate(tree))
    key = prefix[:-1]
    arr = flat[key]
    if tuple(arr.shape) != tuple(tree.shape):
        raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, "
                         f"expected {tuple(tree.shape)}")
    return _from_numpy(arr, tree, dev)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._barrier = False  # the ranks of the last save meet in wait()
        os.makedirs(directory, exist_ok=True)

    # ---- write ----

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> None:
        mesh = tree.mesh if isinstance(tree, ShardedTree) else None
        if mesh is not None:
            tree = gather_tree(tree, device="cpu")
        writes = mesh is None or not mesh.multi_rank or mesh.rank == 0
        flat = _flatten(tree) if writes else None  # device -> host, sync
        meta = dict(step=int(step), time=time.time(), **(extra or {}))
        self.wait()
        self._barrier = mesh is not None and mesh.multi_rank
        if not writes:
            return
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, meta)

    def _write(self, step: int, flat: dict, meta: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"))

    # ---- read ----

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, *,
                device: DeviceLike = CUDA, mesh=None, specs=None) -> Any:
        """The checkpoint of ``step`` in the structure, shapes and dtypes of
        ``like`` (a tree of tensors, e.g. ``abstract_train_state``'s meta
        tensors), on ``device``; with a ``mesh``, a ``ShardedTree`` placed
        on it by ``specs`` (each position's slice on its device)."""
        if mesh is not None and specs is None:
            raise ValueError("restore onto a mesh needs the specs to place "
                             "the tree by")
        dev = torch.device("cpu") if mesh is not None else \
            resolve_device(device)
        path = os.path.join(self.dir, f"step_{step:010d}", "arrays.npz")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        tree = _unflatten_into(like, flat, dev)
        return (tree if mesh is None
                else shard_tree(tree, specs, mesh, donate=True))
