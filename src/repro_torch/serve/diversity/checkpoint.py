"""Checkpoint/restore for ``StreamRuntime``: serialized scan states +
enough metadata to resume the stream bit-identically.

Reference: ``repro/serve/diversity/checkpoint.py``. The file is the
reference's: the same ``.npz`` keys and dtypes (``core.streaming.
state_to_arrays``), the same JSON metadata and the same file names, so a
directory written by either package restores in the other. A checkpoint
names no device: ``load_checkpoint`` returns host arrays, and the caller
puts them on its own device (``place_state``).

A checkpoint is one ``.npz`` file holding

* the serialized ``StreamState``(s) under every placement drive — a
  single state, a stacked (vmap/shard_map) state, or the pipeline
  placement's per-shard list (``core.streaming.state_to_arrays``);
* a JSON metadata blob: stream position (``n_offered``, pipeline
  round-robin cursor), WAL watermark (``wal_seq`` — every WAL record at
  or below it is folded into the state), poisoned seqs (skipped on
  replay so a restored stream matches the live post-quarantine stream),
  epoch counter, the coreset fingerprint at save time, and the runtime's
  construction config (so ``restore`` can rebuild the runtime without
  the caller re-specifying it — host oracles and callbacks are the only
  non-serializable pieces and are re-passed at restore time).

Files are written to a temp name and ``os.replace``d — a crash (or an
injected ``checkpoint.write`` fault) mid-save never corrupts an existing
checkpoint; ``latest_checkpoint`` skips unreadable files. Names carry
the stream position and epoch fingerprint
(``ckpt-<n_offered>-<fingerprint>.npz``) so the newest valid checkpoint
is the one with the largest position.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
from typing import Optional, Union

import numpy as np

import torch

from ...core.streaming import StreamState, state_from_arrays
from ...device import DeviceLike

_log = logging.getLogger("repro_torch.serve.diversity.checkpoint")

CKPT_PREFIX = "ckpt-"
WAL_NAME = "wal.log"


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """Where and how often a runtime persists itself.

    dir               directory holding the WAL (``wal.log``) and the
                      checkpoint files;
    checkpoint_every  applied batches between automatic checkpoints
                      (taken by the ingest worker after publishing);
    fsync             fsync WAL appends and checkpoint files (durable
                      against power loss, not just process death);
    keep              retained checkpoints; older ones are pruned after
                      each successful save, and the WAL is compacted to
                      the *oldest retained* checkpoint's watermark so
                      any retained checkpoint can still replay forward.
    """

    dir: str
    checkpoint_every: int = 32
    fsync: bool = False
    keep: int = 3

    def __post_init__(self):
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if self.keep < 1:
            raise ValueError("keep must be >= 1")

    @property
    def wal_path(self) -> str:
        return os.path.join(self.dir, WAL_NAME)


def _fp_token(fingerprint: Optional[int]) -> str:
    return format((fingerprint or 0) & 0xFFFFFFFFFFFFFFFF, "016x")


def checkpoint_path(dir: str, n_offered: int,
                    fingerprint: Optional[int]) -> str:
    return os.path.join(
        dir, f"{CKPT_PREFIX}{n_offered:014d}-{_fp_token(fingerprint)}.npz"
    )


def _arrays(st: StreamState) -> dict:
    """One state's fields as host arrays (tensors are copied off their
    device; numpy fields are taken as they are)."""
    return {
        f: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        for f, v in zip(StreamState._fields, st)
    }


def host_copy(state: Union[StreamState, list]) -> Union[StreamState, list]:
    """A host copy of a live state (or the pipeline's list of states),
    numpy fields that share no memory with it. The scan updates its
    tensors in place, and on the CPU ``.numpy()`` is a view of the live
    buffer: a checkpoint must copy under the runtime lock, before the
    next ingest."""
    if isinstance(state, list):
        return [host_copy(st) for st in state]
    return StreamState(*(
        t.detach().to("cpu", copy=True).numpy() for t in state))


def place_state(state: Union[StreamState, list], device: DeviceLike):
    """A loaded (host) state, or list of states, on ``device``."""
    if isinstance(state, list):
        return [place_state(st, device) for st in state]
    return state_from_arrays(_arrays(state), device=device)


def save_checkpoint(
    path: str,
    state: Union[StreamState, list],
    meta: dict,
    *,
    faults=None,
    fsync: bool = False,
) -> str:
    """Write one atomic checkpoint file; returns ``path``.

    Raises on failure (injected ``checkpoint.write`` faults included) —
    the caller counts/logs and keeps serving; any previous checkpoint is
    untouched because the write lands on a temp name first.
    """
    if faults is not None:
        faults.check("checkpoint.write")
    arrays: dict = {}
    if isinstance(state, list):
        meta = dict(meta, kind="list", num_states=len(state))
        for i, st in enumerate(state):
            for f, a in _arrays(st).items():
                arrays[f"s{i}.{f}"] = a
    else:
        meta = dict(
            meta,
            kind=meta.get("kind", "single"),
            num_states=1,
        )
        for f, a in _arrays(state).items():
            arrays[f"s0.{f}"] = a
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), np.uint8
    )
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str) -> tuple[Union[StreamState, list], dict]:
    """Load one checkpoint file -> (state(s), meta). The state comes
    back as a ``StreamState`` of host arrays (single/stacked) or a list
    of them (pipeline); the caller puts it on its device
    (``place_state``)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        n_states = int(meta.get("num_states", 1))
        states = []
        for i in range(n_states):
            pre = f"s{i}."
            states.append(StreamState(
                **{f: z[pre + f] for f in StreamState._fields}
            ))
    if meta.get("kind") == "list":
        return states, meta
    return states[0], meta


def read_meta(path: str) -> dict:
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode("utf-8"))


def list_checkpoints(dir: str) -> list[str]:
    """Checkpoint files in ``dir``, oldest stream position first
    (unreadable/foreign files skipped)."""
    if not os.path.isdir(dir):
        return []
    out = []
    for name in os.listdir(dir):
        if name.startswith(CKPT_PREFIX) and name.endswith(".npz"):
            out.append(os.path.join(dir, name))
    return sorted(out)  # the zero-padded position prefix sorts correctly


def latest_checkpoint(dir: str) -> Optional[str]:
    """Newest *valid* checkpoint (largest stream position whose metadata
    loads); corrupt files are skipped with a warning, so a fault during
    one save never blocks restore from an earlier good checkpoint."""
    for path in reversed(list_checkpoints(dir)):
        try:
            read_meta(path)
            return path
        except Exception:
            _log.warning("skipping unreadable checkpoint %s", path)
    return None


def checkpoint_watermark(dir: str) -> "tuple[Optional[str], int, int]":
    """``(path, wal_seq, n_offered)`` of the newest valid checkpoint —
    the resume coordinate replication re-seeds and failover reports work
    from. ``(None, -1, 0)`` when the dir has no readable checkpoint."""
    path = latest_checkpoint(dir)
    if path is None:
        return None, -1, 0
    meta = read_meta(path)
    return path, int(meta.get("wal_seq", -1)), int(meta.get("n_offered", 0))


def prune_checkpoints(dir: str, keep: int) -> int:
    """Delete all but the newest ``keep`` checkpoints; returns the
    lowest retained WAL watermark (-1 when none carry one), which is
    how far the WAL may safely be compacted."""
    ckpts = list_checkpoints(dir)
    for path in ckpts[:-keep] if keep > 0 else ckpts:
        try:
            os.unlink(path)
        except OSError:
            _log.warning("could not prune checkpoint %s", path)
    floor = -1
    for path in list_checkpoints(dir):
        try:
            seq = int(read_meta(path).get("wal_seq", -1))
        except Exception:
            continue
        floor = seq if floor < 0 else min(floor, seq)
    return floor
