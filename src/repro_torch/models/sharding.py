"""PartitionSpec rules (FSDP over the data axes x TP/EP over the model
axis) and the placement of a tree on a mesh by them.

Reference: ``repro/models/sharding.py`` (``_spec_for`` :63,
``param_specs`` :119, ``batch_spec`` :132, ``cache_specs`` :138, the
activation mesh :39-61). The rules are the reference's, keyed by the same
path names as a checkpoint (``"seg0/attn/wq"``), over the port's trees:
``param_specs`` walks ``LM.abstract_params()`` (meta tensors, so a 400 B
config costs nothing), ``cache_specs`` mirrors ``LM.init_caches``.

``P`` is the spec type: a tuple with one entry a dimension, each entry
``None``, an axis name or a tuple of names (major to minor), compared as
``jax.sharding.PartitionSpec`` compares (a 1-tuple of names equals the
name; trailing ``None``s are not dropped).

Placement is the port's ``NamedSharding`` + ``device_put``:
``shard_tree(tree, specs, mesh)`` gives each local position of a
``launch.mesh.Mesh`` (every position of an in-process mesh, its own on a
multi-rank one) its own copy of its slice of every leaf, along the
dimensions its spec names; ``gather_tree`` gives the whole tree back.
Splits must be even: an uneven one raises and names the leaf. Tensor
parallelism is specs only here: the train step (``train/train_state.py``)
trains a tree sharded over the data axes (FSDP), and a tp spec is read by
the dry run (ROADMAP.md step 13.6).

The activation mesh is kept for the reference's API only:
``set_activation_mesh(dp, tp)`` records the axes and ``activation_mesh``
reads them back, and nothing in the port reads them (the train step
splits the batch over the positions when it divides, from the shapes
alone). ``constrain`` returns ``x`` unchanged (a position already holds
its own batch slice) after checking that ``dims`` has one entry a
dimension.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch

FSDP = ("data",)
TP = "model"


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(None, ("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def _norm(self) -> tuple:
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in self)

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        return self._norm() == P(*other)._norm()

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self._norm())

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# the activation mesh
# ---------------------------------------------------------------------------

_ACT: dict = {"dp": None, "tp": None}


def set_activation_mesh(dp: Optional[Sequence[str]], tp: Optional[str]):
    _ACT["dp"] = tuple(dp) if dp else None
    _ACT["tp"] = tp


def clear_activation_mesh():
    set_activation_mesh(None, None)


def activation_mesh() -> tuple[Optional[tuple[str, ...]], Optional[str]]:
    """(dp, tp) as last set: the reference's batch and tensor-parallel
    axes. Recorded only; the port's step does not read them."""
    return _ACT["dp"], _ACT["tp"]


def constrain(x: torch.Tensor, dims: tuple) -> torch.Tensor:
    """dims: per-axis entries in {'dp', 'tp', None}. The identity: a
    position computes on its own batch slice already."""
    if len(dims) != x.dim():
        raise ValueError(f"constrain: {len(dims)} dims {dims} for a "
                         f"tensor of rank {x.dim()}")
    return x


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _spec_for(path: tuple[str, ...], ndim: int, fsdp, tp) -> P:
    name = path[-1]
    joined = "/".join(path)

    def pad(spec_dims: list) -> P:
        extra = ndim - len(spec_dims)
        return P(*([None] * extra + spec_dims))

    if name == "embed":
        return pad([tp, fsdp])  # (V, d)
    if name == "lm_head":
        return pad([fsdp, tp])  # (d, V)
    if name in ("wq", "wk", "wv"):
        return pad([fsdp, tp])
    if name == "wo":
        return pad([tp, fsdp])
    if name in ("w_in", "w_gate", "w_out"):
        if "moe" in joined:
            if name == "w_out":
                return pad([tp, None, fsdp])  # (E, f, d)
            return pad([tp, fsdp, None])  # (E, d, f)
        if name == "w_out":
            return pad([tp, fsdp])  # (f, d)
        return pad([fsdp, tp])  # (d, f)
    if name == "router":
        return pad([fsdp, None])
    if name == "in_proj":
        return pad([fsdp, tp])
    if name == "out_proj":
        return pad([tp, fsdp])
    if name == "conv_w":
        return pad([None, tp])
    if name in ("conv_b",):
        return pad([tp])
    if name in ("A_log", "D", "dt_bias"):
        return pad([tp])
    if name == "norm" and "mamba" in joined:
        return pad([tp])
    # norms and other small vectors: replicated
    return P(*([None] * ndim))


def _fa(fsdp: Sequence[str]):
    fsdp_t = tuple(fsdp)
    return fsdp_t if len(fsdp_t) > 1 else fsdp_t[0]


def _map_paths(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists; a path
    is the tuple of keys and positions down to the leaf."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(_map_paths(fn, t, path + (str(i),))
                          for i, t in enumerate(tree))
    return fn(path, tree)


def _zip_specs(fn, tree, specs, path: tuple = ()):
    """``fn(path, leaf, spec)`` over a tree and its spec tree (the tree
    decides the structure, so a ``P`` is reached only at a leaf)."""
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k], path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_specs(fn, t, s, path + (str(i),))
                          for i, (t, s) in enumerate(zip(tree, specs)))
    return fn(path, tree, specs)


def spec_leaves(tree: Any, specs: Any) -> list:
    """The specs of a tree's leaves, in ``tree_leaves`` order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k],
                                                             specs[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t, s in zip(tree, specs) for x in spec_leaves(t, s)]
    return [specs]


def param_specs(abstract_params: Any, fsdp: Sequence[str] = FSDP,
                tp: Optional[str] = TP) -> Any:
    """The spec tree of a (meta) parameter tree. tp=None (a data mesh
    alone) drops the tensor-parallel dims."""
    fa = _fa(fsdp)
    return _map_paths(lambda path, leaf: _spec_for(path, leaf.dim(), fa, tp),
                      abstract_params)


def batch_spec(batch_shardable: bool, fsdp: Sequence[str] = FSDP) -> P:
    return P(_fa(fsdp)) if batch_shardable else P(None)


def cache_specs(lm, fsdp: Sequence[str] = FSDP, tp: str = TP,
                batch_shardable: bool = True, mode: str = "auto",
                tp_size: int = 16) -> list:
    """The spec tree of ``LM.init_caches``' caches.

    Attention KV caches (count[, inner], B, S, KV, hd): batch over fsdp and
    one of {kv-heads, head-dim, sequence} over tp; ``mode="auto"`` picks
    heads > hd > seq by divisibility by ``tp_size``. Mamba caches: ssm
    (count[, inner], B, H, P, N), heads over tp; conv (count[, inner], B,
    K-1, C), channels over tp.
    """
    fa = _fa(fsdp) if batch_shardable else None
    cfg = lm.cfg
    if mode == "auto":
        if cfg.n_kv and cfg.n_kv % tp_size == 0:
            mode = "heads"
        elif cfg.hd % tp_size == 0:
            mode = "hd"
        else:
            mode = "seq"

    def attn_spec(extra: int):
        lead = [None] * extra
        if mode == "heads":
            sp = P(*lead, fa, None, tp, None)
        elif mode == "hd":
            sp = P(*lead, fa, None, None, tp)
        else:
            sp = P(*lead, fa, tp, None, None)
        return (sp, sp)

    def cross_spec(extra: int):
        lead = [None] * extra
        return (P(*lead, fa, None, None, None), P(*lead, fa, None, None, None))

    def mamba_spec(extra: int):
        lead = [None] * extra
        return (P(*lead, fa, tp, None, None), P(*lead, fa, None, tp))

    specs = []
    for kind, _count in lm.plan:
        if kind in ("dense", "moe"):
            specs.append(attn_spec(1))
        elif kind == "moe_pair":
            specs.append({"dense": attn_spec(1), "moe": attn_spec(1)})
        elif kind == "mamba":
            specs.append(mamba_spec(1))
        elif kind == "zamba_super":
            specs.append({"mamba": mamba_spec(2), "attn": attn_spec(1)})
        elif kind == "vlm_super":
            specs.append({"dense": attn_spec(2), "cross": cross_spec(1)})
        else:
            raise ValueError(kind)
    return specs


# ---------------------------------------------------------------------------
# placement on a mesh
# ---------------------------------------------------------------------------


def entry_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names (none for ``None``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _check_spec(path, shape, spec, mesh) -> None:
    name = "/".join(path)
    if len(spec) > len(shape):
        raise ValueError(f"{name}: spec {spec} has more entries than the "
                         f"leaf's {len(shape)} dims")
    for dim, entry in enumerate(spec):
        n = mesh.axis_size(entry_axes(entry))
        if shape[dim] % n:
            raise ValueError(
                f"{name}: dim {dim} of size {shape[dim]} does not split "
                f"evenly over {n} positions of {entry_axes(entry)}")


def slices_of(shape, spec: P, mesh, position: int) -> tuple:
    """The index of ``position``'s slice of a leaf of ``shape``."""
    out = []
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        axes = entry_axes(entry)
        n = mesh.axis_size(axes)
        if n == 1:
            out.append(slice(None))
            continue
        c = size // n
        s = mesh.shard_index(position, axes)
        out.append(slice(s * c, (s + 1) * c))
    return tuple(out)


def shard_shape(shape, spec: P, mesh) -> tuple[int, ...]:
    """A position's slice shape (every position's is the same)."""
    return tuple(size // mesh.axis_size(entry_axes(
        spec[dim] if dim < len(spec) else None))
        for dim, size in enumerate(shape))


class ShardedTree:
    """A tree placed on a mesh by a spec tree: ``shards[i]`` is the tree of
    local position ``positions[i]``, on ``mesh.devices[positions[i]]``.
    ``tree[key]`` is the sharded subtree (so ``state["params"]`` reads as
    on an unsharded state)."""

    def __init__(self, mesh, specs, shards: Sequence[Any]):
        self.mesh = mesh
        self.specs = specs
        self.shards = list(shards)
        self.positions = mesh.local_positions()
        if len(self.shards) != len(self.positions):
            raise ValueError(f"{len(self.shards)} shards for "
                             f"{len(self.positions)} local positions")

    @property
    def devices(self) -> list[torch.device]:
        return [self.mesh.devices[p] for p in self.positions]

    def __getitem__(self, key) -> "ShardedTree":
        return ShardedTree(self.mesh, self.specs[key],
                           [s[key] for s in self.shards])

    @staticmethod
    def join(parts: dict) -> "ShardedTree":
        """One sharded dict from sharded values on one mesh."""
        first = next(iter(parts.values()))
        shards = [{k: v.shards[i] for k, v in parts.items()}
                  for i in range(len(first.shards))]
        return ShardedTree(first.mesh, {k: v.specs for k, v in parts.items()},
                           shards)

    def __repr__(self) -> str:
        return f"ShardedTree({self.mesh!r}, {len(self.shards)} local)"


def _take(leaf: torch.Tensor, index: tuple, dev: torch.device,
          reuse: bool):
    part = leaf[index]
    if leaf.device.type == "meta":
        return torch.empty(part.shape, dtype=leaf.dtype, device="meta")
    if reuse and part.shape == leaf.shape and leaf.device == dev:
        return leaf
    return torch.empty(part.shape, dtype=leaf.dtype, device=dev).copy_(part)


def shard_tree(tree: Any, specs: Any, mesh, *,
               donate: bool = False) -> ShardedTree:
    """Each local position's own copy of its slice of every leaf (a meta
    tree gives meta slices). Raises, naming the leaf, where a split is
    uneven. ``donate``: the caller gives ``tree`` up, so the first local
    position keeps a leaf it holds whole on its device instead of a copy
    (a one-position mesh then costs no memory)."""
    _zip_specs(lambda path, leaf, spec: _check_spec(path, leaf.shape, spec,
                                                    mesh), tree, specs)
    shards = []
    for i, p in enumerate(mesh.local_positions()):
        dev = mesh.devices[p]
        shards.append(_zip_specs(
            lambda path, leaf, spec: _take(
                leaf, slices_of(leaf.shape, spec, mesh, p), dev,
                donate and i == 0),
            tree, specs))
    return ShardedTree(mesh, specs, shards)


def _full_shape(part_shape, spec: P, mesh) -> tuple[int, ...]:
    return tuple(size * mesh.axis_size(entry_axes(
        spec[dim] if dim < len(spec) else None))
        for dim, size in enumerate(part_shape))


def _gather_leaf(parts: list, spec: P, mesh, dev: torch.device):
    shape = _full_shape(parts[0].shape, spec, mesh)
    if tuple(parts[0].shape) == shape:  # whole on every position
        return parts[0].to(dev)
    if mesh.multi_rank:
        (x,) = parts
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            if mesh.axis_size(axes) > 1:
                x = mesh.all_gather([x], axes, dim=dim)
        return x.to(dev)
    full = torch.empty(shape, dtype=parts[0].dtype, device=dev)
    for p, part in enumerate(parts):
        full[slices_of(shape, spec, mesh, p)] = part
    return full


def gather_tree(tree: ShardedTree, device=None) -> Any:
    """The whole tree, on ``device`` (default: the first local position's).
    Where a position holds a whole leaf, the result is that position's own
    tensor (not a copy): read it, do not write it. On a multi-rank mesh
    every rank calls it (the leaves are all-gathered)."""
    dev = torch.device(device) if device is not None else tree.devices[0]

    def walk(parts: list, spec):
        first = parts[0]
        if isinstance(first, dict):
            return {k: walk([p[k] for p in parts], spec[k]) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(walk([p[i] for p in parts], s)
                               for i, s in zip(range(len(first)), spec))
        return _gather_leaf(parts, spec, tree.mesh, dev)

    return walk(tree.shards, tree.specs)


def local_bytes(tree: Any, specs: Any, mesh) -> int:
    """Bytes of one position's slices of a (meta) tree: what FSDP over
    ``mesh`` leaves on each position."""
    total = [0]

    def add(_path, leaf, spec):
        n = math.prod(shard_shape(leaf.shape, spec, mesh))
        total[0] += n * leaf.element_size()

    _zip_specs(add, tree, specs)
    return total[0]


__all__ = ["FSDP", "P", "ShardedTree", "TP", "activation_mesh",
           "batch_spec", "cache_specs", "clear_activation_mesh", "constrain",
           "entry_axes", "gather_tree", "local_bytes", "param_specs",
           "set_activation_mesh", "shard_shape", "shard_tree", "slices_of",
           "spec_leaves"]
