"""Device meshes for the MapReduce and distributed paths.

Reference: ``repro/launch/mesh.py`` (``make_mesh``,
``make_production_mesh``, ``data_axes``). A mesh is a C-order grid of
positions with named axes; ``mesh.shape[axis]`` and ``mesh.axis_names``
read as the reference's, and ``mesh.devices`` is the device of each
position, in C order. Two kinds share every collective used by the port:

* **in-process** (the default when no process group covers the mesh):
  one process drives every position in turn; ``devices`` may name one
  device more than once, so ``make_mesh((8,), ("data",),
  devices=["cuda"] * 8)`` is eight positions on one card and
  ``devices=["cpu"] * 8`` eight on the host. A collective over positions
  is a stack and a reduction on the first position's device: no host
  round trip.
* **multi-rank**: ``torch.distributed`` is initialised with a world size
  equal to the mesh's size, and rank r owns flat position r (gloo on the
  CPU, NCCL on cards). A collective is ``dist.all_gather`` /
  ``dist.all_reduce`` over the group of the positions that differ only
  along the reduced axes (the whole world when those are all the axes
  of size > 1; otherwise one ``dist.new_group`` per group, made once, by
  every rank in the same order).

A caller hands a collective the list of its local positions' tensors
(``local_shards``): every position on an in-process mesh, its own on a
multi-rank mesh. So one code path serves both, and both give the same
result bit for bit.

The collectives: ``all_gather`` (tiled, along any dimension), ``pmax``,
and for FSDP training ``psum`` (a sum, a scalar's included) and
``psum_scatter`` (a reduce-scatter along a dimension). Sums are added in
shard order, on the first position's device in process and after a
gather across ranks (of the whole tensors for ``psum``, of each shard's
slices onto its rank for ``psum_scatter``), so that they too agree bit
for bit and do not depend on the backend's reduction order.

Nothing here touches device state at import.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import DeviceLike


class Mesh:
    """A named C-order grid of positions over devices (see the module)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices: Sequence[torch.device], multi_rank: bool):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = math.prod(self.shape.values())
        if len(devices) != self.size:
            raise ValueError(f"mesh {tuple(shape)} needs {self.size} "
                             f"devices, got {len(devices)}")
        self.devices = tuple(torch.device(d) for d in devices)
        self.multi_rank = bool(multi_rank)
        self.rank = dist.get_rank() if multi_rank else None
        self._groups: dict = {}

    def __repr__(self) -> str:
        kind = f"rank {self.rank}" if self.multi_rank else "in-process"
        return f"Mesh({self.shape}, {kind})"

    # ---- positions ---------------------------------------------------

    def coords(self, position: int) -> tuple[int, ...]:
        out = []
        for a in reversed(self.axis_names):
            position, c = divmod(position, self.shape[a])
            out.append(c)
        return tuple(reversed(out))

    def position(self, coords: Sequence[int]) -> int:
        p = 0
        for a, c in zip(self.axis_names, coords):
            p = p * self.shape[a] + int(c)
        return p

    def _check_axes(self, axes: Sequence[str]) -> tuple[str, ...]:
        axes = tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not in {self.axis_names}")
        return axes

    def axis_size(self, axes: Sequence[str]) -> int:
        """Number of positions along ``axes`` (the reference's
        ``axis_size`` over several names)."""
        return math.prod(self.shape[a] for a in self._check_axes(axes))

    def shard_index(self, position: int, axes: Sequence[str]) -> int:
        """C-order index of a position along ``axes`` (the reference's
        ``_flat_axis_index``)."""
        c = dict(zip(self.axis_names, self.coords(position)))
        idx = 0
        for a in self._check_axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def local_shards(self, axes: Sequence[str]
                     ) -> list[tuple[int, torch.device]]:
        """(shard index along ``axes``, device) of each shard this process
        computes, in shard order. In-process: every shard once, on the
        device of its first position (the others along the remaining axes
        hold the same data and would compute the same result). Multi-rank:
        this rank's position."""
        axes = self._check_axes(axes)
        if self.multi_rank:
            return [(self.shard_index(self.rank, axes),
                     self.devices[self.rank])]
        out = []
        for s in range(self.axis_size(axes)):
            coords = [0] * len(self.axis_names)
            rest = s
            for a in reversed(axes):
                rest, c = divmod(rest, self.shape[a])
                coords[self.axis_names.index(a)] = c
            out.append((s, self.devices[self.position(coords)]))
        return out

    def local_positions(self) -> list[int]:
        """The positions this process drives: every one on an in-process
        mesh, its own on a multi-rank one."""
        return [self.rank] if self.multi_rank else list(range(self.size))

    # ---- collectives -------------------------------------------------

    def group(self, axes: Sequence[str]):
        """The process group of this rank's positions along ``axes`` on a
        multi-rank mesh (``None``: the whole world). Every rank calls it
        in the same order."""
        axes = self._check_axes(axes)
        others = [a for a in self.axis_names
                  if a not in axes and self.shape[a] > 1]
        if not others:
            return None  # the whole world
        key = tuple(sorted(axes))
        if key not in self._groups:
            mine = None
            ranges = [range(self.shape[a]) if a in others else [None]
                      for a in self.axis_names]
            # every rank makes every group, in the same order
            for fixed in itertools.product(*ranges):
                members = [p for p in range(self.size)
                           if all(f is None or c == f for f, c in
                                  zip(fixed, self.coords(p)))]
                g = dist.new_group(members)
                if self.rank in members:
                    mine = g
            self._groups[key] = mine
        return self._groups[key]

    def all_gather(self, parts: Sequence[torch.Tensor],
                   axes: Sequence[str], dim: int = 0) -> torch.Tensor:
        """Tiled all-gather along ``dim`` over ``axes``: the shard-major
        concatenation of every shard's tensor (equal shapes), on the
        first local device. ``parts`` are this process's shards'
        tensors, in ``local_shards`` order."""
        axes = self._check_axes(axes)
        if not self.multi_rank:
            dev = parts[0].device
            return torch.cat([p.to(dev) for p in parts], dim)
        (x,) = parts
        is_bool = x.dtype == torch.bool
        src = (x.to(torch.uint8) if is_bool else x).contiguous()
        out = [torch.empty_like(src) for _ in range(self.axis_size(axes))]
        dist.all_gather(out, src, group=self.group(axes))
        y = torch.cat(out, dim)
        return y.to(torch.bool) if is_bool else y

    def _every_shard(self, parts: Sequence[torch.Tensor],
                     axes: tuple[str, ...]) -> list[torch.Tensor]:
        """Every shard's tensor along ``axes``, in shard order, on the
        first local device."""
        if not self.multi_rank:
            dev = parts[0].device
            return [p.to(dev) for p in parts]
        (x,) = parts
        out = [torch.empty_like(x) for _ in range(self.axis_size(axes))]
        dist.all_gather(out, x.contiguous(), group=self.group(axes))
        return out

    def psum(self, parts: Sequence[torch.Tensor],
             axes: Sequence[str]) -> list[torch.Tensor]:
        """Elementwise sum over ``axes``, added in shard order; one result
        per local shard, on its device."""
        axes = self._check_axes(axes)
        red = _ordered_sum(self._every_shard(parts, axes))
        return [red.to(p.device) for p in parts]

    def psum_scatter(self, parts: Sequence[torch.Tensor],
                     axes: Sequence[str], dim: int,
                     dtype: Optional[torch.dtype] = None
                     ) -> list[torch.Tensor]:
        """Reduce-scatter: the elementwise sum over ``axes``, added in
        shard order (in ``dtype``, by default the parts'), of which each
        local shard gets its slice along ``dim`` (shard s the s-th of
        ``axis_size(axes)`` equal slices), on its device. A multi-rank mesh
        gathers each shard's slice of every rank's tensor, cast a slice at
        a time, onto that shard's rank (one ``dist.gather`` a shard) and
        sums them there in shard order, so both kinds give the same bits.
        A rank sends (n-1)/n of its tensor, as a reduce-scatter does, and
        holds n slices in ``dtype``, one tensor's elements, beside its own
        (NCCL's ``reduce_scatter_tensor`` would hold no more than its
        slice and sum on the wire, in its own order)."""
        axes = self._check_axes(axes)
        if dtype is not None and not self.multi_rank:
            parts = [p.to(dtype) for p in parts]
        n = self.axis_size(axes)
        size = parts[0].shape[dim]
        if size % n:
            raise ValueError(f"psum_scatter: dim {dim} of size {size} does "
                             f"not split over {n} shards")
        c = size // n
        if not self.multi_rank:
            red = _ordered_sum(self._every_shard(parts, axes))
            return [red.narrow(dim, s * c, c).to(dev)
                    for s, dev in self.local_shards(axes)]
        (x,) = parts
        ((s, _dev),) = self.local_shards(axes)
        ranks = self._shard_ranks(axes)
        by_rank = sorted(ranks)  # a gather list is in group-rank order
        group = self.group(axes)
        mine = None
        for t, dst in enumerate(ranks):
            piece = x.narrow(dim, t * c, c).to(dtype or x.dtype).contiguous()
            out = [torch.empty_like(piece) for _ in ranks] if t == s else None
            dist.gather(piece, out, dst=dst, group=group)
            if t == s:
                mine = [out[by_rank.index(r)] for r in ranks]
        return [_ordered_sum(mine)]

    def _shard_ranks(self, axes: tuple[str, ...]) -> list[int]:
        """The ranks of this rank's group along ``axes``, in shard
        order."""
        mine = list(self.coords(self.rank))
        out = []
        for s in range(self.axis_size(axes)):
            coords, rest = list(mine), s
            for a in reversed(axes):
                rest, c = divmod(rest, self.shape[a])
                coords[self.axis_names.index(a)] = c
            out.append(self.position(coords))
        return out

    def pmax(self, parts: Sequence[torch.Tensor],
             axes: Sequence[str]) -> list[torch.Tensor]:
        """Elementwise max over ``axes``; one result per local shard, on
        its device."""
        axes = self._check_axes(axes)
        if not self.multi_rank:
            dev = parts[0].device
            red = torch.amax(torch.stack([p.to(dev) for p in parts]), dim=0)
            return [red.to(p.device) for p in parts]
        (x,) = parts
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group(axes))
        return [y]


def _ordered_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """parts[0] + parts[1] + ..., added left to right."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _default_rank_device(rank: int) -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def make_mesh(shape, axes, devices: Optional[Sequence[DeviceLike]] = None
              ) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.

    Multi-rank when ``torch.distributed`` is initialised with a world of
    the mesh's size (rank r owns position r; ``devices``, if given, names
    each position's device, by default the rank's card under NCCL and the
    CPU under gloo). Otherwise in-process: ``devices`` lists a device per
    position (repeats allowed); by default the visible cards, raising
    when there are fewer than the shape needs.
    """
    shape = tuple(int(s) for s in shape)
    need = math.prod(shape)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == need:
        if devices is None:
            devices = [_default_rank_device(r) for r in range(need)]
        return Mesh(shape, axes, list(devices), multi_rank=True)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < need:
            raise RuntimeError(
                f"mesh {shape} needs {need} devices, found {have} cards; "
                f"pass devices= (a device may repeat, e.g. "
                f"devices=['cuda'] * {need} or ['cpu'] * {need}) or run "
                f"{need} ranks under torch.distributed")
        devices = [torch.device("cuda", i) for i in range(need)]
    return Mesh(shape, axes, list(devices), multi_rank=False)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == need:
        return make_mesh(shape, axes)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} cards, found {have}: run {need} "
            f"ranks under torch.distributed, or build an in-process mesh "
            f"with make_mesh(..., devices=...)")
    return make_mesh(shape, axes)


def data_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a production mesh (pod extends DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))
