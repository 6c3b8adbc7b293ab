"""Streaming coreset construction (paper Alg. 2 "StreamCoreset" and the
tau-controlled radius variant of §5.2), as a resumable ingestion API.

Reference: ``repro/core/streaming.py`` (single placement):

    st = init_stream_state(d, gamma, spec, k, tau, device=...)
    st = ingest_batch(st, batch, cats, valid, spec, caps, k, tau,
                      base_index=offset)     # any number of times
    coreset = snapshot_coreset(st)

Resuming is exact: the scan branches only on ``n_seen``, so batches give
the state of one pass, bit for bit.

How the JAX control flow became PyTorch:

- The reference's ``lax.scan`` / ``while_loop`` / ``_cond_once`` are Python
  loops and ``if``s here. The points and the float buffers (``centers``,
  ``dp``, ``x1``) stay on the device; the decisions are taken on host
  copies of the small integer buffers (``cvalid``, ``dv``, ``dc``, ``ds``)
  and of the scalars (``R`` as a numpy float32, ``n_seen``, ``overflow``),
  which one ingest call reads at entry and writes back at exit.
- The scan is blocked (``block_size`` points per step). On the card a
  block costs one K3 launch (``kernels.ops.block_precheck``: the
  distances, the exact refinement of the two candidate centers and the
  replay flags in one kernel), one device-to-host copy of its (2, B)
  result, and the HANDLE count tables (host, numpy); only active points
  replay the per-point step, and the precheck is recomputed only after a
  replay that changed state (the ``dirty`` rule). ``block_size=1`` is the
  per-point scan; both give the same state.
- The reference has two per-point steps: the branchless masked one, which
  exists so that ``vmap``/``shard_map`` lanes skip branches, and the
  cond-ladder ``reference`` one. In eager PyTorch both reduce to the same
  real branches, and the sharded drive runs its lanes one after another
  on those branches, so this module implements the Alg.-2 semantics once
  and accepts both names in ``STEP_IMPLS``.
- The restructure merge visits the live delegates of dead centers only, in
  ascending (center, slot) order; HANDLE writes only to kept centers, so
  that list is fixed before the loop.
- Out-of-range gathers are clipped explicitly where JAX clamps them.
- The block's exact refinement (in the kernel, or torch's (B, d) rows on
  the plain path) and the per-point step ((T, d) rows) sum in other
  orders and may differ in the last bits. The block precheck therefore
  also sends to the replay any point whose refined comparison lies within
  a relative ``kernels.ref.SLACK`` of a decision boundary; a replay
  decides exactly, so this only adds replays.

The single-card sharded drives (reference :1036–1145):
``init_sharded_states`` stacks S empty states along a leading shard
axis; ``ingest_batch_sharded[_donated]`` drives the S lanes of that stack
one after another over the same ``_Scan`` (each lane is a view of the
stacked tensors, updated in place), so each shard's state is the state of
``ingest_batch`` on its sub-stream alone, bit for bit. The reference's
``vmap`` runs the lanes as one program; a single K3 launch across lanes
is later work (ROADMAP §2). The ``shard_map`` drive
(``ingest_batch_sharded_mapped``, reference :1189) deals the S lanes in
contiguous groups over ``mesh_device_count(S)`` devices and runs each
group through the same sharded drive on its device, so per-shard results
are those of ``ingest_batch_sharded``, bit for bit; on one card it is one
group, the ``vmap`` drive. ``resolve_placement`` picks the drive. General
matroids use ``stream_coreset_host`` (numpy).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import CUDA, DeviceLike, resolve_device
from ..kernels import ops as _ops
from ..kernels.ref import point_dist as _point_dist
from .coreset import Coreset
from .matroid import MatroidSpec
from .solvers.matching import greedy_matching_slots

_F32_MAX = float(torch.finfo(torch.float32).max)
_JIT_KINDS = ("uniform", "partition", "transversal")

STEP_IMPLS = ("branchless", "reference")

# scan counters since the last reset_scan_counts (plain integers, like the
# kernels' launch counts)
blocks = 0  # blocks of the blocked scan that held a valid point
replays = 0  # points replayed through the per-point step inside blocks
recomputes = 0  # block prechecks recomputed after a state change
restructures = 0  # filter-and-merge rounds


def scan_counts() -> dict[str, int]:
    return dict(blocks=blocks, replays=replays, recomputes=recomputes,
                restructures=restructures)


def reset_scan_counts() -> None:
    global blocks, replays, recomputes, restructures
    blocks = replays = recomputes = restructures = 0


class StreamState(NamedTuple):
    R: torch.Tensor  # f32 scalar estimate (diameter / radius)
    x1: torch.Tensor  # (d,) first stream point
    n_seen: torch.Tensor  # int32, number of (valid) points consumed
    centers: torch.Tensor  # (TCAP, d)
    cvalid: torch.Tensor  # (TCAP,) bool
    dp: torch.Tensor  # (TCAP, SLOT, d)
    dc: torch.Tensor  # (TCAP, SLOT, gamma) int32
    dv: torch.Tensor  # (TCAP, SLOT) bool
    ds: torch.Tensor  # (TCAP, SLOT) int32
    overflow: torch.Tensor  # int32: forced-discard count (transversal cap)


def _dists_to_centers(x, centers, cvalid):
    diff = centers - x[None, :]
    d = torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0))
    return torch.where(cvalid, d, _F32_MAX)


def _clamped(i: int, n: int) -> int:
    """The index a JAX gather reads: negatives wrap once, then clamp."""
    if i < 0:
        i += n
    return min(max(i, 0), n - 1)


def default_slot_cap(spec: MatroidSpec, k: int) -> int:
    """Static per-center delegate capacity (Alg. 2 size bounds)."""
    if spec.kind in ("uniform", "partition"):
        return k
    return max(spec.gamma, 1) * k * k


def init_stream_state(
    d: int,
    gamma: int,
    spec: MatroidSpec,
    k: int,
    tau: int,
    *,
    slot_cap: Optional[int] = None,
    device: DeviceLike = CUDA,
) -> StreamState:
    """Empty resumable scan state on ``device``. ``tau >= 2``: the scan
    opens centers for the first two stream points unconditionally."""
    if tau < 2:
        raise ValueError(f"tau must be >= 2, got {tau}")
    dev = resolve_device(device)
    tcap = tau + 1
    if slot_cap is None:
        slot_cap = default_slot_cap(spec, k)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return StreamState(
        R=torch.zeros((), **f32),
        x1=torch.zeros((d,), **f32),
        n_seen=torch.zeros((), **i32),
        centers=torch.zeros((tcap, d), **f32),
        cvalid=torch.zeros((tcap,), dtype=torch.bool, device=dev),
        dp=torch.zeros((tcap, slot_cap, d), **f32),
        dc=torch.full((tcap, slot_cap, gamma), -1, **i32),
        dv=torch.zeros((tcap, slot_cap), dtype=torch.bool, device=dev),
        ds=torch.full((tcap, slot_cap), -1, **i32),
        overflow=torch.zeros((), **i32),
    )


_MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 values in [0, 2^32), without overflowing
    int64: a is split into 16-bit halves."""
    lo, hi = a & 0xFFFF, a >> 16
    return (lo * b + (((hi * b) & 0xFFFF) << 16)) & _MASK32


def _epoch_stats_impl(st: StreamState):
    """``(count, h1, h2)`` of a scan state on its device (reference
    ``_epoch_stats_impl``): the live-cell count and two position-mixed
    checksums of the live cells' stream rows, in uint32 arithmetic with
    wrap-around. PyTorch has no wrapping uint32 sum, so the values are
    int64 with every product and sum reduced mod 2^32. Works on a stacked
    state too (every leading axis is flattened)."""
    valid = st.dv & st.cvalid[..., None]
    vz = valid.reshape(-1)
    src = torch.where(vz, (st.ds.reshape(-1).to(torch.int64) + 1) & _MASK32,
                      0)
    pos = torch.arange(vz.numel(), dtype=torch.int64, device=vz.device)
    count = torch.sum(valid.to(torch.int64))
    h1 = torch.sum(_mul32(src, _mul32(pos, 0x9E3779B1) | 1)) & _MASK32
    h2 = torch.sum(_mul32(src ^ _mul32(pos, 0x85EBCA6B), 0x27D4EB2F)) & _MASK32
    return count, h1, h2


epoch_stats = _epoch_stats_impl


def epoch_fingerprint(st: StreamState) -> tuple[int, int]:
    """Host ``(fingerprint, coreset_size)`` of a scan state through one
    device sync; the same values as the reference's for the same state."""
    count, h1, h2 = torch.stack(epoch_stats(st)).tolist()
    return hash((count, h1, h2)), count


def state_to_arrays(st: StreamState) -> dict:
    """One ``StreamState`` as host numpy arrays, keyed by field (the same
    keys and dtypes as the reference's ``state_to_arrays``)."""
    return {f: getattr(st, f).cpu().numpy() for f in StreamState._fields}


def state_from_arrays(arrays, *, device: DeviceLike = CUDA) -> StreamState:
    """Rebuild a ``StreamState`` on ``device`` from ``state_to_arrays``
    output, the port's or the reference's (dtypes kept; a missing field
    raises ``KeyError``)."""
    dev = resolve_device(device)
    return StreamState(**{
        f: torch.as_tensor(np.array(arrays[f]), device=dev)
        for f in StreamState._fields
    })


def snapshot_coreset(st: StreamState) -> Coreset:
    """The current coreset, assembled from the delegate buffers."""
    tcap, slot_cap, d = st.dp.shape
    gamma = st.dc.shape[2]
    flat_valid = st.dv.reshape(-1) & torch.repeat_interleave(st.cvalid,
                                                             slot_cap)
    return Coreset(
        points=st.dp.reshape(-1, d),
        cats=st.dc.reshape(-1, gamma),
        valid=flat_valid,
        src_idx=torch.where(flat_valid, st.ds.reshape(-1), -1),
    )


class _Scan:
    """One ingest call over a state: the device tensors are updated in
    place, the decisions are taken on host copies (see the module
    docstring), which ``finish`` writes back."""

    def __init__(self, st: StreamState, spec: MatroidSpec, caps, k: int,
                 tau: int, variant: str, eps: float, c_const: int,
                 force: Optional[str]):
        if spec.kind not in _JIT_KINDS:
            raise ValueError(
                f"the streaming scan takes {_JIT_KINDS} matroids, got "
                f"{spec.kind!r}; use stream_coreset_host")
        if variant not in ("radius", "diameter"):
            raise ValueError(f"variant must be 'radius' or 'diameter', got "
                             f"{variant!r}")
        self.st, self.spec, self.k, self.tau = st, spec, k, tau
        self.dev = st.centers.device
        self.diameter = variant == "diameter"
        self.force = force
        self.caps = (np.zeros(1, np.int32) if caps is None
                     else np.asarray(caps.cpu() if torch.is_tensor(caps)
                                     else caps, np.int32).reshape(-1))
        self.h = max(spec.num_categories, 1)
        # float32 constants in the reference's order of operations
        self.eps = np.float32(eps)
        self.two_eps = np.float32(2.0 * eps)
        self.ck = np.float32(c_const * k)
        self.R = np.float32(st.R.item())
        self.n_seen = int(st.n_seen.item())
        self.overflow = int(st.overflow.item())
        self.cvalid = st.cvalid.cpu().numpy().copy()
        self.dv = st.dv.cpu().numpy().copy()
        self.dc = st.dc.cpu().numpy().copy()
        self.ds = st.ds.cpu().numpy().copy()
        self._cv = None  # device copy of cvalid, rebuilt after a change
        self._tables = None  # HANDLE count tables, rebuilt after a change

    def finish(self) -> StreamState:
        st = self.st
        st.R.fill_(float(self.R))
        st.n_seen.fill_(self.n_seen)
        st.overflow.fill_(self.overflow)
        for name in ("cvalid", "dv", "dc", "ds"):
            getattr(st, name).copy_(torch.from_numpy(getattr(self, name)))
        return st

    # -- state writes -----------------------------------------------------

    def cvalid_dev(self) -> torch.Tensor:
        if self._cv is None:
            self._cv = torch.from_numpy(self.cvalid.copy()).to(self.dev)
        return self._cv

    def _set_cvalid(self, cvalid: np.ndarray) -> None:
        self.cvalid = cvalid
        self._cv = None

    def open_center(self, x, xc, xsrc: int) -> None:
        free = np.flatnonzero(~self.cvalid)
        slot = int(free[0]) if free.size else 0  # all valid -> 0, as argmin
        cvalid = self.cvalid.copy()
        cvalid[slot] = True
        self._set_cvalid(cvalid)
        self.dv[slot, 0] = True
        self.dc[slot, 0] = xc
        self.ds[slot, 0] = xsrc
        self._tables = None
        self.st.centers[slot].copy_(x)
        self.st.dp[slot, 0].copy_(x)

    def handle(self, z: int, x, xc: np.ndarray, xsrc: int) -> bool:
        """Alg. 2 HANDLE(x, z, D_z); returns whether x was added."""
        k = self.k
        slots_v = self.dv[z]
        cnt = int(slots_v.sum())
        free = np.flatnonzero(~slots_v)
        has_room = free.size > 0
        kind = self.spec.kind
        if kind == "uniform":
            add = cnt < k
        elif kind == "partition":
            c = int(xc[0])
            same = int(np.sum(slots_v & (self.dc[z, :, 0] == c)))
            cap = int(self.caps[_clamped(c, self.caps.size)])
            add = cnt < k and same < cap
        else:  # transversal
            match = ((self.dc[z][:, :, None] == xc[None, None, :])
                     & (xc[None, None, :] >= 0))
            holds = np.any(match, axis=1) & slots_v[:, None]
            short = (holds.sum(axis=0) < k) & (xc >= 0)
            add = bool(short.any())
            self.overflow += int(add and not has_room)
        if not (add and has_room):
            return False
        fs = int(free[0])
        self.dv[z, fs] = True
        self.dc[z, fs] = xc
        self.ds[z, fs] = xsrc
        self._tables = None
        self.st.dp[z, fs].copy_(x)
        if kind == "transversal":
            # shrink: a greedy matching covering k slots witnesses an
            # independent size-k subset; keep exactly those slots
            _used, matched = greedy_matching_slots(
                self.dc[z], self.dv[z], self.spec.num_categories)
            if matched.sum() >= k:
                self.dv[z] &= matched
        return True

    def _filter_centers(self, thr: np.float32) -> np.ndarray:
        """Greedy maximal subset of centers with pairwise distance > thr."""
        c = self.st.centers
        d = torch.sqrt(torch.clamp_min(
            torch.sum((c[:, None, :] - c[None, :, :]) ** 2, dim=-1), 0.0))
        d = d.cpu().numpy()
        tcap = d.shape[0]
        keep = np.zeros(tcap, bool)
        for i in range(tcap):
            near_kept = np.any(keep[:i] & self.cvalid[:i] & (d[i, :i] <= thr))
            keep[i] = self.cvalid[i] and not near_kept
        return keep

    def _filter_and_merge(self, thr: np.float32) -> None:
        """Restructure: keep a thr-separated subset of the centers and
        HANDLE the dead centers' delegates into their nearest survivor."""
        global restructures
        restructures += 1
        keep = self._filter_centers(thr)
        dead = self.cvalid & ~keep
        self._set_cvalid(keep)
        cells = [(ci, si) for ci in np.flatnonzero(dead)
                 for si in np.flatnonzero(self.dv[ci])]
        if cells:
            st, cv = self.st, self.cvalid_dev()
            zs = torch.stack([
                torch.argmin(_dists_to_centers(st.dp[ci, si], st.centers, cv))
                for ci, si in cells
            ]).tolist()
            for (ci, si), z in zip(cells, zs):
                self.handle(z, st.dp[ci, si], self.dc[ci, si].copy(),
                            int(self.ds[ci, si]))
        self.dv[dead] = False
        self._tables = None

    def _thr_new(self) -> np.float32:
        if self.diameter:
            return self.two_eps * self.R / self.ck
        return np.float32(2.0) * self.R

    # -- the per-point step ------------------------------------------------

    def step(self, x, xc: np.ndarray, xsrc: int) -> bool:
        """Alg. 2 on one valid point; returns whether any input of the
        block precheck (centers, cvalid, dv, dc, R, x1) may have changed."""
        st, t = self.st, self.n_seen
        self.n_seen = t + 1
        if t == 0:
            self.open_center(x, xc, xsrc)
            st.x1.copy_(x)
            return True
        if t == 1:
            r0 = np.float32(_point_dist(x, st.x1).item())
            self.open_center(x, xc, xsrc)
            r = r0 if self.diameter else r0 / np.float32(2.0)
            self.R = np.maximum(r, np.float32(1e-30))
            return True
        dists = _dists_to_centers(x, st.centers, self.cvalid_dev())
        z = torch.argmin(dists)
        pulled = [z.to(torch.float64), dists[z].to(torch.float64)]
        if self.diameter:
            pulled.append(_point_dist(x, st.x1).to(torch.float64))
        z, dmin, *d1 = torch.stack(pulled).tolist()
        opened = dmin > self._thr_new()
        added = False
        if opened:
            self.open_center(x, xc, xsrc)
        else:
            added = self.handle(int(z), x, xc, xsrc)
        if self.diameter:
            trigger = d1[0] > np.float32(2.0) * self.R
            if trigger:
                self.R = np.float32(d1[0])
                self._filter_and_merge(self.eps * self.R / self.ck)
            return opened or added or trigger
        while self.cvalid.sum() > self.tau:  # radius variant
            self.R = self.R * np.float32(2.0)
            self._filter_and_merge(self.R)
        # an over-tau count only ever follows an open
        return opened or added

    # -- the blocked scan --------------------------------------------------

    def _count_tables(self):
        if self._tables is None:
            dv, dc, h = self.dv, self.dc, self.h
            tables = dict(cnt=dv.sum(axis=1), full=dv.all(axis=1))
            cats = np.arange(h)
            if self.spec.kind == "partition":
                tables["same"] = np.sum(
                    (dc[:, :, 0, None] == cats) & dv[:, :, None], axis=1)
            elif self.spec.kind == "transversal":
                holds = (np.any(dc[:, :, :, None] == cats, axis=2)
                         & dv[:, :, None])
                tables["cnt_h"] = holds.sum(axis=1)
            self._tables = tables
        return self._tables

    def precheck(self, xb, xcb: np.ndarray, vb: np.ndarray):
        """Which points of the block would change the state, against the
        current state (reference ``_block_precheck``). Returns host arrays
        (active bool[B], forced int[B]): an inactive valid point's whole
        effect is ``n_seen += 1`` and ``overflow += forced``."""
        st = self.st
        x1 = r2 = None
        if self.diameter:
            x1, r2 = st.x1, float(np.float32(2.0) * self.R)
        # replay: an exact candidate tie, a third center within the
        # precheck's margin, the open threshold (and the R update); and the
        # rounding band (kernels.ref.block_precheck)
        z, flags = _ops.block_precheck(
            xb, st.centers, self.cvalid_dev(), x1, float(self._thr_new()),
            r2, force=self.force, device=self.dev).cpu().numpy()
        flags = flags.astype(bool)

        k, h, tab = self.k, self.h, self._count_tables()
        has_room = ~tab["full"][z]
        add = tab["cnt"][z] < k
        forced = np.zeros(z.shape[0], np.int64)
        oob = np.zeros(z.shape[0], bool)
        if self.spec.kind == "partition":
            c = xcb[:, 0]
            oob = (c < 0) | (c >= h)
            cs = np.clip(c, 0, h - 1)
            cap = self.caps[np.minimum(cs, self.caps.size - 1)]
            add = add & (tab["same"][z, cs] < cap)
        elif self.spec.kind == "transversal":
            oob = np.any(xcb >= h, axis=1)  # -1 padding is masked below
            cnts = tab["cnt_h"][z[:, None], np.clip(xcb, 0, h - 1)]
            want = np.any((cnts < k) & (xcb >= 0), axis=1)
            add = want
            forced = (want & ~has_room & ~oob).astype(np.int64)
        add = add & has_room
        return (flags | add | oob) & vb, forced

    def scan_points(self, points, cats, src, valid) -> None:
        """The per-point scan (``block_size=1``)."""
        for i in np.flatnonzero(valid):
            self.step(points[i], cats[i], int(src[i]))

    def scan_blocks(self, points, cats, src, valid, B: int) -> None:
        """B points per step: the precheck bulk-skips no-op points and only
        active points replay the per-point step. The last block is partial;
        the stream is not padded."""
        global blocks, replays, recomputes
        n = points.shape[0]
        idx = np.arange(B)
        for b0 in range(0, n, B):
            b1 = min(n, b0 + B)
            vb = valid[b0:b1]
            if not vb.any():
                continue  # nothing to consume
            blocks += 1
            xb, xcb, ii = points[b0:b1], cats[b0:b1], idx[:b1 - b0]
            active, forced = self.precheck(xb, xcb, vb)
            vi = vb.astype(np.int64)
            first2 = vb & (self.n_seen + np.cumsum(vi) - vi < 2)
            if not np.any(active | first2):
                self.n_seen += int(vi.sum())
                self.overflow += int(forced[vb].sum())
                continue
            i, nb, dirty = 0, b1 - b0, False
            while i < nb:
                if dirty:
                    recomputes += 1
                    active, forced = self.precheck(xb, xcb, vb)
                vrem = vb & (ii >= i)
                vr = vrem.astype(np.int64)
                act = (active & (ii >= i)) | (
                    vrem & (self.n_seen + np.cumsum(vr) - vr < 2))
                f = int(np.argmax(act)) if act.any() else nb
                skip = vrem & (ii < f)
                self.n_seen += int(skip.sum())
                self.overflow += int(forced[skip].sum())
                dirty = False
                if f < nb:
                    replays += 1
                    dirty = self.step(xb[f], xcb[f], int(src[b0 + f]))
                i = f + 1


def _host(a, dtype) -> np.ndarray:
    return np.asarray(a.cpu() if torch.is_tensor(a) else a, dtype)


def _ingest_core(st: StreamState, points, cats, valid, src,
                 spec: MatroidSpec, caps, k: int, tau: int, variant: str,
                 eps: float, c_const: int, block_size: int, step_impl: str,
                 force: Optional[str]) -> StreamState:
    if step_impl not in STEP_IMPLS:
        raise ValueError(
            f"step_impl must be one of {STEP_IMPLS}, got {step_impl!r}")
    points = torch.as_tensor(points, dtype=torch.float32,
                             device=st.centers.device).contiguous()
    n = points.shape[0]
    cats = _host(cats, np.int32).reshape(n, -1)
    if cats.shape[1] != st.dc.shape[2]:
        raise ValueError(f"cats have {cats.shape[1]} columns, the state "
                         f"{st.dc.shape[2]}")
    valid = _host(valid, bool).reshape(n)
    scan = _Scan(st, spec, caps, k, tau, variant, eps, c_const, force)
    if block_size <= 1:
        scan.scan_points(points, cats, src, valid)
    else:
        scan.scan_blocks(points, cats, src, valid, block_size)
    return scan.finish()


def ingest_batch_donated(
    st0: StreamState,
    points,
    cats,
    valid,
    spec: MatroidSpec,
    caps,
    k: int,
    tau: int,
    *,
    base_index: int = 0,
    variant: str = "radius",
    eps: float = 0.5,
    c_const: int = 32,
    block_size: int = 128,
    step_impl: str = "branchless",
    src=None,
    force: Optional[str] = None,
) -> StreamState:
    """Resume the Alg.-2 scan over one batch of the stream, in place: the
    state passed in is consumed (its tensors are updated and returned).

    ``base_index`` offsets the delegates' stream indices (or ``src`` gives
    them) so they stay global across batches; the concatenation of batches
    gives the state of one pass, bit for bit. ``block_size > 1`` is the
    blocked scan, the same state as ``block_size=1``. Points run on the
    state's device; ``force`` picks the precheck's path
    (``ops.block_precheck``: None, "ref" or "exact"), which changes no
    decision.
    """
    n = int(points.shape[0])
    src = (np.int32(base_index) + np.arange(n, dtype=np.int32)
           if src is None else _host(src, np.int32).reshape(n))
    return _ingest_core(st0, points, cats, valid, src, spec, caps, k, tau,
                        variant, eps, c_const, block_size, step_impl, force)


def ingest_batch(st0: StreamState, *args, **kwargs) -> StreamState:
    """``ingest_batch_donated`` on a copy of the state: the caller's state
    is left as it was, as with the reference's non-donated call."""
    st = StreamState(*(t.clone() for t in st0))
    return ingest_batch_donated(st, *args, **kwargs)


def init_sharded_states(
    num_shards: int,
    d: int,
    gamma: int,
    spec: MatroidSpec,
    k: int,
    tau: int,
    *,
    slot_cap: Optional[int] = None,
    device: DeviceLike = CUDA,
) -> StreamState:
    """``num_shards`` empty scan states stacked along a leading shard axis
    on ``device`` -- the carry of ``ingest_batch_sharded``."""
    st = init_stream_state(d, gamma, spec, k, tau, slot_cap=slot_cap,
                           device=device)
    return StreamState(*(
        t.unsqueeze(0).repeat((num_shards,) + (1,) * t.dim()) for t in st))


def shard_lane(sts: StreamState, s: int) -> StreamState:
    """Shard ``s`` of a stacked state, as views: writes to the lane land
    in the stacked tensors."""
    return StreamState(*(t[s] for t in sts))


def ingest_batch_sharded_donated(
    sts: StreamState,  # stacked: every field has a leading shard axis S
    points,  # (S, m, d)
    cats,  # (S, m, gamma)
    valid,  # (S, m)
    src,  # (S, m) global stream indices
    spec: MatroidSpec,
    caps,
    k: int,
    tau: int,
    *,
    variant: str = "radius",
    eps: float = 0.5,
    c_const: int = 32,
    block_size: int = 128,
    step_impl: str = "branchless",
    force: Optional[str] = None,
) -> StreamState:
    """Every shard runs its own Alg.-2 scan over its row of the batch, in
    place (the stacked state passed in is consumed). Per-shard results are
    bit-identical to ``ingest_batch`` on that shard's sub-stream alone
    (paper §3: coresets of a partition compose by union)."""
    S = sts.cvalid.shape[0]
    points = torch.as_tensor(points, dtype=torch.float32,
                             device=sts.centers.device)
    if points.dim() != 3 or points.shape[0] != S:
        raise ValueError(f"points must be (S={S}, m, d), got "
                         f"{tuple(points.shape)}")
    cats = _host(cats, np.int32).reshape(S, points.shape[1], -1)
    valid = _host(valid, bool).reshape(S, -1)
    src = _host(src, np.int32).reshape(S, -1)
    for s in range(S):
        _ingest_core(shard_lane(sts, s), points[s], cats[s], valid[s],
                     src[s], spec, caps, k, tau, variant, eps, c_const,
                     block_size, step_impl, force)
    return sts


def ingest_batch_sharded(sts: StreamState, *args, **kwargs) -> StreamState:
    """``ingest_batch_sharded_donated`` on a copy of the stacked state."""
    return ingest_batch_sharded_donated(
        StreamState(*(t.clone() for t in sts)), *args, **kwargs)


PLACEMENTS = ("auto", "vmap", "shard_map", "pipeline")


def resolve_placement(placement: str, num_shards: int,
                      device: DeviceLike = CUDA) -> str:
    """Resolve the sharded-ingest drive (reference ``resolve_placement``).

    ``vmap``      the batch dealt row by row round-robin over a stacked
                  state on one device, its lanes driven in turn;
    ``pipeline``  whole batches dealt round-robin over a list of per-shard
                  states, dealt round robin over the visible cards; each
                  ingest is the plain blocked scan of one shard;
    ``shard_map`` the row-granular deal of ``vmap``, its lanes in
                  contiguous groups over ``mesh_device_count(S)`` cards
                  (``ingest_batch_sharded_mapped``).

    ``auto``: ``vmap`` for one shard, ``pipeline`` on the CPU, otherwise
    ``shard_map`` when more than one card can take a whole shard, else
    ``vmap``.
    """
    if placement not in PLACEMENTS:
        raise ValueError(
            f"placement must be one of {PLACEMENTS}, got {placement!r}")
    if placement != "auto":
        return placement
    if num_shards <= 1:
        return "vmap"
    if torch.device(device).type == "cpu":
        return "pipeline"
    return "shard_map" if mesh_device_count(num_shards) > 1 else "vmap"


def mesh_device_count(num_shards: int,
                      n_devices: Optional[int] = None) -> int:
    """Largest device count <= ``n_devices`` (default: the visible cards,
    at least 1) that divides ``num_shards``: each device must own an equal,
    whole number of shard states."""
    if n_devices is None:
        n_devices = (torch.cuda.device_count()
                     if torch.cuda.is_available() else 1)
    nd = max(1, min(int(n_devices), int(num_shards)))
    while num_shards % nd:
        nd -= 1
    return nd


def visible_devices(device: DeviceLike) -> list[torch.device]:
    """The devices a placement may deal shard states over: every visible
    card for a CUDA ``device``, else ``device`` alone."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def ingest_batch_sharded_mapped(
    sts: StreamState,  # stacked: every field has a leading shard axis S
    points,  # (S, m, d)
    cats,  # (S, m, gamma)
    valid,  # (S, m)
    src,  # (S, m) global stream indices
    spec: MatroidSpec,
    caps,
    k: int,
    tau: int,
    *,
    donate: bool = False,
    devices: Optional[list] = None,
    **kwargs,
) -> StreamState:
    """The ``shard_map`` drive: the S lanes are dealt in contiguous groups
    over
    ``mesh_device_count(S, len(devices))`` devices (``devices`` defaults
    to ``visible_devices`` of the state's device), and each group runs
    ``ingest_batch_sharded_donated`` on its device: on the state's device
    as views of the stacked tensors, elsewhere on a copy written back
    after. Per-shard results are bit for bit those of
    ``ingest_batch_sharded``; on one device it is that drive. As in the
    reference, ``donate=True`` consumes ``sts`` (updated in place and
    returned) and the default works on a copy. Keyword arguments are
    ``ingest_batch_sharded_donated``'s."""
    if not donate:
        sts = StreamState(*(t.clone() for t in sts))
    S = sts.cvalid.shape[0]
    home = sts.centers.device
    devs = visible_devices(home) if devices is None else [
        torch.device(d) for d in devices]
    nd = mesh_device_count(S, len(devs))
    if nd == 1:
        return ingest_batch_sharded_donated(
            sts, points, cats, valid, src, spec, caps, k, tau, **kwargs)
    per = S // nd
    points = torch.as_tensor(points, dtype=torch.float32)
    cats = _host(cats, np.int32).reshape(S, points.shape[1], -1)
    valid = _host(valid, bool).reshape(S, -1)
    src = _host(src, np.int32).reshape(S, -1)
    for g in range(nd):
        lo, hi = g * per, (g + 1) * per
        group = StreamState(*(t[lo:hi].to(devs[g]) for t in sts))
        ingest_batch_sharded_donated(
            group, points[lo:hi].to(devs[g]), cats[lo:hi], valid[lo:hi],
            src[lo:hi], spec, caps, k, tau, **kwargs)
        for t, u in zip(sts, group):
            if u.data_ptr() != t[lo:hi].data_ptr():
                t[lo:hi].copy_(u)
    return sts


def stream_coreset(
    points,  # (n, d) metric-normalized stream order
    cats,  # (n, gamma)
    valid,  # (n,)
    spec: MatroidSpec,
    caps,
    k: int,
    tau: int,
    *,
    slot_cap: Optional[int] = None,
    variant: str = "radius",
    eps: float = 0.5,
    c_const: int = 32,
    block_size: int = 128,
    step_impl: str = "branchless",
    force: Optional[str] = None,
    device: DeviceLike = CUDA,
) -> tuple[Coreset, StreamState]:
    """One-pass streaming coreset: init + one ingest + snapshot.

    The reference defaults to ``block_size=1`` because its one-shot pass
    would pay the blocked graph's larger compile. Eager PyTorch compiles
    nothing, and a per-point pass costs one host round trip per point, so
    the default here is 128; the blocked scan gives the same state.
    """
    dev = resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n, d = points.shape
    gamma = _host(cats, np.int32).reshape(n, -1).shape[1]
    st0 = init_stream_state(d, gamma, spec, k, tau, slot_cap=slot_cap,
                            device=dev)
    st = ingest_batch_donated(
        st0, points, cats, valid, spec, caps, k, tau, variant=variant,
        eps=eps, c_const=c_const, block_size=block_size,
        step_impl=step_impl, force=force,
    )
    return snapshot_coreset(st), st


def stream_coreset_host(
    points: np.ndarray,
    cats: Optional[np.ndarray],
    matroid,
    k: int,
    tau: int,
) -> np.ndarray:
    """Host-loop streaming for general matroids (oracle-based HANDLE).

    HANDLE 'other' case of Alg. 2: always add; if D_z gains an independent
    subset of size k, shrink to it. Returns selected indices.
    """
    n, d = points.shape
    R = None
    centers: list[int] = []
    delegates: dict[int, list[int]] = {}

    def dist(i, j):
        return float(np.linalg.norm(points[i] - points[j]))

    for i in range(n):
        if len(centers) < 2:
            centers.append(i)
            delegates[i] = [i]
            if len(centers) == 2:
                R = dist(centers[0], centers[1]) / 2.0 or 1e-30
            continue
        dmin, z = min((dist(i, c), c) for c in centers)
        if dmin > 2.0 * R:
            centers.append(i)
            delegates[i] = [i]
        else:
            dz = delegates[z]
            sub = matroid.greedy_independent(dz, k)
            if len(sub) < k:
                dz.append(i)
                sub2 = matroid.greedy_independent(dz, k)
                if len(sub2) == k:
                    delegates[z] = sub2
        while len(centers) > tau:
            R *= 2.0
            kept: list[int] = []
            for c in centers:
                if all(dist(c, c2) > R for c2 in kept):
                    kept.append(c)
            dropped = [c for c in centers if c not in kept]
            centers = kept
            for c in dropped:
                for x in delegates.pop(c):
                    dmin, z = min((dist(x, c2), c2) for c2 in centers)
                    dz = delegates[z]
                    sub = matroid.greedy_independent(dz, k)
                    if len(sub) < k:
                        dz.append(x)
                        sub2 = matroid.greedy_independent(dz, k)
                        if len(sub2) == k:
                            delegates[z] = sub2
    out = sorted({x for dz in delegates.values() for x in dz})
    return np.asarray(out, np.int64)
