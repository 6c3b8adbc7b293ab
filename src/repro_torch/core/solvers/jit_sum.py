"""Batched sum-variant engine (uniform/partition/transversal).

Reference: ``repro/core/solvers/jit_sum.py``. ``solve_sum_batch`` answers
a batch of heterogeneous sum-diversity queries (per-query k, category
caps, candidate filters) against ONE cached coreset distance matrix: a
batched greedy seeding + masked first-improvement local search, mirroring
``solvers.local_search.local_search_sum`` step for step (same greedy
gains, same (v, u) scan order, the host's swap identity ``div - rowX[u] +
rowX[v] - D[u, v]``, X kept in insertion order, ``rowX = D @ selmask``
recomputed after a swap) so the batched path lands on the same local
optimum as the host solver on the same matrix.

Matroid feasibility inside the greedy/swap loops comes in two flavours,
chosen per matroid kind:

* uniform/partition — the O(1) ``counts < caps`` check (uniform is a
  single pseudo-category nobody caps);
* transversal — the masked augmenting-path primitives of
  ``solvers.matching``, which answer "can candidate v extend (or swap
  into) the current selection" exactly, as the host oracle does.

How the reference's vmapped loops translate (every piece of state carries
an explicit leading query dimension B):

* the ``fori_loop`` over candidates v is a Python loop over v;
* ``lax.cond``, a select under vmap, is ``torch.where`` on every piece of
  state: no host sync inside a sweep;
* the ``while_loop`` over sweeps keeps a per-query ``active = improved &
  (sweeps < max_sweeps)``; inactive queries keep their state, and one host
  read per sweep asks whether any query is still active.

JAX clamps an out-of-range gather and drops an out-of-range scatter;
PyTorch raises. Every index that can leave its range is clamped here: the
-1 padded slots, the swap target of a query that does not swap, and the
categories (padding queries have k = 0 and uncapped caps).

Products with the 0/1 selection mask (``D @ selmask``, the greedy gains,
the objective) accumulate in float64 and round once to D's dtype. The
float64 sum of f32 distances is exact while the terms span fewer than
about 53 - 24 - log2(terms) binary orders of magnitude, and otherwise
off by far less than one f32 unit, so the rounded row rarely depends on
the batch size, the device or the order a library sums in: a flip of
the f32 rounding is vanishingly rare, not impossible. The first greedy
gain (``rowsum_all``) sums all m terms of a row, the later rows at most
kmax. Card and CPU parity is observed on the inputs tried
(``tests/test_torch_cuda.py``, ``chip_smoke.py``), not guaranteed.
Nothing runs under TF32 (the CUDA entry points call
``device.disable_tf32()``).

Shapes are bucketed as in the reference: queries are padded to the
batch's ``kmax`` (the next power of two) and the batch to a power-of-two
length; infeasible queries stop early (nsel < k) like the host solver.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ... import obs
from ...device import disable_tf32, resolve_device
from ..diversity import Variant
from .base import (
    EngineSolution,
    SolveContext,
    SolveSpec,
    SolverEngine,
    selection_value,
)
from .matching import augment, cats_onehot, feasible_all, swap_feasible


def bucket_pow2(n: int) -> int:
    """Next power of two >= n (>= 1). Shape bucketing: a batch of 5
    queries with max k 6 runs at (8, 8), and so does any later batch with
    B <= 8, k <= 8 (and the compile-region key names that bucket)."""
    return 1 << max(0, int(n - 1).bit_length())


def engine_device(ctx: SolveContext) -> torch.device:
    """The context's device for a batched engine: raises for CUDA on a
    host without a card, and turns TF32 off on the card."""
    dev = resolve_device(ctx.device)
    if dev.type == "cuda":
        disable_tf32()
    return dev


def jit_cell_eligible(
    engine: SolverEngine, ctx: SolveContext, spec: SolveSpec
) -> bool:
    """Data-dependent eligibility shared by the batched engines."""
    if not engine.supports(spec.variant, ctx.spec.kind):
        return False
    if not spec.ascending_candidates(ctx.size):
        return False  # custom candidate order is host-solver territory
    if ctx.spec.kind != "uniform" and ctx.cats is None:
        return False  # the batched path needs the category matrix
    if ctx.spec.kind == "partition":
        # a partition matroid is single-label by definition; rows with a
        # second real label must go to the host oracle, which raises the
        # descriptive error (never truncate silently)
        if ctx.partition_multilabel():
            return False
        if ctx.caps is None and spec.caps is None:
            return False
    return True


def pad_query_arrays(
    ctx: SolveContext, specs: Sequence[SolveSpec], Bb: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(allow (Bb, m), ks (Bb,), gammas (Bb,)) with power-of-two padding
    rows that solve k=0 no-op queries."""
    m = ctx.size
    allow_b = np.zeros((Bb, m), bool)
    ks = np.zeros((Bb,), np.int32)
    gammas = np.zeros((Bb,), np.float32)
    for i, s in enumerate(specs):
        allow_b[i] = s.allow_mask(m)
        ks[i] = s.k
        gammas[i] = s.gamma
    return allow_b, ks, gammas


def partition_arrays(
    ctx: SolveContext, specs: Sequence[SolveSpec], Bb: int
) -> tuple[np.ndarray, np.ndarray]:
    """(cats1 (m,), caps_b (Bb, h)) for the counts<caps feasibility path;
    uniform matroids become one pseudo-category nobody caps."""
    m = ctx.size
    if ctx.spec.kind == "partition":
        cats1 = np.asarray(ctx.cats[:, 0], np.int32)
        h = ctx.spec.num_categories
        default_caps = ctx.caps
    else:  # uniform
        cats1 = np.zeros((m,), np.int32)
        h = 1
        default_caps = None
    caps_b = np.full((Bb, h), m + 1, np.int32)  # padding rows: uncapped
    for i, s in enumerate(specs):
        if s.caps is not None:
            caps_b[i] = np.asarray(s.caps, np.int32)
        elif default_caps is not None:
            caps_b[i] = default_caps
    return cats1, caps_b


def mask_rows(mask: torch.Tensor, Dt64: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """(B, m) rows ``D @ mask`` of each query's 0/1 ``mask``: float64
    accumulation (see the module docstring for when it is exact), one
    rounding to ``dtype``. ``Dt64`` is D transposed, in float64."""
    return (mask.to(torch.float64) @ Dt64).to(dtype)


class _Sum:
    """The shared greedy + local search over one matrix; a ``feas``
    object (``_Counts`` or ``_Matching``) supplies the matroid half."""

    def __init__(self, D: torch.Tensor, allow, ks, gammas, kmax: int):
        self.D = D
        self.Dt64 = D.t().to(torch.float64)
        self.DT = D.t().contiguous()  # DT[v] = column v of D
        self.allow, self.ks, self.kmax = allow, ks.long(), kmax
        self.g1 = 1.0 + gammas.to(D.dtype)
        B, m = allow.shape
        self.slots = torch.arange(kmax, device=D.device)
        self.cols = torch.arange(m, device=D.device)
        self.shift = (self.slots + 1).clamp_max(kmax - 1)
        self.rowsum_all = D.sum(1, dtype=torch.float64).to(D.dtype)

    def rows(self, selmask):
        return mask_rows(selmask, self.Dt64, self.D.dtype)

    def greedy(self, feas):
        """Mirror of local_search.greedy_init: max marginal-gain candidate
        per step (first index wins ties)."""
        D, allow = self.D, self.allow
        B, m = allow.shape
        sel = torch.full((B, self.kmax), -1, dtype=torch.long,
                         device=D.device)
        selmask = torch.zeros((B, m), dtype=torch.bool, device=D.device)
        nsel = torch.zeros((B,), dtype=torch.long, device=D.device)
        for i in range(self.kmax):
            can = allow & ~selmask & feas.can()
            gains = torch.where((nsel == 0)[:, None], self.rowsum_all,
                                self.rows(selmask))
            v = torch.where(can, gains, -torch.inf).argmax(1)
            take = (i < self.ks) & can.any(1)
            sel = torch.where(take[:, None] & (self.slots == nsel[:, None]),
                              v[:, None], sel)
            selmask = selmask | (take[:, None] & (self.cols == v[:, None]))
            feas.add(v, take)
            nsel = nsel + take.long()
        return sel, selmask, nsel

    def search(self, feas, max_sweeps: int):
        """Greedy seed + first-improvement local search. Returns (sel
        (B, kmax) -1 padded, nsel (B,), div (B,))."""
        sel, selmask, nsel = self.greedy(feas)
        rowX = self.rows(selmask)
        div = (0.5 * (rowX.to(torch.float64) * selmask).sum(1)).to(
            self.D.dtype)
        in_x = self.slots < nsel[:, None]
        last = (nsel - 1).clamp_min(0)[:, None]  # the slot v moves into
        active = nsel == self.ks
        sweeps = torch.zeros_like(nsel)
        while True:
            act = active & (sweeps < max_sweeps)
            if not bool(act.any()):  # the sweep's one host read
                break
            with obs.named_scope("solver/jit_sum/sweep"):
                sel, selmask, rowX, div, active = self.sweep(
                    sel, selmask, rowX, div, feas, act, in_x, last)
            sweeps = sweeps + act.long()
        return sel, nsel, div

    def sweep(self, sel, selmask, rowX, div, feas, act, in_x, last):
        """One pass over the candidates v; queries outside ``act`` keep
        their state. Returns the state and which queries swapped."""
        allow, slots = self.allow, self.slots
        improved = torch.zeros_like(act)
        for v in range(allow.shape[1]):
            u = sel.clamp_min(0)
            # div(X - u + v) = div - row[u] + dv - d(u, v)
            new_div = (div[:, None] - rowX.gather(1, u)
                       + rowX[:, v:v + 1] - self.DT[v][u])
            improving = (
                in_x
                & (new_div > (div * self.g1)[:, None])
                & (new_div > div[:, None])
                & feas.swap_ok(sel, u, v)
            )
            swap = act & allow[:, v] & ~selmask[:, v] & improving.any(1)
            ui = improving.to(torch.uint8).argmax(1, keepdim=True)
            uold = sel.gather(1, ui).clamp_min(0)  # (B, 1)
            # host order: X = [w for w in X if w != u] + [v]
            src = torch.where(slots >= ui, self.shift, slots)
            sel2 = sel.gather(1, src).scatter(1, last, v)
            selmask2 = selmask.scatter(1, uold, False)
            selmask2[:, v] = True
            feas.swap(uold, v, swap)
            w = swap[:, None]
            sel = torch.where(w, sel2, sel)
            selmask = torch.where(w, selmask2, selmask)
            rowX = torch.where(w, self.rows(selmask2), rowX)
            div = torch.where(swap, new_div.gather(1, ui)[:, 0], div)
            improved = improved | swap
        return sel, selmask, rowX, div, improved


class _Counts:
    """Partition/uniform feasibility: per-query category counts."""

    def __init__(self, cats, caps):
        h = caps.shape[1]
        B = caps.shape[0]
        self.cats = cats.long().clamp(0, h - 1)  # (m,)
        self.cats_host = self.cats.cpu().tolist()
        self.caps = caps.long()
        self.cap_of = self.caps.gather(1, self.cats.expand(B, -1))  # (B, m)
        self.counts = torch.zeros_like(self.caps)
        self.catsB = self.cats.expand(B, -1)

    def can(self):
        return self.counts.gather(1, self.catsB) < self.cap_of

    def add(self, v, take):
        self.counts = self.counts.scatter_add(1, self.cats[v][:, None],
                                              take.long()[:, None])

    def swap_ok(self, sel, u, v):
        c = self.cats_host[v]
        return (self.counts[:, c:c + 1] - (self.cats[u] == c).long() + 1
                <= self.caps[:, c:c + 1])

    def swap(self, uold, v, swap):
        c = self.cats_host[v]
        counts2 = self.counts.scatter_add(1, self.cats[uold],
                                          -torch.ones_like(uold))
        counts2[:, c] += 1
        self.counts = torch.where(swap[:, None], counts2, self.counts)


class _Matching:
    """Transversal feasibility: a per-query matching ``ms_pt`` (B, h)."""

    def __init__(self, oh, B: int, kmax: int):
        self.oh, self.kmax = oh, kmax
        self.ms = torch.full((B, oh.shape[1]), -1, dtype=torch.long,
                             device=oh.device)

    def can(self):
        return feasible_all(self.oh, self.ms, self.kmax)

    def add(self, v, take):
        self.ms = torch.where(take[:, None],
                              augment(self.oh, self.ms, v, self.kmax),
                              self.ms)

    def swap_ok(self, sel, u, v):
        return swap_feasible(self.oh, self.ms, sel, v)

    def swap(self, uold, v, swap):
        # rebuild the matching: free u's category, re-insert v
        ms2 = torch.where(self.ms == uold, -1, self.ms)
        ms2 = augment(self.oh, ms2, v, self.kmax)
        self.ms = torch.where(swap[:, None], ms2, self.ms)


def solve_sum_batch(
    D: torch.Tensor,  # (m, m) cached coreset distances
    cats: torch.Tensor,  # (m,) int single-label categories (zeros: uniform)
    caps: torch.Tensor,  # (B, h) per-query caps
    allow: torch.Tensor,  # (B, m) bool per-query candidate masks
    ks: torch.Tensor,  # (B,)
    gammas: torch.Tensor,  # (B,)
    *,
    kmax: int,
    max_sweeps: int = 64,
):
    """Batch of sum-DMMC queries on one matrix (uniform/partition), all
    tensors on one device. Returns (sel (B, kmax) local ids -1-padded,
    nsel (B,), div (B,))."""
    with obs.named_scope("solver/jit_sum"):
        run = _Sum(D, allow, ks, gammas, kmax)
        return run.search(_Counts(cats, caps), max_sweeps)


def solve_sum_batch_transversal(
    D: torch.Tensor,  # (m, m)
    oh: torch.Tensor,  # (m, h) bool point-category incidence
    allow: torch.Tensor,  # (B, m)
    ks: torch.Tensor,  # (B,)
    gammas: torch.Tensor,  # (B,)
    *,
    kmax: int,
    max_sweeps: int = 64,
):
    """Batch of sum-DMMC queries under ONE transversal matroid.
    Returns (sel (B, kmax) -1-padded, nsel (B,), div (B,))."""
    with obs.named_scope("solver/jit_sum_tv"):
        run = _Sum(D, allow, ks, gammas, kmax)
        return run.search(_Matching(oh, allow.shape[0], kmax), max_sweeps)


def engine_solutions(ctx, specs, sel, nsel, name: str) -> list[EngineSolution]:
    """EngineSolutions from a batched solver's (sel, nsel). The solver's
    own objective accumulates in f32; the indices are what it decided on,
    so the canonical f64 value is recomputed from them."""
    sel, nsel = sel.cpu().numpy(), nsel.cpu().numpy()
    out = []
    for i, s in enumerate(specs):
        loc = sel[i, : nsel[i]].astype(np.int64)
        out.append(
            EngineSolution(
                local_indices=loc,
                value=selection_value(ctx.D, loc, s.variant),
                engine=name,
            )
        )
    return out


class JitSumBatchEngine(SolverEngine):
    """Registry face of the two batched sum solvers above."""

    name = "jit_sum"
    priority = 10
    exact_parity = True  # mirrors host local search step for step

    def supports(self, variant: Variant, matroid_kind: str) -> bool:
        return variant == "sum" and matroid_kind in (
            "uniform", "partition", "transversal"
        )

    def eligible(self, ctx: SolveContext, spec: SolveSpec) -> bool:
        return jit_cell_eligible(self, ctx, spec)

    def stack_eligible(self, ctx: SolveContext, spec: SolveSpec) -> bool:
        # local import: stacked.py reuses this module's row solver
        from .stacked import counts_stack_eligible

        return counts_stack_eligible(self, ctx, spec)

    def solve_batch_stacked(self, lanes) -> "list[list[EngineSolution]]":
        from .stacked import solve_stacked

        return solve_stacked(lanes)

    def solve_batch(
        self, ctx: SolveContext, specs: Sequence[SolveSpec]
    ) -> list[EngineSolution]:
        dev = engine_device(ctx)
        Bb = bucket_pow2(len(specs))
        kmax = bucket_pow2(max((s.k for s in specs), default=1))
        allow_b, ks, gammas = pad_query_arrays(ctx, specs, Bb)

        def put(a):
            return torch.as_tensor(a, device=dev)

        if ctx.spec.kind == "transversal":
            oh = cats_onehot(ctx.cats, ctx.spec.num_categories)
            with obs.compile_region(
                f"solve[jit_sum_tv B={Bb} kmax={kmax} m={ctx.size}]"
            ):
                sel, nsel, _div = solve_sum_batch_transversal(
                    put(ctx.D), put(oh), put(allow_b), put(ks), put(gammas),
                    kmax=kmax,
                )
        else:
            cats1, caps_b = partition_arrays(ctx, specs, Bb)
            with obs.compile_region(
                f"solve[jit_sum B={Bb} kmax={kmax} m={ctx.size}]"
            ):
                sel, nsel, _div = solve_sum_batch(
                    put(ctx.D), put(cats1), put(caps_b), put(allow_b),
                    put(ks), put(gammas), kmax=kmax,
                )
        return engine_solutions(ctx, specs, sel, nsel, self.name)
