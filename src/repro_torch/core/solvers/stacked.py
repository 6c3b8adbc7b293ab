"""Cross-tenant stacked solves: one call for a mixed window.

Reference: ``repro/core/solvers/stacked.py``. Tenants of one serving
frontend answer over the *same* published epoch: their cache entries
share the coreset rows and differ only in the pdist matrix (metric
normalization) and the matroid view (cats/caps). For the counts-family
``jit_sum`` solver every row is composition-independent — a row's greedy
+ local-search decisions read only its own ``(D, cats, caps, allow, k,
gamma)`` leaves — so a window holding queries for several tenants can
execute as one stacked call instead of one call per tenant.

Bit-identity (the parity contract ``tests/test_torch_stacked_solve.py``
pins): ``solve_stacked`` runs each lane through the per-tenant
``JitSumBatchEngine.solve_batch`` on the lane's own ``(m, m)`` matrix,
so a lane's answers are the per-tenant call's by construction. Lanes are
never batched into one ``bmm``: the reference records that a batched
matmul accumulates in another order and flips greedy argmax decisions on
tie-heavy data. The reference packs the lanes into padded ``(T, ...)``
arrays for one compiled launch; eager PyTorch has no compile cache for
that packing to serve, so the port runs the lanes one after another
until a CUDA graph or a kernel batches them.
``solve_sum_batch_stacked`` keeps the reference's array-level face
(a loop over lanes of ``jit_sum.solve_sum_batch``).

Scope: ``variant="sum"`` under uniform/partition matroids (the counts
``counts < caps`` feasibility path). Transversal lanes carry a
per-tenant one-hot incidence whose width varies; host engines have no
batched solver at all — both fall back to per-tenant dispatch in the
frontend.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ... import obs
from .base import (
    EngineSolution,
    SolveContext,
    SolveSpec,
    SolverEngine,
    get_engine,
)
from .jit_sum import engine_device, jit_cell_eligible, solve_sum_batch

# one tenant lane of a stacked solve: (context, specs routed to it)
Lane = tuple[SolveContext, Sequence[SolveSpec]]


def counts_stack_eligible(
    engine: SolverEngine, ctx: SolveContext, spec: SolveSpec
) -> bool:
    """Can this request ride a stacked counts-family call?  The batched
    cell eligibility rules apply unchanged; transversal is excluded
    because its one-hot incidence width is a per-tenant shape."""
    if ctx.spec.kind not in ("uniform", "partition"):
        return False
    return jit_cell_eligible(engine, ctx, spec)


def solve_sum_batch_stacked(
    Ds: torch.Tensor,  # (T, m, m) per-lane cached distances
    cats_s: torch.Tensor,  # (T, m) int single-label categories
    caps: torch.Tensor,  # (T, Bt, h) per-row caps
    allow: torch.Tensor,  # (T, Bt, m) per-row candidate masks
    ks: torch.Tensor,  # (T, Bt)
    gammas: torch.Tensor,  # (T, Bt)
    *,
    kmax: int,
    max_sweeps: int = 64,
):
    """T tenant lanes of Bt sum-DMMC rows each. Returns (sel (T, Bt,
    kmax) -1-padded, nsel (T, Bt), div (T, Bt)): lane t is
    ``solve_sum_batch`` on lane t's own (m, m) matrix, as the
    reference's ``lax.scan`` over lanes is."""
    outs = [
        solve_sum_batch(Ds[t], cats_s[t], caps[t], allow[t], ks[t],
                        gammas[t], kmax=kmax, max_sweeps=max_sweeps)
        for t in range(Ds.shape[0])
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def solve_stacked(lanes: Sequence[Lane]) -> list[list[EngineSolution]]:
    """Answer several single-tenant spec groups in one call.

    Every lane must be counts-stack eligible (caller's responsibility —
    see ``counts_stack_eligible``) and share the coreset size, the D
    dtype and the device. Returns per-lane solution lists in lane order,
    each the lane's own ``JitSumBatchEngine.solve_batch``.
    """
    if not lanes:
        return []
    m = lanes[0][0].size
    dtype = np.asarray(lanes[0][0].D).dtype
    for ctx, _specs in lanes:
        if ctx.size != m:
            raise ValueError(
                f"stacked lanes must share the coreset size: {ctx.size} != {m}"
            )
        if np.asarray(ctx.D).dtype != dtype:
            raise ValueError(
                "stacked lanes must share the distance dtype: "
                f"{np.asarray(ctx.D).dtype} != {dtype}"
            )
    devs = {engine_device(ctx) for ctx, _specs in lanes}
    if len(devs) != 1:
        raise ValueError(f"stacked lanes must share the device: {devs}")
    engine = get_engine("jit_sum")
    with obs.named_scope("solver/jit_sum_stacked"):
        return [engine.solve_batch(ctx, specs) for ctx, specs in lanes]
