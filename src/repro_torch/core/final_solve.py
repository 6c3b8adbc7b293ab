"""Final-stage DMMC solver over a *precomputed* coreset distance matrix.

Reference: ``repro/core/final_solve.py``. The paper's split (§4.4): the
expensive combinatorial solver only ever sees the coreset, so the distance
matrix over the coreset is a small, reusable object:

    D = coreset_distance_matrix(coreset_points)     # K1 pdist on the card
    X, val = final_solve(D, matroid, k, variant)    # host solver, reads D only

The coreset rows stay on the device; only the (m, m) matrix crosses to the
host. The batched engines (``engine="jit_sum"``, or ``"auto"``, which
resolves to it for the sum variant) take D back to ``device``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..device import CUDA, DeviceLike, resolve_device
from ..kernels import ops as kernel_ops
from .diversity import Variant
from .matroid import Matroid
from .solvers import SolveContext, SolveSpec, resolve_engine, select_engine


def coreset_distance_matrix(
    points, *, force: Optional[str] = None, device: DeviceLike = CUDA,
    host: bool = True,
):
    """(m, d) -> (m, m) f32 Euclidean distances via the tiled pdist kernel:
    a host array, or (``host=False``) the tensor on ``device``.

    ``sqrt(max(., 0))`` stays outside the kernel, as in the reference, and
    so does the diagonal: the matmul form leaves cancellation noise there
    (d2 ~ 1e-7 |x|^2, up to ~1e-3 after the sqrt), which the host solvers'
    sum and star values include, in the reference too.
    """
    dev = resolve_device(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
    d2 = kernel_ops.pairwise_sqdist(pts, pts, force=force, device=dev)
    D = torch.sqrt(torch.clamp_min(d2, 0.0))
    return D.cpu().numpy() if host else D


class SubsetMatroidView(Matroid):
    """View of a host matroid restricted to ``sub`` with local indexing.

    Local index i stands for global element sub[i]; solvers run on local
    indices (rows of the coreset distance matrix), oracle queries are
    translated to the global ground set.
    """

    def __init__(self, matroid: Matroid, sub: np.ndarray):
        self.matroid = matroid
        self.sub = np.asarray(sub, np.int64)
        self.spec = matroid.spec

    def can_extend(self, idxs, x):
        return self.matroid.can_extend(
            [int(self.sub[i]) for i in idxs], int(self.sub[x])
        )

    def is_independent(self, idxs):
        return self.matroid.is_independent([int(self.sub[i]) for i in idxs])


def final_solve(
    D: np.ndarray,
    matroid: Matroid,
    k: int,
    variant: Variant,
    *,
    idxs: Optional[Sequence[int]] = None,
    gamma: float = 0.0,
    engine: str = "host",
    cats: Optional[np.ndarray] = None,
    caps: Optional[np.ndarray] = None,
    device: DeviceLike = CUDA,
) -> tuple[list[int], float]:
    """Best independent k-subset of ``idxs`` under ``variant``, reading only D.

    Dispatches through the ``core.solvers`` registry. ``engine="host"`` is
    the paper's dispatch (sum -> AMT local search, footnote 5; others ->
    exhaustive search, exact on the coreset); ``engine="auto"`` picks the
    registered engine of highest static priority with the host-parity
    guarantee (pass ``cats``/``caps`` so the batched engines are
    eligible); any registered engine name forces that engine.
    On the card ``auto`` is slower than ``"host"`` until a sweep is
    captured as a CUDA graph or made a kernel: on the songs-sim coreset
    (m = 327, k = 22, one H100) ``jit_sum`` took 0.92–0.96 s for one query
    against ~0.03 s for the host engine, and 0.82–1.22 s for 32 queries
    against the host's 0.89–1.02 s (``PERF.md`` §5). The batched engines
    run on ``device``. Returns (selected local indices, canonical float64
    diversity value); the engine that ran is the ``engine`` argument of
    the ``final_solve`` span (``obs.default_buffer()``).
    """
    ctx = SolveContext(
        D=np.asarray(D),
        spec=matroid.spec,
        cats=None if cats is None else np.asarray(cats, np.int32),
        caps=None if caps is None else np.asarray(caps, np.int32),
        matroid_fn=lambda _spec: matroid,
        device=device,
    )
    # idxs passes through as an explicit candidate order: host solvers'
    # tie-breaks are visit-order dependent, so the sequence (duplicates
    # included) reaches them unchanged
    spec = SolveSpec(
        k=k, variant=variant, gamma=gamma,
        idxs=None if idxs is None else tuple(int(i) for i in idxs),
    )
    if engine == "auto":
        eng = select_engine(ctx, spec)
    else:
        eng = resolve_engine(engine, ctx, spec)
    with obs.span("final_solve", cat="solve", engine=eng.name, k=k,
                  m=ctx.size):
        sol = eng.solve_one(ctx, spec)
    return [int(i) for i in sol.local_indices], float(sol.value)
