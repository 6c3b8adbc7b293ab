"""The port's solver engines against the JAX package's, on the CPU.

The batched engines (``jit_sum``, ``jit_greedy``), the matching
primitives and the registry of ``repro_torch.core.solvers`` take the same
numpy inputs (tie-free clustered points from ``conftest``) as
``repro.core.solvers``: selections and counts must be equal, objectives
within 1e-5 relative, boolean outputs equal. Then the port's twins of
``tests/test_solvers.py`` (registry, dispatch policy, cross-engine
parity, kmax bucketing, the multi-label partition guard), each also held
against the reference where both answer the same question.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

import repro.core.solvers as jsolvers
from conftest import make_clustered_points
from repro.core import solve_dmmc as jsolve_dmmc
from repro.core import matroid as jmatroid
from repro.core.diversity import jnp_diversity
from repro.core.matroid import MatroidSpec as JMatroidSpec
from repro.core.solvers import jit_greedy as jgreedy
from repro.core.solvers import jit_sum as jsum
from repro.core.solvers import matching as jmatching
from repro_torch import obs
from repro_torch.core import solve_dmmc, torch_diversity
from repro_torch.core.diversity import VARIANTS, diversity
from repro_torch.core.matroid import (
    MatroidSpec,
    PartitionMatroid,
    TransversalMatroid,
    UniformMatroid,
)
from repro_torch.core.solvers import (
    MATROID_KINDS,
    EngineSolution,
    SolveContext,
    SolveSpec,
    SolverEngine,
    coverage_matrix,
    get_engine,
    partition_by_engine,
    register_engine,
    registered_engines,
    resolve_engine,
    select_engine,
    selection_value,
)
from repro_torch.core.solvers import base as solvers_base
from repro_torch.core.solvers import jit_greedy, jit_sum, matching
from repro_torch.core.solvers.jit_sum import bucket_pow2

CPU = "cpu"
REL = 1e-5


def _dist(P):
    D = np.sqrt(((P[:, None] - P[None, :]) ** 2).sum(-1)).astype(np.float32)
    np.fill_diagonal(D, 0.0)
    return D


def _ctx_for(kind, rng, m=32, h=4, gamma=2):
    """Random coreset-sized contexts over one matrix: (port, reference),
    the port's on the CPU."""
    P = make_clustered_points(rng, n=m, d=5)
    D = _dist(P)
    if kind == "uniform":
        spec, jspec = MatroidSpec("uniform"), JMatroidSpec("uniform")
        cats = caps = None
        fn = lambda s: UniformMatroid(m, s.k)  # noqa: E731
        jfn = lambda s: jmatroid.UniformMatroid(m, s.k)  # noqa: E731
    elif kind == "partition":
        cats = rng.integers(0, h, (m, 1)).astype(np.int32)
        caps = np.full(h, 2, np.int32)
        spec = MatroidSpec("partition", num_categories=h, gamma=1)
        jspec = JMatroidSpec("partition", num_categories=h, gamma=1)
        fn = lambda s: PartitionMatroid(  # noqa: E731
            cats, caps if s.caps is None else np.asarray(s.caps))
        jfn = lambda s: jmatroid.PartitionMatroid(  # noqa: E731
            cats, caps if s.caps is None else np.asarray(s.caps))
    elif kind == "transversal":
        cats = np.full((m, gamma), -1, np.int32)
        cats[:, 0] = rng.integers(0, h, m)
        extra = rng.random(m) < 0.4
        cats[extra, 1] = rng.integers(0, h, extra.sum())
        caps = None
        spec = MatroidSpec("transversal", num_categories=h, gamma=gamma)
        jspec = JMatroidSpec("transversal", num_categories=h, gamma=gamma)
        fn = lambda s: TransversalMatroid(cats, h)  # noqa: E731
        jfn = lambda s: jmatroid.TransversalMatroid(cats, h)  # noqa: E731
    else:
        raise ValueError(kind)
    ctx = SolveContext(D=D, spec=spec, cats=cats, caps=caps, matroid_fn=fn,
                       device=CPU)
    jctx = jsolvers.SolveContext(D=D, spec=jspec, cats=cats, caps=caps,
                                 matroid_fn=jfn)
    return ctx, jctx


def _batch(rng, m, h, B, kmax):
    cats = rng.integers(0, h, m).astype(np.int32)
    caps = rng.integers(1, 4, (B, h)).astype(np.int32)
    allow = rng.random((B, m)) < 0.8
    ks = rng.integers(2, kmax + 1, B).astype(np.int32)
    gammas = np.where(rng.random(B) < 0.5, 0.0, 0.01).astype(np.float32)
    oh = matching.cats_onehot(
        np.stack([cats, np.where(rng.random(m) < 0.4,
                                 rng.integers(0, h, m), -1)], 1), h)
    return cats, caps, allow, ks, gammas, oh


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _assert_same_batch(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if len(got) > 2:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=REL, atol=REL)


# --------------------------------------------------------------------------
# the batched solvers against the reference's, array for array
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed,m,B,kmax", [(0, 40, 8, 8), (1, 33, 3, 4),
                                           (2, 64, 16, 8)])
def test_solve_sum_batch_matches_jax(seed, m, B, kmax):
    rng = np.random.default_rng(seed)
    D = _dist(make_clustered_points(rng, n=m, d=5))
    cats, caps, allow, ks, gammas, _oh = _batch(rng, m, 4, B, kmax)
    got = jit_sum.solve_sum_batch(*_t(D, cats, caps, allow, ks, gammas),
                                  kmax=kmax)
    want = jsum.solve_sum_batch(*map(jnp.asarray, (D, cats, caps, allow, ks,
                                                   gammas)), kmax=kmax)
    _assert_same_batch(got, want)


@pytest.mark.parametrize("seed,m,B,kmax", [(3, 40, 8, 8), (4, 30, 4, 4)])
def test_solve_sum_batch_transversal_matches_jax(seed, m, B, kmax):
    rng = np.random.default_rng(seed)
    D = _dist(make_clustered_points(rng, n=m, d=5))
    _c, _caps, allow, ks, gammas, oh = _batch(rng, m, 4, B, kmax)
    got = jit_sum.solve_sum_batch_transversal(*_t(D, oh, allow, ks, gammas),
                                              kmax=kmax)
    want = jsum.solve_sum_batch_transversal(
        *map(jnp.asarray, (D, oh, allow, ks, gammas)), kmax=kmax)
    _assert_same_batch(got, want)


@pytest.mark.parametrize("variant", ["star", "tree"])
@pytest.mark.parametrize("transversal", [False, True])
def test_solve_greedy_batch_matches_jax(variant, transversal):
    rng = np.random.default_rng(5)
    m, B, kmax = 36, 8, 8
    D = _dist(make_clustered_points(rng, n=m, d=5))
    cats, caps, allow, ks, _g, oh = _batch(rng, m, 4, B, kmax)
    if transversal:
        got = jit_greedy.solve_greedy_batch_transversal(
            *_t(D, oh, allow, ks), variant=variant, kmax=kmax)
        want = jgreedy.solve_greedy_batch_transversal(
            *map(jnp.asarray, (D, oh, allow, ks)), variant=variant,
            kmax=kmax)
    else:
        got = jit_greedy.solve_greedy_batch(
            *_t(D, cats, caps, allow, ks), variant=variant, kmax=kmax)
        want = jgreedy.solve_greedy_batch(
            *map(jnp.asarray, (D, cats, caps, allow, ks)), variant=variant,
            kmax=kmax)
    _assert_same_batch(got, want)


_j_feasible_all = jax.jit(jmatching.feasible_all, static_argnums=2)
_j_augment = jax.jit(jmatching.augment, static_argnums=3)
_j_swap_feasible = jax.jit(jmatching.swap_feasible)


def _matchings(rng, oh, B, kmax):
    """B matchings built by the reference's own augment over random
    insertion orders, with their -1 padded selections."""
    m, h = oh.shape
    mss, sels = [], []
    for _ in range(B):
        ms = jnp.full((h,), -1, jnp.int32)
        sel = []
        for v in rng.permutation(m)[:kmax]:
            if bool(_j_feasible_all(jnp.asarray(oh), ms, kmax)[v]):
                ms = _j_augment(jnp.asarray(oh), ms, int(v), kmax)
                sel.append(int(v))
        mss.append(np.asarray(ms))
        sels.append(sel + [-1] * (kmax - len(sel)))
    return np.stack(mss), np.asarray(sels)


@pytest.mark.parametrize("seed", range(6))
def test_matching_primitives_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    m, h, B = int(rng.integers(6, 20)), int(rng.integers(2, 8)), 3
    kmax = int(rng.choice([2, 4, 8]))
    oh = rng.random((m, h)) < 0.35
    oh[np.arange(m), rng.integers(0, h, m)] = True
    ms, sel = _matchings(rng, oh, B, kmax)
    j_oh = jnp.asarray(oh)
    t_oh, t_ms, t_sel = _t(oh, ms.astype(np.int64), sel.astype(np.int64))
    per = [jnp.asarray(ms[b]) for b in range(B)]

    got = matching.reach_matrix(t_oh, t_ms).numpy()
    want = np.stack([np.asarray(jmatching.reach_matrix(j_oh, p))
                     for p in per])
    np.testing.assert_array_equal(got, want)
    got = matching.feasible_all(t_oh, t_ms, kmax).numpy()
    want = np.stack([np.asarray(_j_feasible_all(j_oh, p, kmax))
                     for p in per])
    np.testing.assert_array_equal(got, want)
    v = int(rng.integers(0, m))
    got = matching.swap_feasible(t_oh, t_ms, t_sel, v).numpy()
    want = np.stack([np.asarray(_j_swap_feasible(
        j_oh, per[b], jnp.asarray(sel[b].astype(np.int32)), v))
        for b in range(B)])
    np.testing.assert_array_equal(got, want)
    vs = rng.integers(0, m, B)
    got = matching.augment(t_oh, t_ms, torch.as_tensor(vs), kmax).numpy()
    want = np.stack([np.asarray(_j_augment(j_oh, per[b], int(vs[b]), kmax))
                     for b in range(B)])
    np.testing.assert_array_equal(got, want)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 9), st.integers(0, 1000))
def test_torch_diversity_matches_jnp_and_host(k, seed):
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(k, 4))
    D = np.sqrt(((P[:, None] - P[None]) ** 2).sum(-1))
    for v in ("sum", "star", "tree"):
        a = float(jnp_diversity(jnp.asarray(D, jnp.float32), v))
        b = float(torch_diversity(torch.as_tensor(D, dtype=torch.float32),
                                  v))
        c = diversity(D, v)
        assert abs(a - b) / max(a, 1e-9) < 1e-5, v
        assert abs(c - b) / max(c, 1e-9) < 1e-4, v
    with pytest.raises(ValueError, match="NP-hard"):
        torch_diversity(torch.as_tensor(D), "cycle")


def test_torch_diversity_batched_equals_per_matrix():
    rng = np.random.default_rng(7)
    D = np.abs(rng.normal(size=(3, 4, 6, 6))).astype(np.float32)
    D = torch.as_tensor(D + D.transpose(0, 1, 3, 2))
    for v in ("sum", "star", "tree"):
        batched = torch_diversity(D, v)
        for i in range(3):
            for j in range(4):
                assert batched[i, j] == torch_diversity(D[i, j], v)


# --------------------------------------------------------------------------
# registry + dispatch policy (twins of tests/test_solvers.py)
# --------------------------------------------------------------------------


def test_coverage_matrix_shape_and_policy():
    cm = coverage_matrix()
    assert set(cm) == {(v, k) for v in VARIANTS for k in MATROID_KINDS}
    for kind in ("uniform", "partition", "transversal"):
        assert cm[("sum", kind)][0] == "jit_sum"
        for variant in ("star", "tree"):
            assert cm[(variant, kind)][0] == "jit_greedy"
    assert cm[("sum", "general")] == ["host_local_search"]
    for (variant, kind), engines in cm.items():
        host = "host_local_search" if variant == "sum" else "host_exhaustive"
        assert host in engines, (variant, kind)
    assert cm == jsolvers.coverage_matrix()


def test_auto_selects_parity_engines_only(rng):
    ctx, jctx = _ctx_for("uniform", rng)
    assert select_engine(ctx, SolveSpec(k=3)).name == "jit_sum"
    assert jsolvers.select_engine(jctx, jsolvers.SolveSpec(k=3)).name == \
        "jit_sum"
    for variant in ("star", "tree"):
        e = select_engine(ctx, SolveSpec(k=3, variant=variant))
        assert e.name == "host_exhaustive"
        e = select_engine(
            ctx, SolveSpec(k=3, variant=variant), hint="jit_greedy"
        )
        assert e.name == "jit_greedy"
    e = select_engine(ctx, SolveSpec(k=3, variant="cycle"), hint="jit_greedy")
    assert e.name == "host_exhaustive"
    with pytest.raises(ValueError):
        resolve_engine("jit_sum", ctx, SolveSpec(k=3, variant="cycle"))
    with pytest.raises(ValueError):
        get_engine("definitely_not_registered")


def test_partition_by_engine_groups(rng):
    ctx, jctx = _ctx_for("partition", rng)
    specs = [
        SolveSpec(k=2),
        SolveSpec(k=3, variant="tree"),
        SolveSpec(k=2),
        SolveSpec(k=2, variant="star"),
    ]
    hints = [None, "jit_greedy", None, None]
    reg = obs.default_registry()
    before = reg.counter("solve.dispatch.requests", engine="jit_sum",
                         requested="auto").value
    groups = partition_by_engine(ctx, specs, engine="auto", hints=hints)
    assert groups == {
        "jit_sum": [0, 2], "jit_greedy": [1], "host_exhaustive": [3]
    }
    assert reg.counter("solve.dispatch.requests", engine="jit_sum",
                       requested="auto").value == before + 2
    jspecs = [jsolvers.SolveSpec(k=s.k, variant=s.variant) for s in specs]
    assert groups == jsolvers.partition_by_engine(jctx, jspecs,
                                                  engine="auto", hints=hints)
    groups = partition_by_engine(ctx, specs, engine="host")
    assert groups == {
        "host_local_search": [0, 2], "host_exhaustive": [1, 3]
    }


def test_register_custom_engine(rng):
    class EchoEngine(SolverEngine):
        name = "echo"
        priority = 1
        exact_parity = False  # never picked by auto

        def supports(self, variant, matroid_kind):
            return variant == "sum"

        def solve_one(self, ctx, spec):
            loc = np.flatnonzero(spec.allow_mask(ctx.size))[: spec.k]
            return EngineSolution(
                local_indices=loc.astype(np.int64),
                value=selection_value(ctx.D, loc, spec.variant),
                engine=self.name,
            )

    saved = dict(solvers_base._REGISTRY)
    try:
        register_engine(EchoEngine())
        with pytest.raises(ValueError):
            register_engine(EchoEngine())
        ctx, _ = _ctx_for("uniform", rng)
        spec = SolveSpec(k=3)
        assert resolve_engine("echo", ctx, spec).name == "echo"
        assert select_engine(ctx, spec).name == "jit_sum"
        sol = resolve_engine("echo", ctx, spec).solve_one(ctx, spec)
        assert sol.local_indices.tolist() == [0, 1, 2]
        assert "echo" in [e.name for e in registered_engines()]
    finally:
        solvers_base._REGISTRY.clear()
        solvers_base._REGISTRY.update(saved)


@pytest.mark.parametrize("kind", ["uniform", "partition", "transversal"])
def test_cross_engine_sum_parity_property(rng, kind):
    """Every parity engine eligible for a cell returns the host engine's
    selection set and canonical objective, and the reference's jit_sum
    the same selection (per-query caps and candidate filters included)."""
    for trial in range(6):
        ctx, jctx = _ctx_for(kind, rng)
        k = int(rng.integers(2, 6))
        caps = None
        if kind == "partition" and trial % 2:
            caps = tuple(rng.integers(1, 3, ctx.spec.num_categories).tolist())
        allow = None
        if trial % 3 == 0:
            allow = rng.random(ctx.size) < 0.8
        spec = SolveSpec(k=k, variant="sum", caps=caps, allow=allow)
        host = resolve_engine("host", ctx, spec).solve_one(ctx, spec)
        for e in registered_engines():
            if not (e.exact_parity and e.eligible(ctx, spec)):
                continue
            got = e.solve_one(ctx, spec)
            assert sorted(got.local_indices.tolist()) == sorted(
                host.local_indices.tolist()
            ), (kind, trial, k, e.name)
            assert got.value == host.value, (kind, trial, k, e.name)
        ref = jsolvers.get_engine("jit_sum").solve_one(
            jctx, jsolvers.SolveSpec(k=k, caps=caps, allow=allow))
        got = get_engine("jit_sum").solve_one(ctx, spec)
        assert got.local_indices.tolist() == ref.local_indices.tolist()


def test_transversal_jit_batch_matches_host_local_search(rng):
    ctx, _ = _ctx_for("transversal", rng)
    specs = [SolveSpec(k=k) for k in (2, 3, 4, 5)]
    jit = get_engine("jit_sum")
    assert jit.eligible(ctx, specs[0])
    sols = jit.solve_batch(ctx, specs)
    from repro_torch.core.solvers.local_search import local_search_sum

    for spec, sol in zip(specs, sols):
        X, _val, _ = local_search_sum(
            ctx.D, ctx.matroid_fn(spec), spec.k, list(range(ctx.size))
        )
        assert sol.local_indices.tolist() == X  # same order, even
        assert sol.value == selection_value(ctx.D, X, "sum")
        assert ctx.matroid_fn(spec).is_independent(
            sol.local_indices.tolist()
        )


def test_solve_dmmc_engine_dispatch(rng):
    """``engine="auto"`` resolves to jit_sum in both packages, and the
    port's auto, jit_sum and host runs select the reference's indices."""
    P = make_clustered_points(rng, n=200)
    h = 4
    cats = rng.integers(0, h, (200, 1)).astype(np.int32)
    caps = np.full(h, 2, np.int32)
    spec = MatroidSpec("partition", num_categories=h, gamma=1)
    kw = dict(cats=cats, caps=caps, tau=10, setting="streaming")
    buf = obs.default_buffer()
    a = solve_dmmc(P, 4, spec, device=CPU, **kw)  # default engine="host"
    buf.clear()
    b = solve_dmmc(P, 4, spec, engine="auto", device=CPU, **kw)
    spans = [s for s in buf.drain() if s.name == "final_solve"]
    assert [s.args["engine"] for s in spans] == ["jit_sum"]
    c = solve_dmmc(P, 4, spec, engine="jit_sum", device=CPU, **kw)
    assert sorted(a.indices.tolist()) == sorted(b.indices.tolist())
    assert b.indices.tolist() == c.indices.tolist()
    assert a.diversity == b.diversity == c.diversity
    ref = jsolve_dmmc(P, 4, JMatroidSpec("partition", num_categories=h,
                                         gamma=1), engine="auto", **kw)
    assert b.indices.tolist() == ref.indices.tolist()


def test_bucket_pow2():
    ns = (1, 2, 3, 4, 5, 7, 8, 9, 31)
    assert [bucket_pow2(n) for n in ns] == [1, 2, 4, 4, 8, 8, 8, 16, 32]
    assert [bucket_pow2(n) for n in ns] == [jsum.bucket_pow2(n) for n in ns]


def test_kmax_bucketing_reuses_compiled_solver(rng):
    """Novel max-k values inside one power-of-two bucket open the same
    compile region (no compile event for them) and the answers do not
    depend on the batch composition."""
    ctx, _ = _ctx_for("partition", rng)
    jit = get_engine("jit_sum")
    base = {k: jit.solve_one(ctx, SolveSpec(k=k)) for k in (5, 8)}
    watch = obs.RecompileWatch()
    try:
        for k in (6, 7, 8):
            jit.solve_one(ctx, SolveSpec(k=k))
        assert watch.total() == 0
    finally:
        watch.close()
    again = jit.solve_batch(ctx, [SolveSpec(k=5), SolveSpec(k=8)])
    assert again[0].local_indices.tolist() == base[5].local_indices.tolist()
    assert again[1].local_indices.tolist() == base[8].local_indices.tolist()


def test_unknown_engine_hint_raises(rng):
    ctx, _ = _ctx_for("uniform", rng)
    spec = SolveSpec(k=3, variant="star")
    with pytest.raises(ValueError, match="unknown solver engine"):
        select_engine(ctx, spec, hint="jit_greddy")
    assert select_engine(ctx, SolveSpec(k=3, variant="cycle"),
                         hint="jit_greedy").name == "host_exhaustive"


def test_final_solve_accepts_1d_cats(rng):
    from repro_torch.core.final_solve import final_solve

    m, h = 32, 4
    D = _dist(make_clustered_points(rng, n=m, d=4))
    cats1d = rng.integers(0, h, m).astype(np.int32)
    caps = np.full(h, 2, np.int32)
    matroid = PartitionMatroid(cats1d, caps)
    X_jit, v_jit = final_solve(
        D, matroid, 4, "sum", engine="jit_sum", cats=cats1d, caps=caps,
        device=CPU,
    )
    X_host, v_host = final_solve(D, matroid, 4, "sum")
    assert sorted(X_jit) == sorted(X_host)
    assert v_jit == v_host


def test_final_solve_preserves_idxs_order(rng):
    from repro_torch.core.final_solve import final_solve

    P = make_clustered_points(rng, n=8, d=3)
    P[5] = P[2]  # exact duplicate: rows 2 and 5 tie everywhere
    D = _dist(P)
    matroid = UniformMatroid(8, 2)
    fwd, _ = final_solve(D, matroid, 2, "sum", idxs=[2, 5, 0, 7])
    rev, _ = final_solve(D, matroid, 2, "sum", idxs=[5, 2, 0, 7])
    assert (2 in fwd) != (5 in fwd) and (2 in rev) != (5 in rev)
    swap = {2: 5, 5: 2}
    assert sorted(swap.get(i, i) for i in rev) == sorted(fwd)
    ctx, _ = _ctx_for("uniform", rng)
    spec = SolveSpec(k=2, idxs=(5, 2, 0))
    assert not get_engine("jit_sum").eligible(ctx, spec)
    assert select_engine(ctx, spec).name == "host_local_search"
    assert select_engine(ctx, SolveSpec(k=2, idxs=(0, 2, 5))).name == "jit_sum"


def test_multilabel_partition_guard(rng):
    m, h = 16, 3
    D = _dist(make_clustered_points(rng, n=m, d=4))
    cats = np.full((m, 2), -1, np.int32)
    cats[:, 0] = rng.integers(0, h, m)
    cats[2, 1] = 1  # one point with a second real label
    caps = np.full(h, 2, np.int32)
    spec = MatroidSpec("partition", num_categories=h, gamma=2)
    ctx = SolveContext(
        D=D, spec=spec, cats=cats, caps=caps,
        matroid_fn=lambda s: PartitionMatroid(cats, caps), device=CPU,
    )
    q = SolveSpec(k=3)
    assert not get_engine("jit_sum").eligible(ctx, q)
    with pytest.raises(ValueError):
        resolve_engine("jit_sum", ctx, q)
    eng = select_engine(ctx, q)
    assert eng.name == "host_local_search"
    with pytest.raises(ValueError, match="transversal"):
        eng.solve_one(ctx, q)
    cats_pad = cats.copy()
    cats_pad[:, 1] = -1
    ctx2 = SolveContext(
        D=D, spec=spec, cats=cats_pad, caps=caps,
        matroid_fn=lambda s: PartitionMatroid(cats_pad, caps), device=CPU,
    )
    assert select_engine(ctx2, q).name == "jit_sum"


# --------------------------------------------------------------------------
# the engines' device: the card unless the context asks for the CPU
# --------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["jit_sum", "jit_greedy"])
def test_engine_context_defaults_to_the_card(rng, engine):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default runs there")
    ctx, _ = _ctx_for("partition", rng)
    ctx.device = torch.device("cuda")
    spec = SolveSpec(k=3, variant="sum" if engine == "jit_sum" else "star")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_engine(engine).solve_batch(ctx, [spec])
