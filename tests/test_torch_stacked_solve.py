"""Cross-tenant stacked solves of the port, on the CPU.

Twins of ``tests/test_stacked_solve.py``: ``solve_stacked`` over T tenant
lanes returns, for every row of every lane, exactly the indices and value
the per-tenant ``jit_sum.solve_batch`` returns (bit-identical), the
stack-eligibility refusals, the shape guards and the cost model's
stacked pricing. Then the array-level ``solve_sum_batch_stacked`` of the
port against the JAX package's on the same numpy inputs.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.solvers import stacked as jstacked
from repro_torch.core.matroid import MatroidSpec, make_host_matroid
from repro_torch.core.solvers import (
    JIT_SUM,
    CostModel,
    SolveContext,
    SolveSpec,
    counts_stack_eligible,
    get_engine,
    partition_by_engine,
    solve_stacked,
    solve_sum_batch_stacked,
)

CPU = "cpu"


def _ctx(kind, m, *, h=4, seed=0, dtype=np.float32):
    r = np.random.default_rng(seed)
    pts = r.random((m, 3))
    D = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(dtype)
    np.fill_diagonal(D, 0.0)
    if kind == "uniform":
        spec = MatroidSpec("uniform")
        return SolveContext(
            D=D, spec=spec, cats=None, caps=None,
            matroid_fn=lambda s: make_host_matroid(spec, None, None, m, s.k),
            device=CPU,
        )
    cats = r.integers(0, h, (m, 1)).astype(np.int32)
    caps = np.full(h, 3, np.int32)
    spec = MatroidSpec("partition", num_categories=h, gamma=1)
    return SolveContext(
        D=D, spec=spec, cats=cats, caps=caps,
        matroid_fn=lambda s: make_host_matroid(spec, cats, caps, m, s.k),
        device=CPU,
    )


def _mixed_lanes(m=40, n_lanes=4, seed=3):
    """Lanes mixing uniform/partition matroids, per-row k, per-row caps
    overrides, and candidate masks — every knob the stacked solver pads."""
    rng = np.random.default_rng(seed)
    kinds = ["uniform", "partition"] * (n_lanes // 2 + 1)
    lanes = []
    for t in range(n_lanes):
        ctx = _ctx(kinds[t], m, seed=100 + t)
        specs = []
        for _ in range(int(rng.integers(1, 6))):
            kw = {"k": int(rng.integers(2, 7))}
            if kinds[t] == "partition" and rng.random() < 0.4:
                kw["caps"] = np.full(4, 2, np.int32)
            if rng.random() < 0.4:
                allow = np.ones(m, bool)
                allow[rng.choice(m, 5, replace=False)] = False
                kw["allow"] = allow
            specs.append(SolveSpec(**kw))
        lanes.append((ctx, specs))
    return lanes


def _assert_lane_parity(lanes, stacked):
    for t, (ctx, specs) in enumerate(lanes):
        ref = JIT_SUM.solve_batch(ctx, specs)
        for i, (a, b) in enumerate(zip(stacked[t], ref)):
            assert a.local_indices.tolist() == b.local_indices.tolist(), (
                t, i, a.local_indices, b.local_indices,
            )
            assert a.value == b.value  # exact float equality
            assert a.engine == b.engine == "jit_sum"


def test_stacked_bit_identical_to_per_tenant_dispatch():
    lanes = _mixed_lanes(n_lanes=4)
    for ctx, specs in lanes:
        for s in specs:
            assert counts_stack_eligible(JIT_SUM, ctx, s)
    _assert_lane_parity(lanes, solve_stacked(lanes))


def test_stacked_parity_off_pow2_lane_count():
    lanes = _mixed_lanes(n_lanes=3, seed=11)
    _assert_lane_parity(lanes, solve_stacked(lanes))


def test_stacked_parity_uneven_lane_widths():
    m = 32
    a = _ctx("uniform", m, seed=21)
    b = _ctx("partition", m, seed=22)
    lanes = [
        (a, [SolveSpec(k=4)]),
        (b, [SolveSpec(k=int(k)) for k in (2, 3, 4, 5, 6, 2, 3)]),
    ]
    _assert_lane_parity(lanes, solve_stacked(lanes))


def test_stacked_empty_and_single_lane():
    assert solve_stacked([]) == []
    ctx = _ctx("uniform", 24, seed=31)
    lanes = [(ctx, [SolveSpec(k=3), SolveSpec(k=5)])]
    _assert_lane_parity(lanes, solve_stacked(lanes))


def test_engine_stacked_path_is_solve_stacked():
    lanes = _mixed_lanes(n_lanes=2, seed=41)
    _assert_lane_parity(lanes, JIT_SUM.solve_batch_stacked(lanes))


# --------------------------------------------------------------------------
# eligibility + shape guards
# --------------------------------------------------------------------------


def test_transversal_and_general_lanes_refused():
    m = 24
    cats = np.full((m, 2), -1, np.int32)
    cats[:, 0] = np.arange(m) % 4
    spec = MatroidSpec("transversal", num_categories=4, gamma=2)
    ctx = SolveContext(
        D=_ctx("uniform", m).D, spec=spec, cats=cats, caps=None,
        matroid_fn=lambda s: None, device=CPU,
    )
    assert not counts_stack_eligible(JIT_SUM, ctx, SolveSpec(k=3))
    assert not JIT_SUM.stack_eligible(ctx, SolveSpec(k=3))


def test_host_engines_have_no_stacked_path():
    ctx = _ctx("uniform", 24)
    host = get_engine("host_local_search")
    assert not host.stack_eligible(ctx, SolveSpec(k=3))
    with pytest.raises(NotImplementedError):
        host.solve_batch_stacked([(ctx, [SolveSpec(k=3)])])


def test_mismatched_lanes_rejected():
    a = _ctx("uniform", 24, seed=51)
    b = _ctx("uniform", 32, seed=52)
    with pytest.raises(ValueError, match="coreset size"):
        solve_stacked([(a, [SolveSpec(k=3)]), (b, [SolveSpec(k=3)])])
    c = _ctx("uniform", 24, seed=53, dtype=np.float64)
    with pytest.raises(ValueError, match="dtype"):
        solve_stacked([(a, [SolveSpec(k=3)]), (c, [SolveSpec(k=3)])])


# --------------------------------------------------------------------------
# cost model: stacked pricing + decision-ring flag
# --------------------------------------------------------------------------


def test_estimate_stacked_sums_rows():
    cm = CostModel()
    parts = [(4, 3), (2, 6), (1, 2)]
    assert cm.estimate_stacked("jit_sum", parts, 32) == pytest.approx(
        cm.estimate("jit_sum", B=7, kmax=6, m=32)
    )
    per_entry = sum(
        cm.estimate("jit_sum", B=b, kmax=k, m=32) for b, k in parts
    )
    assert cm.estimate_stacked("jit_sum", parts, 32) < per_entry


def test_decision_ring_records_stacked_flag():
    cm = CostModel()
    cm.record_decision(
        engine="jit_sum", candidates={"jit_sum": 1e-3}, B=4, kmax=3, m=32,
        stacked=True,
    )
    cm.record_decision(
        engine="jit_sum", candidates={"jit_sum": 1e-3}, B=4, kmax=3, m=32,
    )
    d_stacked, d_plain = cm.decisions()[-2:]
    assert d_stacked["stacked"] is True
    assert d_plain["stacked"] is False


def test_partition_by_engine_stacked_flag_reaches_ring():
    ctx = _ctx("uniform", 24, seed=61)
    cm = CostModel()
    partition_by_engine(
        ctx, [SolveSpec(k=3)] * 8, cost_model=cm, stacked=True
    )
    assert cm.decisions()[-1]["stacked"] is True


# --------------------------------------------------------------------------
# the port against the reference
# --------------------------------------------------------------------------


def test_solve_sum_batch_stacked_matches_jax():
    rng = np.random.default_rng(9)
    T, Bt, m, h, kmax = 3, 4, 30, 4, 8
    pts = rng.random((T, m, 3))
    Ds = np.sqrt(((pts[:, :, None] - pts[:, None]) ** 2).sum(-1))
    Ds = Ds.astype(np.float32)
    for t in range(T):
        np.fill_diagonal(Ds[t], 0.0)
    cats = rng.integers(0, h, (T, m)).astype(np.int32)
    caps = rng.integers(1, 4, (T, Bt, h)).astype(np.int32)
    allow = rng.random((T, Bt, m)) < 0.85
    ks = rng.integers(0, kmax + 1, (T, Bt)).astype(np.int32)
    gammas = np.where(rng.random((T, Bt)) < 0.5, 0.0, 0.01)
    gammas = gammas.astype(np.float32)
    arrays = (Ds, cats, caps, allow, ks, gammas)
    got = solve_sum_batch_stacked(*(torch.as_tensor(a) for a in arrays),
                                  kmax=kmax)
    want = jstacked.solve_sum_batch_stacked(*map(jnp.asarray, arrays),
                                            kmax=kmax)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-5)


def test_cost_model_routes_as_the_reference():
    """The port keeps the reference's CPU priors: the same estimates, the
    same crossover and the same routing decisions."""
    from repro.core.solvers.cost_model import CostModel as JCostModel

    cm, jcm = CostModel(), JCostModel()
    engines = ["jit_sum", "host_local_search"]
    for B in (1, 2, 8, 32, 100):
        for kmax, m in ((3, 43), (8, 327), (22, 327)):
            assert cm.choose(engines, B, kmax, m) == jcm.choose(
                engines, B, kmax, m)
    assert cm.crossover("jit_sum", "host_local_search", kmax=8, m=43) == \
        jcm.crossover("jit_sum", "host_local_search", kmax=8, m=43)
    for c in (cm, jcm):
        c.observe("jit_sum", 4, 8, 64, 0.01)
    assert cm.estimate("jit_sum", 16, 8, 64) == jcm.estimate(
        "jit_sum", 16, 8, 64)
    assert cm.snapshot()["cells"] == jcm.snapshot()["cells"]
