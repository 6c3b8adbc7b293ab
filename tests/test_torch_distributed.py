"""The port's collectives across ranks, compression, and placements.

Eight gloo ranks are spawned once for the module, with a ``file://``
store under a temporary directory (no TCP port, so runs in parallel do
not clash). Each rank builds the multi-rank mesh (``make_mesh((8,),
("data",))`` under ``torch.distributed``) and runs the MapReduce union
(with and without round 2), ``solve_dmmc(setting="mapreduce")``, the
global GMM and the compressed pod all-reduce, and saves what it got.
Every rank must hold the in-process mesh's result bit for bit. The
compression functions are held to the JAX package's: the int8 payload
exactly, scale and residual allclose. Then the ``shard_map`` placement
against ``vmap`` per shard, the ``pipeline`` states dealt over two
stand-in devices, and ``skip_masked``.
"""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as jcomp
from repro_torch import core
from repro_torch.core import streaming
from repro_torch.core.distributed_gmm import _global_gmm_shard
from repro_torch.launch import make_mesh
from repro_torch.train import compression as tcomp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
RANKS = 8

INSTANCE = """
import numpy as np
def instance(seed):
    rng = np.random.default_rng(seed)
    n, h, k = 1600, 4, 4
    base = rng.normal(size=(n, 2)) @ rng.normal(size=(2, 8))
    P = (base + 0.05*rng.normal(size=(n, 8))).astype(np.float32)
    cats = rng.integers(0, h, (n, 1)).astype(np.int32)
    caps = np.full(h, 2, np.int32)
    return P, cats, caps, h, k
"""
exec(INSTANCE)

RANK_RUN = INSTANCE + """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch import core
from repro_torch.core.distributed_gmm import _global_gmm_shard
from repro_torch.launch import make_mesh
from repro_torch.train.compression import pod_allreduce_compressed
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store,
                        world_size=8, rank=rank)
mesh = make_mesh((8,), ("data",))
assert mesh.multi_rank and mesh.rank == rank
P, cats, caps, h, k = instance(0)
n = P.shape[0]
spec = core.MatroidSpec("partition", num_categories=h, gamma=1)
res = {}
args = (P, cats, np.ones(n, bool), spec, caps, k, 8)
for r2 in (None, 16):
    cs, ovf = core.mapreduce_coreset(mesh, *args, round2_tau=r2)
    res[f"union_{r2}"] = (tuple(cs), ovf)
sol = core.solve_dmmc(P, k, spec, cats=cats, caps=caps, tau=64,
                      setting="mapreduce", mesh=mesh, device="cpu")
res["solve"] = (sol.coreset_indices, sol.indices, sol.info)
P3, cats3, caps3, _, _ = instance(3)
cs, radius, delta = core.distributed_coreset(
    mesh, P3, cats3, np.ones(n, bool), spec, caps3, k, 16)
centers = _global_gmm_shard(mesh, [torch.as_tensor(P3[rank * 200:][:200])],
                            [torch.ones(200, dtype=torch.bool)], 16,
                            ("data",))[3]
res["global_gmm"] = (tuple(cs), radius, delta, centers)
m2 = make_mesh((2, 4), ("pod", "data"))
cs, _ = core.mapreduce_coreset(m2, *args, data_axes=("pod", "data"))
res["union_2d"] = tuple(cs)
g = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 64)),
                    dtype=torch.float32)
pm = make_mesh((8,), ("pod",))
red, new_r = pod_allreduce_compressed({"g": g[rank]},
                                      {"g": torch.zeros(64)}, "pod",
                                      mesh=pm)
res["pod"] = (red["g"], new_r["g"])
red2, _ = pod_allreduce_compressed({"g": g[rank]}, {"g": torch.zeros(64)},
                                   "pod", mesh=m2)
res["pod_2d"] = red2["g"]
torch.save(res, out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results, from one spawn of 8 gloo ranks."""
    d = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    code = textwrap.dedent(RANK_RUN)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(d / "store"),
         str(d / f"rank{r}.pt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r]}"
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(RANKS)]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((8,), ("data",), devices=[CPU] * 8)


def _assert_equal_leaves(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("round2", [None, 16])
def test_gloo_ranks_give_the_in_process_union(ranks, mesh, round2):
    """Every rank holds the in-process mesh's union, bit for bit."""
    P, cats, caps, h, k = instance(0)
    spec = core.MatroidSpec("partition", num_categories=h, gamma=1)
    cs, ovf = core.mapreduce_coreset(mesh, P, cats, np.ones(len(P), bool),
                                     spec, caps, k, 8, round2_tau=round2)
    for res in ranks:
        got, got_ovf = res[f"union_{round2}"]
        _assert_equal_leaves(got, cs)
        assert int(got_ovf) == int(ovf) == 0


def test_gloo_ranks_solve_and_global_gmm(ranks, mesh):
    P, cats, caps, h, k = instance(0)
    spec = core.MatroidSpec("partition", num_categories=h, gamma=1)
    sol = core.solve_dmmc(P, k, spec, cats=cats, caps=caps, tau=64,
                          setting="mapreduce", mesh=mesh, device=CPU)
    P3, cats3, caps3, _, _ = instance(3)
    want = core.distributed_coreset(mesh, P3, cats3, np.ones(len(P3), bool),
                                    spec, caps3, k, 16)
    want += (_global_gmm_shard(
        mesh, list(torch.chunk(torch.as_tensor(P3), 8)),
        [torch.ones(200, dtype=torch.bool)] * 8, 16, ("data",))[3],)
    for res in ranks:
        ci, idx, info = res["solve"]
        np.testing.assert_array_equal(ci, sol.coreset_indices)
        np.testing.assert_array_equal(idx, sol.indices)
        assert info == sol.info
        cs, radius, delta, centers = res["global_gmm"]
        _assert_equal_leaves(cs, want[0])
        assert torch.equal(radius, want[1]) and torch.equal(delta, want[2])
        assert torch.equal(centers, want[3])


def test_gloo_two_axis_mesh_union(ranks, mesh):
    """A (2, 4) multi-rank mesh sharding over both axes gives the 8-shard
    union."""
    P, cats, caps, h, k = instance(0)
    spec = core.MatroidSpec("partition", num_categories=h, gamma=1)
    cs, _ = core.mapreduce_coreset(mesh, P, cats, np.ones(len(P), bool),
                                   spec, caps, k, 8)
    for res in ranks:
        _assert_equal_leaves(res["union_2d"], cs)


def test_compressed_pod_allreduce(ranks):
    """Twin of tests/test_distributed.py:59: 8 ranks along ``pod``; the
    int8 mean within the reference's bound of the f32 mean, the same on
    every rank, and each rank's residual its own quantisation error."""
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 64)),
                        dtype=torch.float32)
    want = g.mean(0)
    scale = float(want.abs().max())
    red0 = ranks[0]["pod"][0]
    err = float((red0 - want).abs().max())
    assert err <= scale / 127 * 8 + 1e-6, (err, scale)
    shared = torch.clamp_min(g.abs().max() / 127.0, 1e-30)
    for r, res in enumerate(ranks):
        red, resid = res["pod"]
        assert torch.equal(red, red0)
        q = torch.clamp(torch.round(g[r] / shared), -127, 127)
        assert torch.equal(resid, g[r] - q * shared)


def test_compressed_allreduce_over_a_subgroup(ranks):
    """On a (2, 4) ``pod`` x ``data`` mesh the reduction runs over the two
    ranks of each ``data`` column only."""
    g = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 64)),
                        dtype=torch.float32)
    for r, res in enumerate(ranks):
        pair = g[[r % 4, r % 4 + 4]]
        want = pair.mean(0)
        err = float((res["pod_2d"] - want).abs().max())
        assert err <= float(want.abs().max()) / 127 * 8 + 1e-6
        assert torch.equal(res["pod_2d"], ranks[(r + 4) % 8]["pod_2d"])


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_with_feedback_matches_jax(seed):
    rng = np.random.default_rng(seed)
    grads = {"a": rng.normal(size=(16, 8)).astype(np.float32),
             "b": {"c": (rng.normal(size=(33,)) * 1e-3).astype(np.float32)}}
    resid = {"a": (rng.normal(size=(16, 8)) * 1e-2).astype(np.float32),
             "b": {"c": np.zeros(33, np.float32)}}
    tq, ts, tr = tcomp.compress_with_feedback(
        {"a": torch.as_tensor(grads["a"]),
         "b": {"c": torch.as_tensor(grads["b"]["c"])}},
        {"a": torch.as_tensor(resid["a"]),
         "b": {"c": torch.as_tensor(resid["b"]["c"])}})
    jq, js, jr = jcomp.compress_with_feedback(
        {"a": jnp.asarray(grads["a"]),
         "b": {"c": jnp.asarray(grads["b"]["c"])}},
        {"a": jnp.asarray(resid["a"]),
         "b": {"c": jnp.asarray(resid["b"]["c"])}})
    for path in (("a",), ("b", "c")):
        def at(t):
            for key in path:
                t = t[key]
            return t
        assert at(tq).dtype == torch.int8
        np.testing.assert_array_equal(at(tq).numpy(), np.asarray(at(jq)))
        np.testing.assert_allclose(at(ts).numpy(), np.asarray(at(js)),
                                   rtol=1e-6)
        np.testing.assert_allclose(at(tr).numpy(), np.asarray(at(jr)),
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_array_equal(
            tcomp.dequantize(at(tq), at(ts)).numpy(),
            np.asarray(jcomp.dequantize(at(jq), at(js))))
    zero = tcomp.init_residual({"w": torch.ones(3, dtype=torch.bfloat16)})
    assert zero["w"].dtype == torch.float32 and not zero["w"].any()


def test_compression_error_feedback_converges():
    """Twin of tests/test_train.py::test_compression_error_feedback_converges:
    int8 error-feedback SGD reaches the optimum of a quadratic."""
    rng = np.random.default_rng(0)
    target = torch.as_tensor(rng.normal(size=(64,)), dtype=torch.float32)
    w = torch.zeros(64)
    resid = tcomp.init_residual({"w": w})["w"]
    for _ in range(400):
        g = 2 * (w - target)
        q, s, r = tcomp.compress_with_feedback({"w": g}, {"w": resid})
        q, s, resid = q["w"], s["w"], r["w"]
        w = w - 0.05 * (q.to(torch.float32) * s)
    assert float((w - target).abs().max()) < 5e-2


def _stream(seed=0, n=900, d=6):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(12, d)) * 3.0
    P = (base[rng.integers(0, 12, n)]
         + 0.05 * rng.normal(size=(n, d))).astype(np.float32)
    cats = rng.integers(0, 4, (n, 1)).astype(np.int32)
    return P, cats, np.full(4, 3, np.int32)


@pytest.mark.parametrize("devices", [None, [CPU], [CPU, CPU], [CPU] * 4])
def test_shard_map_drive_equals_vmap_per_shard(devices):
    """``ingest_batch_sharded_mapped`` over 1, 2 or 4 device groups gives
    every shard the state of the ``vmap`` drive, bit for bit."""
    P, cats, caps = _stream()
    spec = core.MatroidSpec("partition", num_categories=4, gamma=1)
    S, k, tau, m = 4, 4, 8, 96
    Pb = torch.as_tensor(P[:S * m].reshape(m, S, -1).transpose(1, 0, 2)
                         .copy())
    Cb = cats[:S * m].reshape(m, S, 1).transpose(1, 0, 2)
    Vb = np.ones((S, m), bool)
    Sb = np.arange(S * m, dtype=np.int32).reshape(m, S).T
    a = core.init_sharded_states(S, 6, 1, spec, k, tau, device=CPU)
    b = core.init_sharded_states(S, 6, 1, spec, k, tau, device=CPU)
    core.ingest_batch_sharded_donated(a, Pb, Cb, Vb, Sb, spec, caps, k, tau,
                                      block_size=32)
    empty = [t.clone() for t in b]
    c = core.ingest_batch_sharded_mapped(b, Pb, Cb, Vb, Sb, spec, caps, k,
                                         tau, devices=devices, block_size=32)
    for x, y in zip(b, empty):  # not donated: the caller's state is kept
        assert torch.equal(x, y)
    core.ingest_batch_sharded_mapped(b, Pb, Cb, Vb, Sb, spec, caps, k, tau,
                                     donate=True, devices=devices,
                                     block_size=32)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_resolve_placement_accepts_shard_map(monkeypatch):
    assert core.resolve_placement("shard_map", 4, CPU) == "shard_map"
    assert core.resolve_placement("auto", 4, CPU) == "pipeline"
    assert core.resolve_placement("auto", 1, CPU) == "vmap"
    # the reference's auto on an accelerator: shard_map when more than one
    # card takes a whole shard, else vmap
    monkeypatch.setattr(streaming.torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(streaming.torch.cuda, "is_available", lambda: True)
    assert core.resolve_placement("auto", 4, "cuda") == "shard_map"
    assert core.resolve_placement("auto", 3, "cuda") == "vmap"
    monkeypatch.setattr(streaming.torch.cuda, "device_count", lambda: 1)
    assert core.resolve_placement("auto", 4, "cuda") == "vmap"


def test_runtime_shard_map_equals_vmap_and_restores(tmp_path):
    """``StreamRuntime(placement="shard_map")`` serves the ``vmap``
    runtime's stream (per-shard ``src_idx`` and the epoch triple), and a
    checkpoint it wrote restores to the runtime that saved it."""
    from repro_torch.serve.diversity import StreamRuntime

    P, cats, caps = _stream(1, n=1200)
    spec = core.MatroidSpec("partition", num_categories=4, gamma=1)
    rts = {}
    for pl in ("vmap", "shard_map"):
        dur = str(tmp_path / pl) if pl == "shard_map" else None
        rt = StreamRuntime(spec, 4, tau=8, caps=caps, num_shards=4,
                           placement=pl, block_size=32, durability=dur,
                           device=CPU)
        for off in range(0, 1200, 300):
            rt.ingest(P[off:off + 300], cats[off:off + 300])
        rt.refresh(force=True)
        rts[pl] = rt
    a, b = rts["vmap"], rts["shard_map"]
    assert b.placement == "shard_map"
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)
    assert a.fingerprint == b.fingerprint
    assert ([int(v) for v in core.epoch_stats(a.state)]
            == [int(v) for v in core.epoch_stats(b.state)])
    b.checkpoint(force=True)
    b.close()
    r = StreamRuntime.restore(str(tmp_path / "shard_map"), device=CPU)
    assert r.placement == "shard_map"
    for x, y in zip(r.state, b.state):
        assert torch.equal(x, y)
    assert r.fingerprint == b.fingerprint and r.n_offered == b.n_offered
    r.ingest(P[:300], cats[:300])
    a.ingest(P[:300], cats[:300])
    for x, y in zip(a.state, r.state):
        assert torch.equal(x, y)
    for rt in (a, r):
        rt.close()


def test_pipeline_states_are_dealt_over_the_devices(tmp_path, monkeypatch):
    """The ``pipeline`` placement deals its per-shard states round robin
    over the runtime's devices, at init and on restore (two stand-in
    devices here: the deal is read from where each state was put)."""
    from repro_torch.serve.diversity import StreamRuntime
    from repro_torch.serve.diversity import runtime as rt_mod

    put = []

    def devices(self):
        return ["cpu:a", "cpu:b"]

    real_init, real_place = rt_mod.init_stream_state, rt_mod.place_state

    def init(*args, device, **kw):
        put.append(device)
        return real_init(*args, device=CPU, **kw)

    def place(state, device):
        put.append(device)
        return real_place(state, CPU)

    monkeypatch.setattr(StreamRuntime, "_devices", devices)
    monkeypatch.setattr(rt_mod, "init_stream_state", init)
    monkeypatch.setattr(rt_mod, "place_state", place)
    P, cats, caps = _stream(2, n=600)
    spec = core.MatroidSpec("partition", num_categories=4, gamma=1)
    rt = StreamRuntime(spec, 4, tau=8, caps=caps, num_shards=3,
                       placement="pipeline", block_size=32,
                       durability=str(tmp_path), device=CPU)
    for off in range(0, 600, 200):
        rt.ingest(P[off:off + 200], cats[off:off + 200])
    assert put == ["cpu:a", "cpu:b", "cpu:a"]
    rt.checkpoint(force=True)
    rt.close()
    put.clear()
    r = StreamRuntime.restore(str(tmp_path), device=CPU)
    assert put == ["cpu:a", "cpu:b", "cpu:a"]
    assert r.fingerprint == rt.fingerprint
    r.close()


@pytest.mark.parametrize("force", [None, "ref"])
def test_skip_masked_changes_no_value(force):
    """``LM.forward``, ``LM.loss`` and ``StepConfig`` take the reference's
    ``skip_masked``; both values give identical logits, loss and step."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.train import (AdamWConfig, StepConfig, init_train_state,
                                   make_train_step)

    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              dtype="float32")
    lm = LM(cfg)
    params = lm.init(0, device=CPU)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    outs = [lm.forward(params, toks, skip_masked=s, force=force)[0]
            for s in (False, True)]
    assert torch.equal(outs[0], outs[1])
    losses = [lm.loss(params, toks, skip_masked=s, force=force)[0]
              for s in (False, True)]
    assert torch.equal(losses[0], losses[1])
    opt = AdamWConfig(lr=1e-3)
    steps = []
    for s in (False, True):
        st = init_train_state(lm, 0, opt, device=CPU)
        st, m = make_train_step(lm, opt, StepConfig(skip_masked=s),
                                force=force)(st, {"tokens": toks})
        steps.append((m["loss"], st["params"]["embed"]))
    assert torch.equal(steps[0][0], steps[1][0])
    assert torch.equal(steps[0][1], steps[1][1])
