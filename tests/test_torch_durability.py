"""Durability of the port's serving runtime on the CPU: the write-ahead
log, checkpoints and restore.

Twins of ``tests/test_checkpoint_restore.py`` (restore parity across the
placements, query answers, a mid-shrink checkpoint, WAL-only restore, a
torn tail, compaction and a crash during it, the refused synchronous
ingest, a restore raced by traffic) and of the WAL, checkpoint and
non-finite cases of ``tests/test_fault_tolerance.py``. Restored streams
are held to the JAX package's synchronous stream over the same batches
(the epoch fingerprint, which hashes the integer cells only, and the
coreset's ``src_idx``). A durability directory crosses between the two
packages in both directions, and the two ``WriteAheadLog``s write the
same bytes. The scan updates its state in place, so a checkpoint must be
a copy: one test holds ``checkpoint()`` to that.
"""
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from conftest import make_clustered_points
from repro.core.matroid import MatroidSpec as JSpec
from repro.serve import diversity as jdiv
from repro_torch import obs
from repro_torch.serve.diversity import (
    DiversityQuery,
    DiversityService,
    DurabilityConfig,
    FaultPlan,
    FaultRule,
    InjectedCrash,
    StreamRuntime,
    WalError,
    WriteAheadLog,
    latest_checkpoint,
    list_checkpoints,
    load_checkpoint,
)
from repro_torch.core.diversity import diversity
from repro_torch.core.matroid import MatroidSpec

CPU = "cpu"
SPEC_ARGS = ("partition", 4, 1)
# (placement, num_shards): the single scan, the stacked lanes, the list
PLACEMENTS = {"single": ("vmap", 1), "vmap": ("vmap", 3),
              "pipeline": ("pipeline", 3)}


def _instance(rng, n=400, h=4, k=4):
    P = make_clustered_points(rng, n=n)
    cats = rng.integers(0, h, (n, 1)).astype(np.int32)
    caps = np.full(h, 2, np.int32)
    return P, cats, caps, MatroidSpec(*SPEC_ARGS), k


def _batches(P, cats, size=50):
    return [(P[o:o + size], cats[o:o + size])
            for o in range(0, P.shape[0], size)]


def _runtime(spec, k, caps, **kw):
    kw.setdefault("tau", 12)
    kw.setdefault("block_size", 32)
    return StreamRuntime(spec, k, caps=caps, device=CPU, **kw)


def _jruntime(k, caps, **kw):
    kw.setdefault("tau", 12)
    kw.setdefault("block_size", 32)
    return jdiv.StreamRuntime(JSpec(*SPEC_ARGS), k, caps=caps, **kw)


def _reference(k, caps, batches, **kw):
    """The JAX package's synchronous stream over the same batches:
    (fingerprint, snapshot src_idx)."""
    ref = _jruntime(k, caps, **kw)
    for pts, cs in batches:
        ref.ingest(pts, cs)
    snap = ref.refresh(force=True)
    ref.close()
    return snap.fingerprint, snap.src_idx


def _entry_matrix(svc):
    """The service's matrix on its newest epoch, on the host."""
    e = svc.cache.lookup(svc.cache_key, svc.runtime.fingerprint)
    return np.asarray(getattr(e, "D_host", e.D), np.float64)


def _value_without_diagonal(D, r):
    """An answer's value with the diagonal out: the frameworks'
    matmul-form pdist leave different cancellation noise there (as in
    ``tests/test_torch_service.py``)."""
    sub = D[np.ix_(r.local_indices, r.local_indices)].copy()
    np.fill_diagonal(sub, 0.0)
    return diversity(sub, r.variant)


def _host_states(state):
    """Host copies of a state's fields: a tuple for one state, a list of
    tuples for the pipeline's list."""
    if isinstance(state, list):
        return [_host_states(st) for st in state]
    return tuple(np.array(t) for t in state)


def _assert_state_equal(a, b):
    """Bit-identical scan state(s): every field of every shard."""
    a, b = _host_states(a), _host_states(b)
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        pairs = list(zip(a, b))
    else:
        pairs = [(a, b)]
    for sa, sb in pairs:
        assert len(sa) == len(sb)
        for fa, fb in zip(sa, sb):
            assert np.array_equal(fa, fb)


# --------------------------------------------------------------------------
# restore parity (tests/test_checkpoint_restore.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("drive", list(PLACEMENTS))
def test_restore_is_bit_identical_across_placements(rng, tmp_path, drive):
    """A durable async run with a mid-stream checkpoint, abandoned without
    close(); restore replays the WAL tail to the exact pre-kill stream,
    which is also the JAX package's synchronous stream."""
    placement, S = PLACEMENTS[drive]
    P, cats, caps, spec, k = _instance(rng)
    batches = _batches(P, cats)
    dur = DurabilityConfig(dir=str(tmp_path), checkpoint_every=10 ** 9)
    rt = _runtime(spec, k, caps, num_shards=S, placement=placement,
                  durability=dur)
    half = len(batches) // 2
    for pts, cs in batches[:half]:
        rt.submit(pts, cs)
    rt.flush()
    assert rt.checkpoint(force=True) is not None
    for pts, cs in batches[half:]:
        rt.submit(pts, cs)
    rt.flush()
    live = rt.latest()
    restored = StreamRuntime.restore(str(tmp_path), device=CPU)
    rep = restored.restore_report
    assert rep["checkpoint"] is not None
    assert rep["replayed_batches"] == len(batches) - half
    assert rep["replayed_points"] == sum(p.shape[0] for p, _ in
                                         batches[half:])
    got = restored.latest()
    assert got.fingerprint == live.fingerprint
    assert restored.n_offered == rt.n_offered == P.shape[0]
    assert np.array_equal(got.points, live.points)
    assert np.array_equal(got.cats, live.cats)
    assert np.array_equal(got.src_idx, live.src_idx)
    _assert_state_equal(restored.state, rt.state)
    assert restored.device == torch.device(CPU)
    fp, src = _reference(k, caps, batches, num_shards=S,
                         placement=placement)
    assert got.fingerprint == fp
    assert np.array_equal(got.src_idx, src)
    restored.close()


def test_restore_preserves_query_answers(rng, tmp_path):
    """Same coreset -> same answers, and the JAX package's answers."""
    P, cats, caps, spec, k = _instance(rng)
    svc = DiversityService(spec, k, tau=12, caps=caps, block_size=32,
                           durability=str(tmp_path), device=CPU)
    jsvc = jdiv.DiversityService(JSpec(*SPEC_ARGS), k, tau=12, caps=caps,
                                 block_size=32)
    for pts, cs in _batches(P, cats, 80):
        svc.ingest(pts, cs)
        jsvc.ingest(pts, cs)
    ref_sum = svc.query(DiversityQuery(k=k))
    ref_star = svc.query(DiversityQuery(k=3, variant="star"))
    svc.close()
    back = DiversityService.restore(str(tmp_path), device=CPU)
    assert back.runtime.restore_report["fingerprint"] is not None
    got_sum = back.query(DiversityQuery(k=k))
    got_star = back.query(DiversityQuery(k=3, variant="star"))
    assert got_sum.indices.tolist() == ref_sum.indices.tolist()
    assert got_sum.diversity == ref_sum.diversity
    assert got_star.indices.tolist() == ref_star.indices.tolist()
    assert got_star.diversity == ref_star.diversity
    j_sum = jsvc.query(DiversityQuery(k=k), engine="host")
    assert sorted(got_sum.indices.tolist()) == sorted(j_sum.indices.tolist())
    np.testing.assert_allclose(
        _value_without_diagonal(_entry_matrix(jsvc), j_sum),
        _value_without_diagonal(_entry_matrix(back), got_sum), rtol=1e-5)
    back.close()


def test_mid_shrink_checkpoint_restores_exactly(rng, tmp_path):
    """tau small enough that the scan shrinks repeatedly and a checkpoint
    after every batch: the newest lands mid-shrink wherever it happens."""
    P, cats, caps, spec, k = _instance(rng, n=600)
    batches = _batches(P, cats, 40)
    dur = DurabilityConfig(dir=str(tmp_path), checkpoint_every=1, keep=2)
    rt = _runtime(spec, k, caps, tau=8, durability=dur)
    for pts, cs in batches:
        rt.ingest(pts, cs)
    live = rt.refresh(force=True)
    assert len(list_checkpoints(str(tmp_path))) <= 2  # keep= pruned
    restored = StreamRuntime.restore(str(tmp_path), device=CPU)
    got = restored.latest()
    assert got.fingerprint == live.fingerprint
    assert np.array_equal(got.points, live.points)
    _assert_state_equal(restored.state, rt.state)
    assert got.fingerprint == _reference(k, caps, batches, tau=8)[0]
    restored.close()
    rt.close()


def test_wal_only_restore_replays_the_whole_stream(rng, tmp_path):
    P, cats, caps, spec, k = _instance(rng, n=200)
    dur = DurabilityConfig(dir=str(tmp_path), checkpoint_every=10 ** 9)
    rt = _runtime(spec, k, caps, durability=dur)
    for pts, cs in _batches(P, cats):
        rt.submit(pts, cs)
    rt.flush()
    live = rt.latest()
    assert latest_checkpoint(str(tmp_path)) is None
    restored = StreamRuntime.restore(
        str(tmp_path), spec=spec, k=k, tau=12, caps=caps, block_size=32,
        device=CPU)
    assert restored.restore_report["checkpoint"] is None
    assert restored.restore_report["replayed_batches"] == 4
    assert restored.latest().fingerprint == live.fingerprint
    _assert_state_equal(restored.state, rt.state)
    restored.close()
    with pytest.raises(ValueError, match="WAL-only"):
        StreamRuntime.restore(str(tmp_path) + "-nothing-here", device=CPU)


def test_wal_survives_torn_tail(rng, tmp_path):
    """A crash mid-append leaves a torn record; replay stops cleanly at
    the last whole record and restore still succeeds."""
    P, cats, caps, spec, k = _instance(rng, n=150)
    dur = DurabilityConfig(dir=str(tmp_path), checkpoint_every=10 ** 9)
    rt = _runtime(spec, k, caps, durability=dur)
    batches = _batches(P, cats)
    for pts, cs in batches:
        rt.submit(pts, cs)
    rt.flush()
    size = os.path.getsize(dur.wal_path)
    with open(dur.wal_path, "r+b") as f:
        f.truncate(size - 37)
    reg = obs.MetricsRegistry()
    restored = StreamRuntime.restore(
        str(tmp_path), spec=spec, k=k, tau=12, caps=caps, block_size=32,
        registry=reg, device=CPU)
    assert restored.restore_report["replayed_batches"] == len(batches) - 1
    assert restored.n_offered == P.shape[0] - batches[-1][0].shape[0]
    assert reg.counter("serve.wal.torn_records").value == 1
    assert restored.latest().fingerprint == _reference(k, caps,
                                                       batches[:-1])[0]
    restored.close()


def test_wal_compaction_keeps_replay_correct(rng, tmp_path):
    P, cats, caps, spec, k = _instance(rng)
    dur = DurabilityConfig(dir=str(tmp_path), checkpoint_every=2, keep=2)
    rt = _runtime(spec, k, caps, durability=dur)
    for pts, cs in _batches(P, cats, 40):
        rt.submit(pts, cs)
    rt.flush()
    live = rt.latest()
    seqs = [rec.seq for rec in WriteAheadLog(dur.wal_path).replay()]
    assert len(seqs) < 10  # compaction dropped something
    restored = StreamRuntime.restore(str(tmp_path), device=CPU)
    assert restored.latest().fingerprint == live.fingerprint
    _assert_state_equal(restored.state, rt.state)
    restored.close()
    rt.close()


def test_sync_ingest_while_pending_refuses_on_durable_runtime(
    rng, tmp_path
):
    P, cats, caps, spec, k = _instance(rng, n=100)
    rt = _runtime(spec, k, caps, durability=str(tmp_path))
    rt.ingest(P[:50], cats[:50])
    with rt._cv:
        rt._pending = 1  # an in-flight async batch
        with pytest.raises(RuntimeError, match="replay order"):
            rt.ingest(P[50:], cats[50:])
        rt._pending = 0
    assert rt.n_offered == 50
    rt.close()


@pytest.mark.parametrize("generation", ["old", "new"])
def test_compaction_crash_restores_from_either_generation(
    rng, tmp_path, generation
):
    """A crash between the replacement log's write and the atomic swap
    leaves both generations; either restores bit for bit, accepts
    appends and restores again."""
    P, cats, caps, spec, k = _instance(rng)
    batches = _batches(P, cats, 40)  # 10 batches
    dur = DurabilityConfig(dir=str(tmp_path), checkpoint_every=10 ** 9,
                           keep=1)
    plan = FaultPlan(13, [
        FaultRule(site="wal.compact", kind="crash", after=1, times=1),
    ])
    rt = _runtime(spec, k, caps, durability=dur, faults=plan)
    for pts, cs in batches[:5]:
        rt.submit(pts, cs)
    rt.flush()
    assert rt.checkpoint(force=True) is not None  # compaction 1 is clean
    for pts, cs in batches[5:8]:
        rt.submit(pts, cs)
    rt.flush()
    with pytest.raises(InjectedCrash):
        rt.checkpoint(force=True)  # saved; compaction 2 dies
    tmp_log = dur.wal_path + ".compact"
    assert os.path.exists(dur.wal_path) and os.path.exists(tmp_log)
    if generation == "new":
        os.replace(tmp_log, dur.wal_path)  # a crash just after the swap
    back = StreamRuntime.restore(str(tmp_path), device=CPU)
    assert back.latest().fingerprint == _reference(k, caps, batches[:8])[0]
    _assert_state_equal(back.state, rt.state)
    for pts, cs in batches[8:]:
        back.submit(pts, cs)
    back.flush()
    live_state = _host_states(back.state)
    back.close()
    again = StreamRuntime.restore(str(tmp_path), device=CPU)
    assert again.latest().fingerprint == _reference(k, caps, batches)[0]
    _assert_state_equal(again.state, live_state)
    again.close()


def test_restore_races_concurrent_submit_and_query(rng, tmp_path):
    """A restored service takes traffic at once: readers racing a writer
    never see a torn epoch, and an epoch token of the dead service is
    still satisfiable (the epoch counter is restored, not reset)."""
    P, cats, caps, spec, k = _instance(rng, n=600)
    batches = _batches(P, cats)  # 12 batches
    svc = DiversityService(spec, k, tau=12, caps=caps, block_size=32,
                           durability=str(tmp_path), device=CPU)
    for pts, cs in batches[:3]:
        svc.ingest(pts, cs)
    svc.runtime.checkpoint(force=True)
    for pts, cs in batches[3:6]:
        svc.ingest(pts, cs)
    e_old = svc.frontend.flush()
    back = DiversityService.restore(str(tmp_path), device=CPU)
    res = back.frontend.query_batch([DiversityQuery(k=k)], min_epoch=e_old)
    assert res[0].epoch >= e_old

    stop = threading.Event()
    errors: list = []
    results: list = []

    def _reader():
        try:
            while not stop.is_set():
                results.extend(back.frontend.query_batch(
                    [DiversityQuery(k=k), DiversityQuery(k=3)]))
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    readers = [threading.Thread(target=_reader) for _ in range(3)]
    for t in readers:
        t.start()
    try:
        for pts, cs in batches[6:]:
            back.runtime.submit(pts, cs)
        e_new = back.frontend.flush()
        assert e_new > e_old
        r = back.frontend.query_batch([DiversityQuery(k=k)],
                                      min_epoch=e_new)[0]
        assert r.epoch >= e_new
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=60)
    assert not errors
    assert results
    for r in results:
        assert r.epoch >= 0 and r.indices.size > 0
        assert np.unique(r.indices).size == r.indices.size
        assert int(r.indices.max()) < P.shape[0]
    assert back.runtime.latest().fingerprint == _reference(k, caps,
                                                           batches)[0]
    back.close()


# --------------------------------------------------------------------------
# WAL and checkpoint faults, non-finite input (tests/test_fault_tolerance.py)
# --------------------------------------------------------------------------


def test_wal_append_failure_surfaces_to_submitter(rng, tmp_path):
    P, cats, caps, spec, k = _instance(rng, n=150)
    batches = _batches(P, cats)
    reg = obs.MetricsRegistry()
    plan = FaultPlan(0, [
        FaultRule(site="wal.append", kind="error", after=1, times=1),
    ])
    rt = _runtime(spec, k, caps, registry=reg, faults=plan,
                  durability=str(tmp_path))
    assert rt.submit(*batches[0]) == 0
    with pytest.raises(WalError, match="not durable"):
        rt.submit(*batches[1])  # refused at the door, not enqueued
    assert rt.submit(*batches[2]) == 2  # the burned seq leaves a gap
    rt.flush()
    assert reg.counter("serve.wal.append_errors").value == 1
    assert rt.n_offered == batches[0][0].shape[0] + batches[2][0].shape[0]
    rt.close()
    back = StreamRuntime.restore(str(tmp_path), device=CPU)
    assert back.latest().fingerprint == _reference(
        k, caps, [batches[0], batches[2]])[0]
    back.close()


def test_checkpoint_write_failure_keeps_serving(rng, tmp_path):
    P, cats, caps, spec, k = _instance(rng, n=200)
    reg = obs.MetricsRegistry()
    plan = FaultPlan(0, [
        FaultRule(site="checkpoint.write", kind="error", times=1),
    ])
    rt = _runtime(
        spec, k, caps, registry=reg, faults=plan,
        durability=DurabilityConfig(dir=str(tmp_path), checkpoint_every=2))
    for pts, cs in _batches(P, cats):
        rt.submit(pts, cs)
    rt.flush()
    live = rt.latest()
    assert reg.counter("serve.ckpt.failures").value == 1
    assert reg.counter("serve.ckpt.saved").value >= 1  # later saves OK
    rt.close()
    back = StreamRuntime.restore(str(tmp_path), device=CPU)
    assert back.latest().fingerprint == live.fingerprint
    back.close()


@pytest.mark.parametrize("drive", list(PLACEMENTS))
def test_nonfinite_batch_rejected_before_wal(rng, tmp_path, drive):
    """NaN/Inf coordinates raise ``ValueError`` before the WAL append, on
    every drive (``ingest`` checks the whole batch on the device after the
    copy, ``submit`` on the host), counted in ``serve.ingest.rejected``."""
    placement, S = PLACEMENTS[drive]
    P, cats, caps, spec, k = _instance(rng, n=100)
    reg = obs.MetricsRegistry()
    rt = _runtime(spec, k, caps, registry=reg, durability=str(tmp_path),
                  num_shards=S, placement=placement)
    rt.ingest(P[:50], cats[:50])
    bad_nan = P[50:].copy()
    bad_nan[3, 1] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        rt.ingest(bad_nan, cats[50:])
    bad_inf = P[50:].copy()
    bad_inf[0, 0] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        rt.submit(bad_inf, cats[50:])
    assert reg.counter("serve.ingest.rejected",
                       reason="nonfinite").value == 2
    rt.submit(P[50:], cats[50:])
    rt.flush()
    assert rt.n_offered == 100
    good = [(P[:50], cats[:50]), (P[50:], cats[50:])]
    ref_fp = _reference(k, caps, good, num_shards=S, placement=placement)[0]
    assert rt.latest().fingerprint == ref_fp
    # the log holds the two good batches only (read before close: the
    # parting checkpoint compacts it)
    wal = WriteAheadLog(DurabilityConfig(dir=str(tmp_path)).wal_path)
    assert [r.seq for r in wal.replay()] == [0, 1]
    wal.close()
    rt.close()
    restored = StreamRuntime.restore(str(tmp_path), device=CPU)
    assert restored.latest().fingerprint == ref_fp
    restored.close()


def test_nonfinite_rejected_on_nondurable_runtime(rng):
    P, cats, caps, spec, k = _instance(rng, n=100)
    reg = obs.MetricsRegistry()
    rt = _runtime(spec, k, caps, registry=reg)
    bad = P[:50].copy()
    bad[7, 0] = -np.inf
    with pytest.raises(ValueError, match="non-finite"):
        rt.ingest(bad, cats[:50])
    with pytest.raises(ValueError, match="non-finite"):
        rt.submit(bad, cats[:50])
    assert reg.counter("serve.ingest.rejected",
                       reason="nonfinite").value == 2
    assert rt.n_offered == 0
    rt.close()


# --------------------------------------------------------------------------
# a durability directory crosses between the packages
# --------------------------------------------------------------------------


def _write_dir(rt, batches):
    """Half the batches, a checkpoint, the rest: a WAL tail to replay."""
    half = len(batches) // 2
    for pts, cs in batches[:half]:
        rt.submit(pts, cs)
    rt.flush()
    assert rt.checkpoint(force=True) is not None
    for pts, cs in batches[half:]:
        rt.submit(pts, cs)
    rt.flush()
    return half


def _report_counts(rep):
    return (rep["replayed_batches"], rep["replayed_points"],
            rep["skipped_poisoned"], rep["n_offered"], rep["fingerprint"])


@pytest.mark.parametrize("drive", list(PLACEMENTS))
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_durability_dir_crosses_between_packages(rng, tmp_path, drive,
                                                 writer):
    """One package writes a WAL and a checkpoint on the CPU; the other
    restores them to the same snapshot ``src_idx``, epoch triple
    (fingerprint) and ``restore_report`` counts as the writer's own
    restore."""
    placement, S = PLACEMENTS[drive]
    P, cats, caps, spec, k = _instance(rng)
    batches = _batches(P, cats)
    dur = dict(dir=str(tmp_path), checkpoint_every=10 ** 9)
    if writer == "reference":
        w = _jruntime(k, caps, num_shards=S, placement=placement,
                      durability=jdiv.DurabilityConfig(**dur))
    else:
        w = _runtime(spec, k, caps, num_shards=S, placement=placement,
                     durability=DurabilityConfig(**dur))
    _write_dir(w, batches)
    live = w.latest()
    # "kill": no close, so the tail stays in the WAL for both restores
    mine = StreamRuntime.restore(str(tmp_path), device=CPU)
    theirs = jdiv.StreamRuntime.restore(str(tmp_path))
    for rt in (mine, theirs):
        snap = rt.latest()
        assert snap.fingerprint == live.fingerprint
        assert np.array_equal(snap.src_idx, live.src_idx)
        assert rt.restore_report["checkpoint"] is not None
    assert (_report_counts(mine.restore_report)
            == _report_counts(theirs.restore_report))
    assert mine.restore_report["replayed_batches"] == len(batches) - \
        len(batches) // 2
    assert mine.placement == theirs.placement == placement
    assert np.allclose(mine.latest().points, theirs.latest().points,
                       rtol=1e-5, atol=1e-6)
    mine.close()
    theirs.close()


def test_shard_map_checkpoint_raises_step_11(rng, tmp_path):
    """A reference checkpoint of the ``shard_map`` drive is never
    rewritten to another drive: since step 11 the port restores it under
    ``shard_map``, to the writer's stream (snapshot ``src_idx`` and epoch
    fingerprint)."""
    P, cats, caps, spec, k = _instance(rng, n=200)
    w = _jruntime(k, caps, num_shards=4, placement="shard_map",
                  durability=str(tmp_path))
    for pts, cs in _batches(P, cats):
        w.ingest(pts, cs)
    live = w.refresh(force=True)
    w.close()
    assert latest_checkpoint(str(tmp_path)) is not None
    mine = StreamRuntime.restore(str(tmp_path), device=CPU)
    assert mine.placement == "shard_map"
    snap = mine.refresh(force=True)
    assert snap.fingerprint == live.fingerprint
    assert np.array_equal(snap.src_idx, live.src_idx)
    mine.close()


@pytest.mark.parametrize("drive", list(PLACEMENTS))
def test_wal_files_are_byte_identical(rng, tmp_path, drive):
    """The same batches through the two runtimes (and through the two
    ``WriteAheadLog``s directly, compaction included) give the same
    ``wal.log`` bytes."""
    placement, S = PLACEMENTS[drive]
    P, cats, caps, spec, k = _instance(rng, n=200)
    batches = _batches(P, cats)
    a, b = tmp_path / "port", tmp_path / "reference"
    dur = dict(checkpoint_every=10 ** 9)
    rt = _runtime(spec, k, caps, num_shards=S, placement=placement,
                  durability=DurabilityConfig(dir=str(a), **dur))
    jrt = _jruntime(k, caps, num_shards=S, placement=placement,
                    durability=jdiv.DurabilityConfig(dir=str(b), **dur))
    for r in (rt, jrt):
        r.ingest(*batches[0])
        for pts, cs in batches[1:]:
            r.submit(pts, cs)
        r.flush()
    wal_a = (a / "wal.log").read_bytes()
    assert wal_a == (b / "wal.log").read_bytes()
    assert len(wal_a) > sum(p.nbytes + c.nbytes for p, c in batches)
    rt.close()
    jrt.close()
    logs = (WriteAheadLog(str(tmp_path / "a.log")),
            jdiv.WriteAheadLog(str(tmp_path / "b.log")))
    for log in logs:
        for i, (pts, cs) in enumerate(batches):
            log.append(10 + i, pts, None if i % 2 else cs)
        log.compact(11)
        log.close()
    assert ((tmp_path / "a.log").read_bytes()
            == (tmp_path / "b.log").read_bytes())


# --------------------------------------------------------------------------
# a checkpoint is a copy, not a view
# --------------------------------------------------------------------------


class _GatedFaults:
    """A fault plan whose ``checkpoint.write`` site blocks until released,
    so another batch can be ingested between the checkpoint's copy and
    its write."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.monotonic = time.monotonic

    def check(self, site: str) -> None:
        if site == "checkpoint.write":
            self.entered.set()
            assert self.release.wait(timeout=60.0)


def test_checkpoint_is_a_copy_not_a_view(rng, tmp_path):
    """The scan updates the state in place, and on the CPU ``.numpy()``
    is a view of the live tensor. A batch ingested after ``checkpoint()``
    copied the state, but before its file was written, must not reach the
    file: restoring it gives the state at the checkpoint."""
    P, cats, caps, spec, k = _instance(rng, n=300)
    batches = _batches(P, cats, 100)
    gate = _GatedFaults()
    d = tmp_path / "live"
    rt = _runtime(spec, k, caps, faults=gate, durability=DurabilityConfig(
        dir=str(d), checkpoint_every=10 ** 9))
    for pts, cs in batches[:2]:
        rt.ingest(pts, cs)
    at_ckpt = _host_states(rt.state)
    fp_at_ckpt = rt.fingerprint
    out: list = []
    saver = threading.Thread(
        target=lambda: out.append(rt.checkpoint(force=True)))
    saver.start()
    assert gate.entered.wait(timeout=60.0)
    rt.ingest(*batches[2])  # the live state moves on, in place
    moved = _host_states(rt.state)
    assert not all(np.array_equal(a, b) for a, b in zip(at_ckpt, moved))
    gate.release.set()
    saver.join(timeout=60.0)
    path = out[0]
    assert path is not None
    state, meta = load_checkpoint(path)
    _assert_state_equal(state, at_ckpt)
    assert meta["n_offered"] == 200
    # restoring the checkpoint alone gives the state at the checkpoint
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(path, alone / os.path.basename(path))
    back = StreamRuntime.restore(str(alone), device=CPU)
    assert back.restore_report["replayed_batches"] == 0
    _assert_state_equal(back.state, at_ckpt)
    assert back.fingerprint == fp_at_ckpt
    back.close()
    rt.close()
