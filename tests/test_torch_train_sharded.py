"""CPU parity of training sharded over a data axis (FSDP) with the JAX
package's step and with the port's unsharded step.

Reduced smollm-135m and zamba2-7b in f32, three steps at M = 1 and 2
microbatches on an in-process mesh of 4 CPU positions (each holds a
quarter of the parameters and moments and takes a quarter of each
microbatch), from the JAX model's initial state. Tolerances:

* against the JAX package's ``make_train_step``, those of
  tests/test_torch_train.py (loss rtol 1e-5, grad_norm 1e-4, parameters
  rtol and atol 1e-4);
* against the port's unsharded step, which differs only by the order of
  the sums: losses and grad norms within 1e-6 relative; the first step's
  gradient (read as the first moment, 0.1 x the clipped gradient) within
  1e-6 relative L2 per leaf; parameters and moments after three steps
  within 1e-5 relative L2 per leaf (3.5e-6 measured, on the Mamba2
  layers' small vectors: ``conv_b`` is zero at init, so it is its three
  updates alone). Not entrywise: Adam's normalised update turns a
  gradient entry that cancels to ~1e-9, whose value the summation order
  decides to ~1%, into a move of ~1% of lr (1.4e-5 measured on one
  entry);
* on a 1-position mesh, the unsharded step bit for bit.

Then the twin of tests/test_distributed.py's elastic restore (3 steps on
4 positions, restore onto 8, 2 more, against 5 on 1: the reference's
5e-2 against the JAX package, 1e-5 port to port, in f32 with an f32
master copy), 4 gloo ranks (spawned once, a ``file://`` store) against
the in-process mesh bit for bit (the steps, a checkpoint written by rank
0 alone and restored, the CLI), a vlm's image rows split with its
tokens, and the CLI on 4 positions preempted and resumed on 2. The moe
family on a data axis is tests/test_torch_train_moe_sharded.py's.
"""
import dataclasses
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import LM as JLM
from repro.train import optimizer as jopt
from repro.train import train_state as jts
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_arrays
from repro_torch.launch import make_mesh
from repro_torch.launch import train as launch_train
from repro_torch.models import LM
from repro_torch.models import sharding as sh
from repro_torch.train import (
    AdamWConfig,
    CheckpointManager,
    StepConfig,
    abstract_train_state,
    init_train_state,
    make_train_step,
)
from repro_torch.train.checkpoint import _paths
from repro_torch.train.train_state import state_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["smollm-135m", "zamba2-7b"]
B, S = 8, 32  # S: two chunks of the reduced zamba2's 16
POS = 4
RANKS = 4


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _np(a):
    return np.asarray(a, np.float32)


def _tokens(cfg, seed=5, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq))


def _mesh(n):
    return make_mesh((n,), ("data",), devices=["cpu"] * n)


def _specs(lm, opt_cfg):
    return state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                      tp=None), opt_cfg)


def _full(state):
    """(path, tensor) of a state's every leaf, gathered if sharded,
    copied."""
    if isinstance(state, sh.ShardedTree):
        state = sh.gather_tree(state)
    return [(k, t.clone()) for k, t in _paths(state)]


def _run(step, state, toks, steps=3):
    """Losses, grad norms, the first step's first moment and the final
    state of ``steps`` steps."""
    losses, norms, m1 = [], [], None
    for i in range(steps):
        state, m = step(state, {"tokens": torch.as_tensor(toks)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            m1 = [t for k, t in _full(state) if k.startswith("opt/m/")]
    return dict(losses=losses, norms=norms, m1=m1, final=_full(state))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: the reduced models'
    ops are too small to gain from more, and the suite runs several test
    processes on one host's cores, where more threads a process only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """Per M: the JAX package's three steps, the port's unsharded ones,
    and the port's on in-process meshes of 4 and 1 CPU positions, all
    from the JAX model's initial state."""
    jcfg, cfg = _cfgs(request.param)
    jlm, lm = JLM(jcfg), LM(cfg)
    jc = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jstate0 = jts.init_train_state(jlm, jax.random.PRNGKey(0), jc)
    arrays = jax.tree.map(np.asarray, jstate0)
    toks = _tokens(cfg)
    out = {}
    for M in (1, 2):
        jstep = jax.jit(jts.make_train_step(jlm, jc, jts.StepConfig(
            microbatches=M)))
        js, jl = jstate0, []
        for _ in range(3):
            js, jm = jstep(js, {"tokens": jnp.asarray(toks, jnp.int32)})
            jl.append((float(jm["loss"]), float(jm["grad_norm"])))
        run = {"jax": (jl, [_np(x) for x in jax.tree.leaves(js["params"])])}
        scfg = StepConfig(microbatches=M)
        run["plain"] = _run(make_train_step(lm, c, scfg),
                            train_state_from_arrays(cfg, arrays,
                                                    device="cpu"), toks)
        for n in (1, POS):
            mesh = _mesh(n)
            state = sh.shard_tree(train_state_from_arrays(cfg, arrays,
                                                          device="cpu"),
                                  _specs(lm, c), mesh)
            run[n] = _run(make_train_step(lm, c, scfg, mesh=mesh), state,
                          toks)
        out[M] = run
    return out


@pytest.mark.parametrize("M", [1, 2])
def test_sharded_steps_match_jax(runs, M):
    run = runs[M]
    jl, jparams = run["jax"]
    got = run[POS]
    for (jloss, jnorm), loss, norm in zip(jl, got["losses"], got["norms"]):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        np.testing.assert_allclose(norm, jnorm, rtol=1e-4)
    params = [t for k, t in got["final"] if k.startswith("params/")]
    assert len(params) == len(jparams)
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M", [1, 2])
def test_sharded_steps_match_the_unsharded_step(runs, M):
    got, want = runs[M][POS], runs[M]["plain"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-6)
    for a, b in zip(got["m1"], want["m1"]):
        rel = float((a.double() - b.double()).norm()
                    / (b.double().norm() + 1e-30))
        assert rel <= 1e-6, rel
    for (ka, a), (kb, b) in zip(got["final"], want["final"]):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape
        rel = float((a.double() - b.double()).norm()
                    / (b.double().norm() + 1e-30))
        assert rel <= 1e-5, (ka, rel)


@pytest.mark.parametrize("M", [1, 2])
def test_one_position_is_the_unsharded_step_bit_for_bit(runs, M):
    got, want = runs[M][1], runs[M]["plain"]
    assert got["losses"] == want["losses"] and got["norms"] == want["norms"]
    for (ka, a), (kb, b) in zip(got["final"], want["final"]):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b), ka


def test_elastic_restore_4_to_8_positions(tmp_path):
    """tests/test_distributed.py's elastic restore: 3 steps on 4
    positions, a checkpoint, restored onto 8, 2 more steps; against 5
    steps on 1 position and the JAX package's 5 steps."""
    jcfg, cfg = _cfgs("smollm-135m")
    jlm, lm = JLM(jcfg), LM(cfg)
    jc = jopt.AdamWConfig(lr=1e-3, master_dtype="float32")
    c = AdamWConfig(lr=1e-3, master_dtype="float32")
    jstate = jts.init_train_state(jlm, jax.random.PRNGKey(0), jc)
    arrays = jax.tree.map(np.asarray, jstate)
    toks = _tokens(cfg, seed=5, batch=8, seq=16)
    batch = {"tokens": torch.as_tensor(toks)}
    specs = _specs(lm, c)
    m4 = _mesh(4)
    state = sh.shard_tree(train_state_from_arrays(cfg, arrays,
                                                  device="cpu"), specs, m4)
    step = make_train_step(lm, c, mesh=m4)
    for _ in range(3):
        state, _m = step(state, batch)
    CheckpointManager(str(tmp_path), async_write=False).save(3, state)
    m8 = _mesh(8)
    state = CheckpointManager(str(tmp_path)).restore(
        3, abstract_train_state(lm, c), mesh=m8, specs=specs)
    assert len(state.shards) == 8
    assert state.shards[7]["params"]["embed"].shape[1] == \
        cfg.d_model // 8
    step = make_train_step(lm, c, mesh=m8)
    for _ in range(2):
        state, m = step(state, batch)
    l8 = float(m["loss"])
    one = train_state_from_arrays(cfg, arrays, device="cpu")
    step = make_train_step(lm, c)
    for _ in range(5):
        one, m = step(one, batch)
    l1 = float(m["loss"])
    jstep = jax.jit(jts.make_train_step(jlm, jc))
    for _ in range(5):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert abs(l8 - l1) <= 1e-5, (l8, l1)
    assert abs(l8 - float(jm["loss"])) < 5e-2, (l8, float(jm["loss"]))
    assert int(state.shards[0]["step"]) == 5


def test_vlm_images_split_with_the_tokens(monkeypatch):
    """2 positions, M = 2: each position's loss sees the image rows of its
    own token rows, and the step is the unsharded one's."""
    _, cfg = _cfgs("llama-3.2-vision-90b")
    lm = LM(cfg)
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)))
    img = torch.as_tensor(0.1 * rng.standard_normal(
        (4, cfg.n_img_tokens, cfg.d_model), dtype=np.float32))
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    seen = []
    loss = lm.loss

    def spy(params, tokens, img=None, **kw):
        seen.append((tokens.clone(), img.clone()))
        return loss(params, tokens, img, **kw)

    scfg = StepConfig(microbatches=2)
    plain, pm = make_train_step(lm, c, scfg)(
        init_train_state(lm, 0, c, device="cpu"),
        {"tokens": toks, "img": img})
    monkeypatch.setattr(lm, "loss", spy)
    mesh = _mesh(2)
    state, m = make_train_step(lm, c, scfg, mesh=mesh)(
        init_train_state(lm, 0, c, mesh=mesh),
        {"tokens": toks, "img": img})
    assert len(seen) == 4  # 2 microbatches x 2 positions, one row each
    for (t, im), row in zip(seen, [0, 1, 2, 3]):
        assert torch.equal(t, toks[row:row + 1])
        assert torch.equal(im, img[row:row + 1])
    np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]),
                               rtol=1e-6)
    for (k, a), (_, b) in zip(_full(state), _paths(plain)):
        assert float((a.double() - b.double()).abs().max()) <= 1e-5, k


def test_sharding_arguments_are_checked():
    _, cfg = _cfgs("smollm-135m")
    lm = LM(cfg)
    c = AdamWConfig()
    pspecs = sh.param_specs(lm.abstract_params(), ("data",), tp=None)
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(lm, c, grad_specs=pspecs)
    mesh = _mesh(2)
    state = init_train_state(lm, 0, c, mesh=mesh)
    batch = {"tokens": torch.as_tensor(_tokens(cfg, batch=4, seq=8))}
    with pytest.raises(ValueError, match="sharded state"):
        make_train_step(lm, c)(state, batch)
    with pytest.raises(ValueError, match="ShardedTree"):
        make_train_step(lm, c, mesh=mesh)(
            init_train_state(lm, 0, c, device="cpu"), batch)
    # every family trains on a model axis (ROADMAP.md steps 13.7-13.11):
    # a vlm's step takes the image rows beside the tokens, and refuses a
    # batch without them
    _, cfg_v = _cfgs("llama-3.2-vision-90b")
    lm_v = LM(cfg_v)
    tp_specs = state_specs(sh.param_specs(lm_v.abstract_params(), ("data",),
                                          tp="model"), c)
    m2 = make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    img = torch.zeros((4, cfg_v.n_img_tokens, cfg_v.d_model))
    step_v = make_train_step(lm_v, c, mesh=m2)
    with pytest.raises(ValueError, match="img"):
        step_v(init_train_state(lm_v, 0, c, mesh=m2, specs=tp_specs), batch)
    _s, m_v = step_v(init_train_state(lm_v, 0, c, mesh=m2, specs=tp_specs),
                     dict(batch, img=img))
    assert np.isfinite(float(m_v["loss"]))
    # a batch of 3 rows does not split over 2 positions: every position
    # takes it whole and keeps its own slices of the whole batch's
    # gradient; only the clip norm is summed over the positions, in
    # another order
    batch = {"tokens": torch.as_tensor(_tokens(cfg, batch=3, seq=8))}
    plain, pm = make_train_step(lm, c)(init_train_state(lm, 0, c,
                                                        device="cpu"), batch)
    state, m = make_train_step(lm, c, mesh=mesh)(state, batch)
    assert float(m["loss"]) == float(pm["loss"])
    np.testing.assert_allclose(float(m["grad_norm"]), float(pm["grad_norm"]),
                               rtol=1e-6)
    for (k, a), (_, b) in zip(_full(state), _paths(plain)):
        rel = float((a.double() - b.double()).norm()
                    / (b.double().norm() + 1e-30))
        assert rel <= 1e-6, (k, rel)


def test_cli_on_4_positions_resumes_on_2(tmp_path):
    """--data-axis-size 4 preempted by SIGTERM after step 4, resumed with
    --data-axis-size 2: the steps before the restore are the uninterrupted
    run's bit for bit, those after within 1e-4 (the bf16 gradients of 2
    and of 4 positions are rounded before they are summed), and the
    checkpoint holds the reference's layout."""
    base = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "8",
            "--seq", "16", "--log-every", "3", "--ckpt-every", "10"]
    full = launch_train.main(base + ["--data-axis-size", "4", "--ckpt-dir",
                                     str(tmp_path / "a")])

    def preempt(step):
        if step == 4:
            os.kill(os.getpid(), signal.SIGTERM)

    first = launch_train.main(base + ["--data-axis-size", "4", "--ckpt-dir",
                                      str(tmp_path / "b")],
                              after_step=preempt)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [4]
    rest = launch_train.main(base + ["--data-axis-size", "2", "--ckpt-dir",
                                     str(tmp_path / "b")])
    assert len(full) == 6 and len(first) == 4 and len(rest) == 2
    assert first == full[:4]
    np.testing.assert_allclose(rest, full[4:], rtol=1e-4)
    assert all(np.isfinite(full))
    with np.load(tmp_path / "b" / "step_0000000006" / "arrays.npz") as z:
        assert {"params/seg0/attn/wq", "opt/m/embed", "opt/step",
                "step"} <= set(z.files)
        assert z["params/embed"].shape == (get_config(
            "smollm-135m").reduced().vocab_padded, 64)


def test_cli_default_is_one_position(monkeypatch):
    """Without torch.distributed the launcher trains on one position
    unless --data-axis-size asks for more, whatever the cards visible (the
    mesh is read with four cards faked, no card touched); so a moe arch
    trains by default, and on the CPU it does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cuda = torch.device("cuda")

    def mesh(*flags):
        return launch_train._mesh(launch_train.parse_args(
            ["--arch", "phi3.5-moe-42b-a6.6b", *flags]), cuda)

    one = mesh()
    assert one.size == 1 and one.devices == (torch.device("cuda", 0),)
    assert mesh("--data-axis-size", "0").devices == tuple(
        torch.device("cuda", i) for i in range(4))
    assert mesh("--data-axis-size", "2").size == 2
    with pytest.raises(RuntimeError, match="found 4 cards"):
        mesh("--data-axis-size", "8")
    monkeypatch.undo()
    losses = launch_train.main(["--arch", "phi3.5-moe-42b-a6.6b", "--reduced",
                                "--device", "cpu", "--steps", "2", "--batch",
                                "4", "--seq", "16", "--log-every", "1"])
    assert len(losses) == 2 and all(np.isfinite(losses))


# --------------------------------------------------------------------------
# gloo ranks
# --------------------------------------------------------------------------

RUN = """
import sys, dataclasses, numpy as np, torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch import make_mesh
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh
from repro_torch.models import LM
from repro_torch.models import sharding as sh
from repro_torch.train import (AdamWConfig, CheckpointManager, StepConfig,
                               abstract_train_state, init_train_state,
                               make_train_step)
from repro_torch.train.checkpoint import _paths
from repro_torch.train.train_state import state_specs
kind, rank, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
if kind == "rank":
    dist.init_process_group("gloo", init_method="file://" + d + "/store",
                            world_size=4, rank=rank)
    mesh = make_mesh((4,), ("data",))
    assert mesh.multi_rank and mesh.rank == rank
else:
    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)
res = {}
grid = make_mesh((2, 2), ("pod", "data"),
                 devices=None if kind == "rank" else ["cpu"] * 4)
for axes in (("data",), ("pod", "data"), ("data", "pod")):
    shards = grid.local_shards(axes)
    got = grid.psum_scatter([torch.as_tensor(np.random.default_rng(s)
                             .standard_normal((8, 3)), dtype=torch.float32)
                             for s, _ in shards], axes, 0)
    res[axes] = [(s, g) for (s, _), g in zip(shards, got)]
for arch in ("smollm-135m", "zamba2-7b"):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (8, 32)))
    state = init_train_state(lm, 0, c, mesh=mesh)
    step = make_train_step(lm, c, StepConfig(microbatches=2), mesh=mesh)
    out = []
    for _ in range(3):
        state, m = step(state, {"tokens": toks})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    res[arch] = (out, [(k, t.clone()) for k, t in
                       _paths(sh.gather_tree(state))])
    if arch == "smollm-135m":
        ck = d + "/ckpt_" + kind
        mgr = CheckpointManager(ck)
        mgr.save(3, state)
        mgr.wait()
        back = CheckpointManager(ck).restore(
            3, abstract_train_state(lm, c), mesh=mesh,
            specs=state_specs(sh.param_specs(lm.abstract_params(),
                                             ("data",), tp=None), c))
        res["restored"] = [(k, t.clone()) for k, t in _paths(back.shards[0])]
        res["mine"] = [(k, t.clone()) for k, t in _paths(state.shards[0])]
res["cli"] = launch_train.main([
    "--reduced", "--device", "cpu", "--data-axis-size", "4", "--steps", "4",
    "--batch", "8", "--seq", "16", "--log-every", "2", "--ckpt-dir",
    d + "/cli_" + kind])
torch.save(res, d + "/" + kind + str(rank) + ".pt")
if kind == "rank":
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Each rank's results, from one spawn of 4 gloo ranks, and the
    in-process mesh's, from one more process with the same threads."""
    d = tmp_path_factory.mktemp("gloo_train")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    code = textwrap.dedent(RUN)
    jobs = [("rank", r) for r in range(RANKS)] + [("inproc", 0)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, kind, str(r), str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for kind, r in jobs]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for (kind, r), p, log in zip(jobs, procs, logs):
        assert p.returncode == 0, f"{kind} {r}:\n{log}"
    return d, [torch.load(d / f"rank{r}.pt", weights_only=False)
               for r in range(RANKS)], torch.load(d / "inproc0.pt",
                                                  weights_only=False)


def _equal(a, b):
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("arch", ARCHS)
def test_gloo_ranks_give_the_in_process_steps(gloo, arch):
    _d, ranks, inproc = gloo
    for res in ranks:
        assert res[arch][0] == inproc[arch][0]
        _equal(res[arch][1], inproc[arch][1])


def test_gloo_psum_scatter_gives_the_in_process_sums(gloo):
    """The reduce-scatter across ranks (a gather a shard) over a
    sub-group, the world and the world in another shard order: each
    rank's slice is the in-process mesh's for its shard, bit for bit."""
    _d, ranks, inproc = gloo
    for axes in (("data",), ("pod", "data"), ("data", "pod")):
        want = dict(inproc[axes])
        assert sorted(want) == list(range(len(want)))
        for res in ranks:
            ((s, got),) = res[axes]
            assert got.shape == (8 // len(want), 3)
            assert torch.equal(got, want[s]), (axes, s)


def test_gloo_checkpoint_written_once_and_restored(gloo):
    d, ranks, inproc = gloo
    mgr = CheckpointManager(str(d / "ckpt_rank"))
    assert mgr.all_steps() == [3]
    with np.load(d / "ckpt_rank" / "step_0000000003" / "arrays.npz") as z, \
            np.load(d / "ckpt_inproc" / "step_0000000003" / "arrays.npz") \
            as w:
        assert sorted(z.files) == sorted(w.files)
        for key in z.files:
            np.testing.assert_array_equal(z[key], w[key], err_msg=key)
    for res in ranks:
        _equal(res["restored"], res["mine"])  # each rank's own slices


def test_gloo_cli_gives_the_in_process_run(gloo):
    d, ranks, inproc = gloo
    for res in ranks:
        assert res["cli"] == inproc["cli"] and len(res["cli"]) == 4
    with np.load(d / "cli_rank" / "step_0000000004" / "arrays.npz") as z, \
            np.load(d / "cli_inproc" / "step_0000000004" / "arrays.npz") \
            as w:
        for key in z.files:
            np.testing.assert_array_equal(z[key], w[key], err_msg=key)
