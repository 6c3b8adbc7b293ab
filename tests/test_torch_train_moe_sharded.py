"""CPU parity of training the moe family on a mesh: over a data axis
(FSDP, the expert densities summed between a routing pass and the
gradient pass), over a model axis (the experts split over it) and over
both, with the JAX package's sharded step and with the port's unsharded
step.

Reduced phi3.5-moe (the ``moe`` plan: 4 layers, top-2 of 4 experts) and
llama4-maverick (``moe_pair``: 2 pairs, top-1 of 4) in f32, B = 8, S =
32, three steps at M = 1 and 2 microbatches, from the JAX model's initial
state, on in-process CPU meshes (2,), (4,), (2, 2) and (1, 2) placed by
``param_specs`` (the tensor-parallel specs on a ("data", "model") mesh).
Tolerances:

* against the JAX package's ``make_train_step(..., grad_specs=
  param_specs(..., tp="model"))`` under ``jax.jit`` on a forced 2 x 2
  host mesh (one subprocess; GSPMD computes the unsharded function on any
  mesh, so it is the reference for every port mesh), those of
  tests/test_torch_train_tp.py: loss rtol 1e-5, grad_norm 1e-4,
  parameters rtol and atol 1e-4;
* against the port's unsharded step: losses and grad norms within 1e-6
  relative, the first step's gradient (read as the first moment, 0.1 x
  the clipped gradient) and every leaf after three steps within 1e-5
  relative L2; the routes and the summed first-choice counts equal.

Then each mesh's collective bytes against the dry run's count (the
density's all-reduce among them), and phi3.5-moe at a capacity factor of
1.25 on both sides, so that tokens drop. The rest of the family's mesh
tests (the experts-split sub-layer, unsplit batches, (n, 1) against (n,),
checkpoints, refusals, the launcher) are
tests/test_torch_train_moe_mesh.py's.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_arrays
from repro_torch.launch import make_mesh
from repro_torch.launch.dryrun import fsdp_collectives, tp_collectives
from repro_torch.launch.mesh import collective_bytes, reset_collective_bytes
from repro_torch.models import LM
from repro_torch.models import moe as tmoe
from repro_torch.models import sharding as sh
from repro_torch.train import AdamWConfig, StepConfig, make_train_step
from repro_torch.train.checkpoint import _paths
from repro_torch.train.train_state import state_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]
MESHES = [(2,), (4,), (2, 2), (1, 2)]
B, S = 8, 32
DROPPY = 1.25  # the capacity factor at which tokens drop

JAX_RUN = """
import dataclasses, pickle, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import make_mesh
from repro.models import LM
from repro.models.sharding import param_specs, set_activation_mesh
from repro.train import optimizer as jopt
from repro.train import train_state as jts
mesh = make_mesh((2, 2), ("data", "model"))
set_activation_mesh(("data",), "model")
res = {}
cases = [(a, M, None) for a in sys.argv[3:] for M in (1, 2)]
cases += [(sys.argv[3], 1, float(sys.argv[2]))]
for arch, M, cf in cases:
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    if cf is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    lm = LM(cfg)
    jc = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state0 = jts.init_train_state(lm, jax.random.PRNGKey(0), jc)
    pspecs = param_specs(lm.abstract_params(), ("data",), tp="model")
    sspecs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs,
                                        "step": P()}, "step": P()}
    def ns(tree):
        return jax.tree.map(lambda sp: NamedSharding(mesh, sp), tree,
                            is_leaf=lambda x: isinstance(x, P))
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (8, 32))
    res.setdefault(arch, {"init": jax.tree.map(np.asarray, state0)})
    fn = jts.make_train_step(lm, jc, jts.StepConfig(microbatches=M),
                             grad_specs=pspecs)
    with mesh:
        step = jax.jit(fn, in_shardings=ns((sspecs, {"tokens": P("data")})),
                       out_shardings=(ns(sspecs), None))
        s = jax.device_put(state0, ns(sspecs))
        b = {"tokens": jax.device_put(jnp.asarray(toks, jnp.int32),
                                      NamedSharding(mesh, P("data")))}
        ls = []
        for _ in range(3):
            s, m = step(s, b)
            ls.append((float(m["loss"]), float(m["grad_norm"])))
    res[arch][M, cf] = (ls, [np.asarray(x)
                             for x in jax.tree.leaves(s["params"])])
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
"""



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


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                                **kw))


def _np(a):
    return np.asarray(a, np.float32)


def _tokens(cfg, seed=5, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq))


def _mesh(shape):
    axes = ("data", "model")[:len(shape)]
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _specs(lm, opt_cfg, shape):
    tp = "model" if len(shape) == 2 else None
    return state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                      tp=tp), opt_cfg)


def _full(state):
    if isinstance(state, sh.ShardedTree):
        state = sh.gather_tree(state)
    return [(k, t.clone()) for k, t in _paths(state)]


def _rel(a, b):
    return float((a.double() - b.double()).norm()
                 / (b.double().norm() + 1e-30))


class _Spy:
    """Records the ``Routes`` of every routing pass of ``lm``'s sharded
    step (``LM.route`` and ``LM.tp_route``), in call order."""

    def __init__(self, lm):
        self.seen = []
        for name in ("route", "tp_route"):
            fn = getattr(lm, name)
            setattr(lm, name, self._wrap(fn))

    def _wrap(self, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            self.seen.append(out)
            return out
        return call


def _run(step, state, toks, steps=3):
    """Losses, grad norms, the first step's collective bytes and first
    moment, and the final state of ``steps`` steps."""
    losses, norms, colls, m1 = [], [], None, None
    for i in range(steps):
        reset_collective_bytes()
        state, m = step(state, {"tokens": torch.as_tensor(toks)})
        if i == 0:
            colls = collective_bytes()
            m1 = [t for k, t in _full(state) if k.startswith("opt/m/")]
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=losses, norms=norms, colls=colls, m1=m1,
                final=_full(state), state=state)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's sharded steps on a forced 2 x 2 host mesh (M = 1
    and 2, and M = 1 at capacity factor ``DROPPY``), and its initial
    states, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_moe") / "ref.pkl"
    env = dict(os.environ)
    # one thread a device, as the port's side runs (see _one_thread)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_RUN),
                        str(out), str(DROPPY), *ARCHS], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


def _port_runs(arch, init, cases, **cfg_kw):
    """Per (M, mesh): the port's three steps from the JAX initial state
    (mesh None: unsharded), each with the routes its routing passes
    recorded."""
    _, cfg = _cfgs(arch, **cfg_kw)
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    toks = _tokens(cfg)
    out = {}
    for M, shape in cases:
        scfg = StepConfig(microbatches=M)
        state = train_state_from_arrays(cfg, init, device="cpu")
        spy = _Spy(lm)
        if shape is None:
            run = _run(make_train_step(lm, c, scfg), state, toks)
        else:
            mesh = _mesh(shape)
            state = sh.shard_tree(state, _specs(lm, c, shape), mesh)
            run = _run(make_train_step(lm, c, scfg, mesh=mesh), state, toks)
        del lm.route, lm.tp_route
        out[M, shape] = dict(run, routes=spy.seen, lm=lm, scfg=scfg)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def runs(request, jax_ref):
    arch = request.param
    cases = [(M, shape) for M in (1, 2) for shape in [None] + MESHES]
    out = _port_runs(arch, jax_ref[arch]["init"], cases)
    return arch, out, jax_ref[arch]


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("shape", MESHES)
def test_moe_sharded_steps_match_jax(runs, shape, M):
    _arch, out, ref = runs
    jl, jparams = ref[M, None]
    got = out[M, shape]
    for (jloss, jnorm), loss, norm in zip(jl, got["losses"], got["norms"]):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        np.testing.assert_allclose(norm, jnorm, rtol=1e-4)
    params = [t for k, t in got["final"] if k.startswith("params/")]
    assert len(params) == len(jparams)
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("shape", MESHES)
def test_moe_sharded_steps_match_the_unsharded_step(runs, shape, M):
    _arch, out, _ref = runs
    got, want = out[M, shape], out[M, None]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-6)
    for a, b in zip(got["m1"], want["m1"]):
        assert _rel(a, b) <= 1e-5
    for (ka, a), (kb, b) in zip(got["final"], want["final"]):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= 1e-5, (ka, _rel(a, b))


@pytest.mark.parametrize("shape", MESHES)
def test_routes_and_counts_equal_the_unsharded_ones(runs, shape):
    """The first step's routing passes: each microbatch's rows, put back
    in order, route as the unsharded model routes the microbatch, and the
    counts summed over the data positions are its counts. Without a data
    split ((1, 2)) no routing pass runs."""
    arch, out, ref = runs
    _, cfg = _cfgs(arch)
    lm = LM(cfg)
    params = train_state_from_arrays(cfg, ref["init"], device="cpu")["params"]
    toks = torch.as_tensor(_tokens(cfg))
    n_dp = shape[0]
    for M in (1, 2):
        seen = out[M, shape]["routes"]
        if n_dp == 1:
            assert seen == []
            continue
        assert len(seen) == 3 * M * n_dp  # every row, microbatch and step
        mb = B // M
        for i in range(M):
            want = lm.route(params, toks[i * mb:(i + 1) * mb])
            rows = seen[i * n_dp:(i + 1) * n_dp]
            for key in want.eidx:
                got = torch.cat([r.eidx[key] for r in rows])
                assert torch.equal(got, want.eidx[key]), (key, i)
                for r in rows:
                    assert torch.equal(r.total[key], want.counts[key])
                    assert r.n_tokens == mb * S


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("shape", MESHES)
def test_moe_collective_bytes_equal_the_dry_run(runs, shape, M):
    """One step's operand bytes of a position, by kind: the data axis's
    (the density's all-reduce among them) as ``fsdp_collectives`` counts
    them, the model axis's as ``tp_collectives``."""
    _arch, out, _ref = runs
    run = out[M, shape]
    lm, scfg = run["lm"], run["scfg"]
    tp = shape[1] if len(shape) == 2 else 1
    want = dict(fsdp_collectives(lm, scfg, shape[0], B, tp=tp))
    want.update(tp_collectives(lm, scfg, shape[0], tp, (B, S)))
    assert run["colls"] == want
    if shape[0] > 1:  # the densities' all-reduce is in the count
        n_moe = sum(n for kind, n in lm.plan if kind in ("moe", "moe_pair"))
        assert want["all-reduce"] > M * n_moe * lm.cfg.n_experts * 4


def test_capacity_drops_match_jax_and_the_unsharded_step(jax_ref):
    """At capacity factor 1.25 tokens drop (a row's choices beyond an
    expert's slots); the sharded steps keep the reference's values
    (phi3.5-moe, top-2)."""
    arch = ARCHS[0]
    _, cfg = _cfgs(arch, capacity_factor=DROPPY)
    out = _port_runs(arch, jax_ref[arch]["init"],
                     [(1, None), (1, (4,)), (1, (2, 2))],
                     capacity_factor=DROPPY)
    kept = []
    for r in out[1, (4,)]["routes"][:4]:
        for key, e in r.eidx.items():
            flat = e.reshape(e.shape[0], -1)
            onehot = torch.nn.functional.one_hot(flat, cfg.n_experts)
            pos = ((torch.cumsum(onehot, 1) - onehot) * onehot).sum(-1)
            kept.append(float((pos < tmoe.capacity(
                S, cfg.top_k, DROPPY, cfg.n_experts)).float().mean()))
    assert min(kept) < 1.0, kept  # tokens dropped
    jl, jparams = jax_ref[arch][1, DROPPY]
    want = out[1, None]
    for shape in ((4,), (2, 2)):
        got = out[1, shape]
        for (jloss, jnorm), loss, norm in zip(jl, got["losses"],
                                              got["norms"]):
            np.testing.assert_allclose(loss, jloss, rtol=1e-5)
            np.testing.assert_allclose(norm, jnorm, rtol=1e-4)
        params = [t for k, t in got["final"] if k.startswith("params/")]
        for a, b in zip(params, jparams):
            np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for (ka, a), (_, b) in zip(got["final"], want["final"]):
            assert _rel(a, b) <= 1e-5, (ka, _rel(a, b))
