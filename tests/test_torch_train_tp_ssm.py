"""CPU parity of tensor-parallel training of the ssm and hybrid families on
a ("data", "model") mesh with the JAX package's tensor-parallel step and
with the port's unsharded step.

Reduced mamba2-2.7b (4 Mamba2 layers, 8 heads) and zamba2-7b (two super
blocks of 2 Mamba2 layers and the shared attention block, then one Mamba2
layer) in f32, B = 8, S = 32, three steps at M = 1 and 2 microbatches on
in-process (2, 2) and (1, 2) meshes of CPU positions placed by
``param_specs(..., ("data",), tp="model")``, from the JAX model's initial
state. Each position runs its own Mamba heads (``mamba.tp_mamba_apply``:
``in_proj``, ``conv_w`` and ``conv_b`` gathered whole over the model axis,
B and C whole on every position). Tolerances:

* against the JAX package's ``make_train_step(...,
  grad_specs=param_specs(..., tp="model"))`` under ``jax.jit`` on a 2 x 2
  forced-host mesh (one subprocess, tests/test_torch_train_tp.py's):
  loss rtol 1e-5, grad_norm 1e-4, parameters rtol and atol 1e-4;
* against the port's unsharded step, which differs by the order of the
  sums: losses and grad norms within 1e-6 relative, parameters within
  1e-5 relative L2 per leaf (4.1e-6 measured), moments within 2e-5
  (1.27e-5 measured). The split gated norm's sum of squares changes each
  token's norm scale by an ulp, and the gradients of the per-head
  vectors (A_log, D, dt_bias: 8 entries a layer) cancel to ~1e-8 of
  terms of ~1e-6: zamba2's last Mamba2 layer's A_log gradient lands
  8.1e-6 from the unsharded one after one step (2.6e-6 with its Mamba2
  blocks unsplit; the unsharded port and the JAX package differ by
  5.5e-6 on it), a second moment squares that, and Adam's normalised
  updates carry it on;
* a (2, 1) mesh is the FSDP step on (2,) bit for bit, its collective
  bytes too; the step's bytes are the dry run's.

Then the Mamba2 sub-layer on 1, 2 and 4 positions and the whole loss on
2 against the JAX package within 1e-5, forward and every gradient (the
cut ``in_proj`` blocks and the B and C columns among them); the shared
block's gradient the sum of its uses'; a checkpoint saved on (2, 2)
restored onto one position and back; the refusal of a model axis that
does not divide the Mamba heads.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import LM as JLM
from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.convert import lm_params_from_arrays, train_state_from_arrays
from repro_torch.launch.dryrun import (
    count_cell,
    fsdp_collectives,
    meta_mesh,
    tp_collectives,
)
from repro_torch.models import LM
from repro_torch.models import model as tmodel
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
from test_torch_train_tp import (
    JAX_RUN,
    REPO,
    _cfgs,
    _full,
    _group,
    _mesh,
    _model_slices,
    _np,
    _one_thread,
    _rel,
    _run,
    _specs,
    _tokens,
)

ARCHS = ["mamba2-2.7b", "zamba2-7b"]
B, S = 8, 32
MESHES = [(2, 2), (1, 2)]


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's tensor-parallel steps of both archs on a forced
    2 x 2 host mesh, and their initial states, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_tp_ssm") / "ref.pkl"
    env = dict(os.environ)
    # one thread a device, as the port's side runs (the module takes
    # _one_thread, an autouse fixture, from test_torch_train_tp)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_RUN),
                        str(out), *ARCHS], capture_output=True, text=True,
                       env=env, timeout=600)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", params=ARCHS)
def runs(request, jax_ref):
    """Per M: the port's unsharded three steps and its tensor-parallel ones
    on each mesh of MESHES, from the JAX model's initial state."""
    arch = request.param
    _, cfg = _cfgs(arch)
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    init = jax_ref[arch]["init"]
    toks = _tokens(cfg)
    out = {}
    for M in (1, 2):
        scfg = StepConfig(microbatches=M)
        run = {"jax": jax_ref[arch][M], "lm": lm, "scfg": scfg}
        run["plain"] = _run(make_train_step(lm, c, scfg),
                            train_state_from_arrays(cfg, init,
                                                    device="cpu"), toks)
        for shape in MESHES:
            mesh = _mesh(shape)
            state = sh.shard_tree(train_state_from_arrays(cfg, init,
                                                          device="cpu"),
                                  _specs(lm, c), mesh)
            run[shape] = _run(make_train_step(lm, c, scfg, mesh=mesh),
                              state, toks)
        out[M] = run
    return out


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("M", [1, 2])
def test_tp_steps_match_jax(runs, M, shape):
    run = runs[M]
    jl, jparams = run["jax"]
    got = run[shape]
    for (jloss, jnorm), loss, norm in zip(jl, got["losses"], got["norms"]):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        np.testing.assert_allclose(norm, jnorm, rtol=1e-4)
    params = [t for k, t in got["final"] if k.startswith("params/")]
    assert len(params) == len(jparams)
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("M", [1, 2])
def test_tp_steps_match_the_unsharded_step(runs, M, shape):
    got, want = runs[M][shape], runs[M]["plain"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-6)
    for (ka, a), (kb, b) in zip(got["final"], want["final"]):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape
        tol = 2e-5 if ka.startswith("opt/") else 1e-5
        assert _rel(a, b) <= tol, (ka, _rel(a, b))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("M", [1, 2])
def test_tp_collective_bytes_equal_the_dry_run(runs, M, shape):
    """One step's operand bytes of a position, by kind, are the dry run's:
    the Mamba2 blocks' regroups, reduce-outs and copy-ins beside the
    embedding's, the loss's and the data axis's."""
    run = runs[M]
    lm, scfg = run["lm"], run["scfg"]
    want = dict(fsdp_collectives(lm, scfg, shape[0], B, tp=shape[1]))
    want.update(tp_collectives(lm, scfg, shape[0], shape[1], (B, S)))
    assert run[shape]["colls"] == want
    assert want["regroup"] and want["regroup-sum"] and want["reduce-out"]


def test_dry_run_cell_counts_the_tp_step(runs):
    """The dry run's record of the same train cell on a (2, 2) meta mesh
    counts the model axis's bytes that the (2, 2) step moved, by kind, and
    gives no reason in their place."""
    run = runs[1]
    moved = run[(2, 2)]["colls"]
    c = count_cell(run["lm"].cfg, ShapeConfig("t", "train", S, B),
                   meta_mesh((2, 2), ("data", "model")),
                   opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2,
                                       total_steps=10),
                   step_cfg=run["scfg"])
    assert c["tp_collectives_reason"] is None
    assert c["tp_collectives"] == {k: v for k, v in moved.items()
                                   if k in c["tp_collectives"]}
    assert set(c["tp_collectives"]) == {"reduce-out", "copy-in", "max",
                                        "regroup", "regroup-sum"}
    assert c["per_device"]["collective_bytes"] == sum(moved.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_state_keeps_its_head_slices(arch):
    """Each position of (2, 2) holds its slices as the specs say: in_proj
    split (data, model) across its z | x | B | C | dt groups, out_proj
    (model, data), the head vectors, conv_b and the gated norm over the
    model axis alone, conv_w's channels over it, the block's ln whole."""
    _, cfg = _cfgs(arch)
    lm = LM(cfg)
    c = AdamWConfig()
    d_inner, H, N = tmodel.mamba_dims(cfg)
    conv = d_inner + 2 * N
    seg = "seg0" if cfg.family == "ssm" else "seg1"  # a plain Mamba segment
    state = init_train_state(lm, 0, c, mesh=_mesh((2, 2)),
                             specs=_specs(lm, c))
    for shard in state.shards:
        p = dict(_paths(shard["params"]))
        want = {"in_proj": (cfg.d_model // 2, (2 * d_inner + 2 * N + H) // 2),
                "out_proj": (d_inner // 2, cfg.d_model // 2),
                "conv_w": (cfg.d_conv, conv // 2), "conv_b": (conv // 2,),
                "A_log": (H // 2,), "D": (H // 2,), "dt_bias": (H // 2,),
                "norm": (d_inner // 2,)}
        for key, shp in want.items():
            assert p[f"{seg}/mamba/{key}"].shape[1:] == shp, key
        assert p[f"{seg}/ln"].shape[1:] == (cfg.d_model,)


def test_model_axis_of_one_is_the_fsdp_step_bit_for_bit():
    """(2, 1) placed by the tensor-parallel specs against (2,) placed by
    the FSDP ones: the same steps, states and collective bytes, bit for
    bit, M = 1 and 2 (reduced mamba2-2.7b)."""
    _, cfg = _cfgs("mamba2-2.7b")
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    toks = _tokens(cfg)
    for M in (1, 2):
        scfg = StepConfig(microbatches=M)
        outs = []
        for shape, tp in (((2, 1), "model"), ((2,), None)):
            mesh = _mesh(shape)
            state = init_train_state(lm, 0, c, mesh=mesh,
                                     specs=_specs(lm, c, tp))
            outs.append(_run(make_train_step(lm, c, scfg, mesh=mesh),
                             state, toks, steps=2))
        a, b = outs
        assert a["losses"] == b["losses"] and a["norms"] == b["norms"]
        assert a["colls"] == b["colls"]
        for (ka, x), (kb, y) in zip(a["final"], b["final"]):
            assert ka == kb and torch.equal(x, y), ka


# --------------------------------------------------------------------------
# the Mamba2 sub-layer and the loss against the JAX package
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mamba():
    """A Mamba2 block (``x + mamba(rms_norm(x, ln))``) of the reduced
    mamba2-2.7b, its input and output cotangent, and the JAX package's
    ``mamba_apply`` output and gradients (one jitted ``vjp``)."""
    jcfg, cfg = _cfgs("mamba2-2.7b")
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    block = jax.tree.map(lambda a: np.asarray(a[0]), jp["seg0"])
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)

    def jfn(p, xx):
        h = jcommon.rms_norm(xx, p["ln"])
        return xx + jmamba.mamba_apply(h, p["mamba"], jcfg,
                                       chunk=jcfg.ssd_chunk)[0]

    @jax.jit
    def fwd_bwd(p, xx, d):
        y, vjp = jax.vjp(jfn, p, xx)
        return y, vjp(d)

    jy, (jgp, jgx) = fwd_bwd(block, jnp.asarray(x), jnp.asarray(dy))
    return cfg, block, x, dy, jy, jgp, jgx


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_tp_mamba_sublayer_matches_jax(jax_mamba, tp):
    """A Mamba2 block on ``tp`` positions, each with its slices by the
    specs, against the JAX package's ``mamba_apply``: the output and the
    gradients of x and of every leaf, in_proj's whole (the blocks the
    specs cut across its groups, and the B and C columns every position
    uses): the output entrywise within 1e-5, each gradient within 1e-5
    relative L2 (a leaf's gradient sums over the tokens, and an entry can
    cancel to 1/40 of the leaf's largest: ln's does, at tp = 1 too)."""
    cfg, block, x, dy, jy, jgp, jgx = jax_mamba
    whole = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True),
                         block)
    xt = torch.tensor(x, requires_grad=True)
    ctx = dict(cfg=cfg, group=_group(tp), force=None)
    y, aux = tmodel._tp_block("mamba", _model_slices(whole, cfg, tp), xt,
                              ctx)
    assert aux is None
    y.backward(torch.tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), rtol=1e-5,
                               atol=1e-5)
    got = [("x", xt.grad)] + [(k, t.grad) for k, t in _paths(whole)]
    want = [jgx] + jax.tree.leaves(jgp)
    assert len(got) == len(want) == 10
    for (key, g), w in zip(got, want):
        assert _rel(g, torch.tensor(_np(w))) <= 1e-5, key


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_loss_matches_jax(arch):
    """``LM.tp_loss`` on 2 model positions against the JAX package's
    ``LM.loss``: the loss and every parameter's gradient (a hybrid's
    shared block and trailing Mamba2 segment among them)."""
    jcfg, cfg = _cfgs(arch)
    jlm, lm = JLM(jcfg), LM(cfg)
    jp = jlm.init(jax.random.PRNGKey(3))
    toks = _tokens(cfg, seed=7, batch=2, seq=32)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, jnp.asarray(toks, jnp.int32)),
        has_aux=True))(jp)
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    live = tmodel.tree_map(lambda t: t.requires_grad_(True), params)
    loss, _m = lm.tp_loss(_model_slices(live, cfg, 2), torch.as_tensor(toks),
                          _group(2))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for (key, a), b in zip(_paths(live), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.grad.numpy(), _np(b), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_tp_shared_block_gradient_sums_its_uses(monkeypatch):
    """zamba2's shared attention block over a model axis: each use given
    its own copy of the whole shared block, sliced for the positions (the
    blocks run without remat here, so that a use is one call), the
    copies' gradients summed are the shared block's gradient."""
    _, cfg = _cfgs("zamba2-7b")
    lm = LM(cfg)
    params = tmodel.tree_map(lambda t: t.requires_grad_(True),
                             lm.init(0, device="cpu"))
    toks = torch.as_tensor(_tokens(cfg, batch=2))
    shared = tmodel.tree_leaves(params["shared"])
    whole = torch.autograd.grad(
        lm.tp_loss(_model_slices(params, cfg, 2), toks, _group(2))[0],
        shared)
    uses = []
    block = tmodel._tp_block

    def per_use(kind, ps, x, ctx, cs=None):
        if kind == "dense" and ps is ctx["shared"]:
            copy = tmodel.tree_map(lambda t: t.detach().requires_grad_(True),
                                   params["shared"])
            uses.append(copy)
            ps = _model_slices(copy, cfg, 2)
        return block(kind, ps, x, ctx, cs)

    monkeypatch.setattr(tmodel, "_tp_block", per_use)
    monkeypatch.setattr(tmodel, "checkpoint",
                        lambda fn, *args, use_reentrant: fn(*args))
    loss = lm.tp_loss(_model_slices(params, cfg, 2), toks, _group(2))[0]
    assert len(uses) == cfg.n_layers // cfg.shared_attn_every == 2
    got = torch.autograd.grad(loss, [t for u in uses
                                     for t in tmodel.tree_leaves(u)])
    k = len(shared)
    for i, g in enumerate(whole):
        assert float(got[i].abs().max()) > 0
        torch.testing.assert_close(g, got[i] + got[k + i], rtol=1e-5,
                                   atol=1e-7)


# --------------------------------------------------------------------------
# checkpoints and the refusal
# --------------------------------------------------------------------------


def test_ssm_checkpoint_restores_onto_one_position_and_back(tmp_path):
    """A mamba2 state trained a step on (2, 2) restores onto one position
    with the saved values bit for bit, and one more step there agrees with
    the (2, 2) run's; saved from that position, it restores onto (2, 2)
    bit for bit."""
    _, cfg = _cfgs("mamba2-2.7b")
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batch = {"tokens": torch.as_tensor(_tokens(cfg))}
    m22 = _mesh((2, 2))
    state = init_train_state(lm, 0, c, mesh=m22, specs=_specs(lm, c))
    step = make_train_step(lm, c, mesh=m22)
    state, _m = step(state, batch)
    CheckpointManager(str(tmp_path / "tp"), async_write=False).save(1, state)
    saved = _full(state)
    state, m = step(state, batch)
    want, want_state = float(m["loss"]), _full(state)
    abstract = abstract_train_state(lm, c)
    one = CheckpointManager(str(tmp_path / "tp")).restore(1, abstract,
                                                          device="cpu")
    for (k, a), (_, b) in zip(_full(one), saved):
        assert torch.equal(a, b), k
    CheckpointManager(str(tmp_path / "one"), async_write=False).save(1, one)
    back = CheckpointManager(str(tmp_path / "one")).restore(
        1, abstract, mesh=m22, specs=_specs(lm, c))
    for (k, a), (_, b) in zip(_full(back), saved):
        assert torch.equal(a, b), k
    one, m = make_train_step(lm, c)(one, batch)
    np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-6)
    for (k, a), (_, b) in zip(_full(one), want_state):
        assert _rel(a, b) <= 1e-5, (k, _rel(a, b))


@pytest.mark.parametrize("arch,reduced,tp", [
    ("mamba2-2.7b", True, 3),  # 8 heads
    ("mamba2-2.7b", False, 32),  # 80 heads
    ("zamba2-7b", False, 32),  # 112 Mamba heads; its 32 kv heads divide
])
def test_refused_where_the_model_axis_does_not_divide_the_heads(arch,
                                                                reduced, tp):
    cfg = _cfgs(arch)[1] if reduced else get_config(arch)
    with pytest.raises(NotImplementedError, match="Mamba heads"):
        tmodel.check_tensor_parallel(cfg, tp)
    # 2 divides them, and the production mesh's 16 the full configs'
    for ok in (2,) if reduced else (2, 16):
        tmodel.check_tensor_parallel(cfg, ok)
