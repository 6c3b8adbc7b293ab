"""CPU parity of tensor-parallel training on a ("data", "model") mesh with
the JAX package's tensor-parallel step and with the port's unsharded step.

Reduced smollm-135m (4 heads, 2 kv, tied, SwiGLU) and musicgen-medium
(GELU, untied) in f32, B = 8, S = 32, three steps at M = 1 and 2
microbatches on an in-process (2, 2) mesh of CPU positions placed by
``param_specs(..., ("data",), tp="model")``, from the JAX model's initial
state. Each position computes its own heads, MLP columns and vocab
columns (``LM.tp_loss``). Tolerances:

* against the JAX package's ``make_train_step(...,
  grad_specs=param_specs(..., tp="model"))`` under ``jax.jit`` with
  ``NamedSharding``s on a 2 x 2 forced-host mesh (one subprocess), those of
  tests/test_torch_train_sharded.py: loss rtol 1e-5, grad_norm 1e-4,
  parameters rtol and atol 1e-4;
* against the port's unsharded step, which differs by the order of the
  sums (the row slices' products summed across the model axis, the
  gradients across both axes): losses and grad norms within 1e-6
  relative, parameters and moments within 1e-5 relative L2 per leaf
  (3.5e-6 measured, on the moments of the attention and MLP weights);
* a (n, 1) mesh is the FSDP step on (n,) bit for bit, its collective
  bytes too.

Then the sub-layers (attention on each position's heads through the
plain K4 and K5, the MLP on column slices) and the vocab-parallel loss
against the JAX package's ``_self_attn_full``, ``_mlp_sub`` and
``LM.loss`` within 1e-5, forward and gradients; checkpoints saved on
(2, 2) restored onto (4,), (1, 2) and one position and back; the meshes
refused before ROADMAP.md steps 13.10 and 13.11 training, and the
refusal of a model axis that the specs cannot split evenly.
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

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import LM as JLM
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_arrays, train_state_from_arrays
from repro_torch.launch import make_mesh
from repro_torch.launch.dryrun import fsdp_collectives, tp_collectives
from repro_torch.launch.mesh import (
    ModelGroup,
    collective_bytes,
    reset_collective_bytes,
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
from repro_torch.train.train_state import state_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["smollm-135m", "musicgen-medium"]
B, S = 8, 32
MESH = (2, 2)

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
for arch in sys.argv[2:]:
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
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
    res[arch] = {"init": jax.tree.map(np.asarray, state0)}
    for M in (1, 2):
        fn = jts.make_train_step(lm, jc, jts.StepConfig(microbatches=M),
                                 grad_specs=pspecs)
        with mesh:
            step = jax.jit(fn, in_shardings=ns((sspecs, {"tokens":
                                                         P("data")})),
                           out_shardings=(ns(sspecs), None))
            s = jax.device_put(state0, ns(sspecs))
            b = {"tokens": jax.device_put(jnp.asarray(toks, jnp.int32),
                                          NamedSharding(mesh, P("data")))}
            ls = []
            for _ in range(3):
                s, m = step(s, b)
                ls.append((float(m["loss"]), float(m["grad_norm"])))
        res[arch][M] = (ls, [np.asarray(x)
                             for x in jax.tree.leaves(s["params"])])
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
"""


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _np(a):
    return np.asarray(a, np.float32)


def _tokens(cfg, seed=5, batch=B, seq=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, seq))


def _mesh(shape):
    axes = ("data", "model")[:len(shape)]
    return make_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _specs(lm, opt_cfg, tp="model"):
    return state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                      tp=tp), opt_cfg)


def _full(state):
    if isinstance(state, sh.ShardedTree):
        state = sh.gather_tree(state)
    return [(k, t.clone()) for k, t in _paths(state)]


def _rel(a, b):
    return float((a.double() - b.double()).norm()
                 / (b.double().norm() + 1e-30))


def _run(step, state, toks, steps=3):
    """Losses, grad norms, the first step's collective bytes and the final
    state of ``steps`` steps."""
    losses, norms, colls = [], [], None
    for i in range(steps):
        reset_collective_bytes()
        state, m = step(state, {"tokens": torch.as_tensor(toks)})
        if i == 0:
            colls = collective_bytes()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=losses, norms=norms, colls=colls, final=_full(state),
                state=state)


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


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's tensor-parallel steps on a forced 2 x 2 host
    mesh, and its initial states, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_tp") / "ref.pkl"
    env = dict(os.environ)
    # one thread a device, as the port's side runs (see _one_thread)
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
    """Per M: the port's unsharded three steps, and its (2, 2) tensor
    parallel ones, from the JAX model's initial state."""
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
        mesh = _mesh(MESH)
        state = sh.shard_tree(train_state_from_arrays(cfg, init,
                                                      device="cpu"),
                              _specs(lm, c), mesh)
        run["tp"] = _run(make_train_step(lm, c, scfg, mesh=mesh), state,
                         toks)
        out[M] = run
    return out


@pytest.mark.parametrize("M", [1, 2])
def test_tp_steps_match_jax(runs, M):
    run = runs[M]
    jl, jparams = run["jax"]
    got = run["tp"]
    for (jloss, jnorm), loss, norm in zip(jl, got["losses"], got["norms"]):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        np.testing.assert_allclose(norm, jnorm, rtol=1e-4)
    params = [t for k, t in got["final"] if k.startswith("params/")]
    assert len(params) == len(jparams)
    for a, b in zip(params, jparams):
        np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M", [1, 2])
def test_tp_steps_match_the_unsharded_step(runs, M):
    got, want = runs[M]["tp"], runs[M]["plain"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-6)
    for (ka, a), (kb, b) in zip(got["final"], want["final"]):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape
        assert _rel(a, b) <= 1e-5, (ka, _rel(a, b))


@pytest.mark.parametrize("M", [1, 2])
def test_tp_state_keeps_its_slices(runs, M):
    """Each position holds its model and data slice of every leaf, as the
    specs say: embed's rows over the model axis and columns over the data
    axis, wq's the other way round, a norm whole."""
    state = runs[M]["tp"]["state"]
    lm = runs[M]["lm"]
    cfg = lm.cfg
    assert len(state.shards) == 4
    for shard in state.shards:
        p = shard["params"]
        assert p["embed"].shape == (cfg.vocab_padded // 2, cfg.d_model // 2)
        assert p["seg0"]["attn"]["wq"].shape == (
            cfg.n_layers, cfg.d_model // 2, cfg.n_heads * cfg.hd // 2)
        assert p["seg0"]["attn"]["wo"].shape == (
            cfg.n_layers, cfg.n_heads * cfg.hd // 2, cfg.d_model // 2)
        assert p["final_norm"].shape == (cfg.d_model,)


@pytest.mark.parametrize("M", [1, 2])
def test_tp_collective_bytes_equal_the_dry_run(runs, M):
    """One step's operand bytes of a position, by kind, are what the dry
    run works out from the step's schedule: the model axis's reduce-outs,
    copy-ins and max (``tp_collectives``), the data axis's gathers and
    reduce-scatters (``fsdp_collectives``)."""
    run = runs[M]
    lm, scfg = run["lm"], run["scfg"]
    want = dict(fsdp_collectives(lm, scfg, MESH[0], B, tp=MESH[1]))
    want.update(tp_collectives(lm, scfg, MESH[0], MESH[1], (B, S)))
    assert run["tp"]["colls"] == want
    assert want["reduce-out"] and want["copy-in"] and want["max"]


@pytest.mark.parametrize("n", [2, 4])
def test_model_axis_of_one_is_the_fsdp_step_bit_for_bit(n):
    """(n, 1) placed by the tensor-parallel specs against (n,) placed by
    the FSDP ones: the same steps, states and collective bytes, bit for
    bit, M = 1 and 2."""
    _, cfg = _cfgs("smollm-135m")
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    toks = _tokens(cfg)
    for M in (1, 2):
        scfg = StepConfig(microbatches=M)
        outs = []
        for shape, tp in (((n, 1), "model"), ((n,), None)):
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
# the sub-layers and the loss against the JAX package
# --------------------------------------------------------------------------


def _group(tp):
    mesh = _mesh((1, tp))
    return ModelGroup(mesh, "model", list(range(tp)))


def _cols(t, tp, j, dim):
    """Slice j of tp along ``dim``."""
    n = t.shape[dim] // tp
    return t.narrow(dim, j * n, n)


def _block_slices(p, tp):
    """Each model position's slices of one dense block's parameters (the
    specs' model dims: columns of wq/wk/wv/w_in/w_gate, rows of wo and
    w_out)."""
    out = []
    for j in range(tp):
        attn = {k: _cols(p["attn"][k], tp, j, 1) for k in ("wq", "wk", "wv")}
        attn["wo"] = _cols(p["attn"]["wo"], tp, j, 0)
        mlp = {k: _cols(v, tp, j, 0 if k == "w_out" else 1)
               for k, v in p["mlp"].items()}
        out.append(dict(ln1=p["ln1"], ln2=p["ln2"], attn=attn, mlp=mlp))
    return out


def _jax_block(arch, seed=0):
    jcfg, cfg = _cfgs(arch)
    jp = JLM(jcfg).init(jax.random.PRNGKey(seed))
    block = jax.tree.map(lambda a: np.asarray(a[0]), jp["seg0"])
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, block, x, dy


def _torch_grads(fn, block, x, dy, tp):
    """fn(slices, x) and the gradients of <fn, dy> in x and in each
    parameter, the slices' gradients put back whole."""
    whole = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True),
                         block)
    xt = torch.tensor(x, requires_grad=True)
    y = fn(_block_slices(whole, tp), xt)
    y.backward(torch.tensor(dy))
    return y.detach(), xt.grad, jax.tree.map(lambda t: t.grad, whole)


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_attention_sublayer_matches_jax(arch, tp):
    jcfg, cfg, block, x, dy = _jax_block(arch)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))

    def jfn(p, xx):
        return jmodel._self_attn_full(p, xx, jnp.asarray(pos), jcfg, False,
                                      False)[0]

    jy, vjp = jax.vjp(jfn, block, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    ctx = dict(cfg=cfg, group=_group(tp), force=None,
               positions=torch.as_tensor(pos))
    y, gx, gp = _torch_grads(
        lambda ps, xx: tmodel._tp_self_attn_full(ps, xx, ctx), block, x, dy,
        tp)
    np.testing.assert_allclose(y.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), _np(jgx), rtol=1e-5, atol=1e-5)
    for key in ("wq", "wk", "wv", "wo"):
        np.testing.assert_allclose(gp["attn"][key].numpy(),
                                   _np(jgp["attn"][key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(gp["ln1"].numpy(), _np(jgp["ln1"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_mlp_sublayer_matches_jax(arch, tp):
    jcfg, cfg, block, x, dy = _jax_block(arch)
    jy, vjp = jax.vjp(lambda p, xx: jmodel._mlp_sub(p, xx, jcfg), block,
                      jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    ctx = dict(cfg=cfg, group=_group(tp))
    y, gx, gp = _torch_grads(
        lambda ps, xx: tmodel._tp_mlp_sub(ps, xx, ctx), block, x, dy, tp)
    np.testing.assert_allclose(y.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx.numpy(), _np(jgx), rtol=1e-5, atol=1e-5)
    for key in block["mlp"]:
        np.testing.assert_allclose(gp["mlp"][key].numpy(),
                                   _np(jgp["mlp"][key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(gp["ln2"].numpy(), _np(jgp["ln2"]),
                               rtol=1e-5, atol=1e-5)


def _model_slices(params, cfg, tp):
    """Each model position's slices of a whole parameter tree, by the
    tensor-parallel specs (whole along the data axis)."""
    specs = sh.param_specs(params, ("data",), tp="model")
    mesh = _mesh((1, tp))
    return [sh._zip_specs(
        lambda _path, leaf, spec: leaf[sh.slices_of(leaf.shape, spec, mesh,
                                                    j, ("model",))],
        params, specs) for j in range(tp)]


@pytest.mark.parametrize("arch", ARCHS)
def test_vocab_parallel_loss_matches_jax(arch):
    """``LM.tp_loss`` on 2 model positions (vocab-parallel embedding, head
    and cross-entropy; the logits never gathered) against the JAX
    package's ``LM.loss``: the loss and every parameter's gradient."""
    jcfg, cfg = _cfgs(arch)
    jlm, lm = JLM(jcfg), LM(cfg)
    jp = jlm.init(jax.random.PRNGKey(3))
    toks = _tokens(cfg, seed=7, batch=2, seq=16)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jlm.loss(p, jnp.asarray(toks, jnp.int32)),
        has_aux=True)(jp)
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jp),
                                   device="cpu")
    live = tmodel.tree_map(lambda t: t.requires_grad_(True), params)
    loss, metrics = lm.tp_loss(_model_slices(live, cfg, 2),
                               torch.as_tensor(toks), _group(2))
    loss.backward()
    loss = float(loss.detach())
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    assert float(metrics["ce"].detach()) == loss
    for a, b in zip(tmodel.tree_leaves(live), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.grad.numpy(), _np(b), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------------
# checkpoints across meshes
# --------------------------------------------------------------------------


def test_checkpoint_restores_across_meshes(tmp_path):
    """A state trained a step on (2, 2) restores onto (4,) (FSDP), (1, 2)
    and one position, each holding the saved values bit for bit; one more
    step on each agrees with the (2, 2) run's. And the reverse: a state
    saved unsharded restores onto (2, 2)."""
    _, cfg = _cfgs("smollm-135m")
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batch = {"tokens": torch.as_tensor(_tokens(cfg))}
    m22 = _mesh(MESH)
    state = init_train_state(lm, 0, c, mesh=m22, specs=_specs(lm, c))
    step = make_train_step(lm, c, mesh=m22)
    state, _m = step(state, batch)
    mgr = CheckpointManager(str(tmp_path / "tp"), async_write=False)
    mgr.save(1, state)
    saved = _full(state)
    state, m = step(state, batch)
    want = float(m["loss"])
    want_state = _full(state)
    abstract = abstract_train_state(lm, c)
    targets = [(_mesh((4,)), _specs(lm, c, None)),
               (_mesh((1, 2)), _specs(lm, c)), (None, None)]
    for mesh, specs in targets:
        back = CheckpointManager(str(tmp_path / "tp")).restore(
            1, abstract, mesh=mesh, specs=specs, device="cpu")
        for (k, a), (_, b) in zip(_full(back), saved):
            assert torch.equal(a, b), k
        back, m = make_train_step(lm, c, mesh=mesh)(back, batch)
        np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-6)
        for (k, a), (_, b) in zip(_full(back), want_state):
            assert _rel(a, b) <= 1e-5, (k, _rel(a, b))
    # the reverse: unsharded and FSDP checkpoints onto (2, 2)
    for i, (mesh, specs) in enumerate(targets[::2]):
        src = init_train_state(lm, 1, c, mesh=mesh, specs=specs,
                               device="cpu")
        d = str(tmp_path / f"src{i}")
        CheckpointManager(d, async_write=False).save(0, src)
        back = CheckpointManager(d).restore(0, abstract, mesh=m22,
                                            specs=_specs(lm, c))
        assert back.shards[3]["params"]["embed"].shape == (
            cfg.vocab_padded // 2, cfg.d_model // 2)
        for (k, a), (_, b) in zip(_full(back), _full(src)):
            assert torch.equal(a, b), k


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", (1, 4)),  # 4 does not divide its 2 kv heads (13.11)
    ("llama-3.2-vision-90b", (1, 2)),  # the vlm (13.10)
])
def test_trains_where_the_model_axis_was_refused(arch, shape):
    """Meshes refused before ROADMAP.md steps 13.10 and 13.11 were done
    train now: one step on each gives the unsharded step's loss within
    1e-6 relative and its parameters within 1e-5 relative L2 a leaf."""
    _, cfg = _cfgs(arch)
    lm = LM(cfg)
    tmodel.check_tensor_parallel(cfg, shape[1])
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batch = {"tokens": torch.as_tensor(_tokens(cfg, batch=4, seq=16))}
    if cfg.family == "vlm":
        batch["img"] = torch.as_tensor(np.random.default_rng(2).standard_normal(
            (4, cfg.n_img_tokens, cfg.d_model)).astype(np.float32) * 0.1)
    mesh = _mesh(shape)
    state, m = make_train_step(lm, c, mesh=mesh)(
        init_train_state(lm, 0, c, mesh=mesh, specs=_specs(lm, c)), batch)
    plain, pm = make_train_step(lm, c)(init_train_state(lm, 0, c,
                                                        device="cpu"), batch)
    np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]),
                               rtol=1e-6)
    for (k, a), (_, b) in zip(_full(state), _full(plain)):
        assert _rel(a, b) <= 1e-5, (k, _rel(a, b))


@pytest.mark.parametrize("arch", ["smollm-135m", "llama-3.2-vision-90b"])
def test_refused_on_a_model_axis(arch):
    """A model axis that the specs cannot split evenly (3 positions: the
    vocab rows of 128, the MLP's 128 columns) is refused where the state
    is placed, naming the leaf."""
    _, cfg = _cfgs(arch)
    lm = LM(cfg)
    c = AdamWConfig()
    tmodel.check_tensor_parallel(cfg, 3)  # the heads split any way
    with pytest.raises(ValueError, match="does not split evenly"):
        init_train_state(lm, 0, c, mesh=_mesh((1, 3)), specs=_specs(lm, c))
