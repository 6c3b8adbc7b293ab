"""CPU parity of tensor-parallel training for the vlm (ROADMAP.md step
13.10) and for model axes that do not divide the kv heads (step 13.11),
with the JAX package's tensor-parallel step and with the port's unsharded
step.

Four cases in f32, B = 8, S = 32, three steps at M = 1 and 2
microbatches on an in-process ("data", "model") mesh of CPU positions
placed by ``param_specs(..., ("data",), tp="model")``, from the JAX
model's initial state:

* reduced llama-3.2-vision-90b (4 heads, 2 kv, 8 image tokens) on (2, 2):
  the cross attention on each position's heads, whole kv heads;
* the same on (1, 4): one query head a position, each kv head's columns
  on two positions (``wk`` and ``wv`` regrouped);
* reduced smollm-135m with 6 heads and 2 kv on (1, 4): the axis divides
  neither (1, 2, 1 and 2 heads a position; ``wq`` and ``wo`` regrouped
  too);
* reduced smollm-135m (4 heads, 2 kv) on (1, 8): four positions hold no
  head and launch nothing.

Tolerances, those of tests/test_torch_train_tp.py: against the JAX
package's ``make_train_step(..., grad_specs=param_specs(...,
tp="model"))`` under ``jax.jit`` on a forced host mesh (one subprocess):
loss rtol 1e-5, grad_norm 1e-4, parameters rtol and atol 1e-4; against
the port's unsharded step: losses and grad norms within 1e-6 relative,
parameters and moments within 1e-5 relative L2 per leaf, or, on a leaf
that the f32 step itself moves more than that when the embedding of its
initial state is nudged up by one f32 ulp, within twice that move (the
nudge rule of the card's bf16 checks, here at f32's spacing). The
6-head/2-kv smollm needs it: its layer norms' and ``wk``'s moments move
1.09e-5-1.23e-5 under the nudge and 1.09e-5-1.22e-5 across the split
(measured on a CPU host), as its unsharded f32 step lies 2.3e-5 from the
same step in f64; every other case stays within 1e-5. Each step's
collective bytes equal the dry run's count by kind, to the byte. Then
the sub-layers (the resharded self-attention and the cross attention on
each position's heads, through the plain K4 and K5) against the JAX
package's ``_self_attn_full`` and ``_cross_attn_full`` within 1e-5,
forward and gradients; which positions run attention; and every LM
config on the production mesh's model axis of 16.
"""
import dataclasses
import math
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
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.convert import train_state_from_arrays
from repro_torch.launch import make_mesh
from repro_torch.launch.dryrun import fsdp_collectives, tp_collectives
from repro_torch.launch.mesh import (
    ModelGroup,
    collective_bytes,
    reset_collective_bytes,
)
from repro_torch.kernels import ops
from repro_torch.models import LM
from repro_torch.models import model as tmodel
from repro_torch.models import sharding as sh
from repro_torch.train import AdamWConfig, StepConfig, make_train_step
from repro_torch.train.checkpoint import _paths
from repro_torch.train.train_state import state_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 8, 32
VLM, SMOLLM = "llama-3.2-vision-90b", "smollm-135m"
CASES = {
    "vlm-2x2": (VLM, (2, 2), {}),
    "vlm-1x4": (VLM, (1, 4), {}),
    "smollm-6h2kv-1x4": (SMOLLM, (1, 4), {"n_heads": 6, "n_kv": 2}),
    "smollm-1x8": (SMOLLM, (1, 8), {}),
}

JAX_RUN = """
import dataclasses, json, pickle, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import LM
from repro.models.sharding import param_specs, set_activation_mesh
from repro.train import optimizer as jopt
from repro.train import train_state as jts
set_activation_mesh(("data",), "model")
res = {}
for name, (arch, shape, over) in json.loads(sys.argv[2]).items():
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("data", "model"))
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **over)
    lm = LM(cfg)
    jc = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state0 = jts.init_train_state(lm, jax.random.PRNGKey(0), jc)
    pspecs = param_specs(lm.abstract_params(), ("data",), tp="model")
    sspecs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs,
                                        "step": P()}, "step": P()}
    def ns(tree):
        return jax.tree.map(lambda sp: NamedSharding(mesh, sp), tree,
                            is_leaf=lambda x: isinstance(x, P))
    batch = {"tokens": np.random.default_rng(5).integers(
        0, cfg.vocab, (8, 32)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["img"] = (np.random.default_rng(6).standard_normal(
            (8, cfg.n_img_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    bspecs = {k: P("data") for k in batch}
    res[name] = {"init": jax.tree.map(np.asarray, state0), "batch": batch}
    for M in (1, 2):
        fn = jts.make_train_step(lm, jc, jts.StepConfig(microbatches=M),
                                 grad_specs=pspecs)
        with mesh:
            step = jax.jit(fn, in_shardings=ns((sspecs, bspecs)),
                           out_shardings=(ns(sspecs), None))
            s = jax.device_put(state0, ns(sspecs))
            b = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                               ns(bspecs))
            ls = []
            for _ in range(3):
                s, m = step(s, b)
                ls.append((float(m["loss"]), float(m["grad_norm"])))
        res[name][M] = (ls, [np.asarray(x)
                             for x in jax.tree.leaves(s["params"])])
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
"""


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_get_config(arch).reduced(),
                                dtype="float32", **over),
            dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                                **over))


def _np(a):
    return np.asarray(a, np.float32)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * math.prod(shape))


def _full(state):
    if isinstance(state, sh.ShardedTree):
        state = sh.gather_tree(state)
    return [(k, t.clone()) for k, t in _paths(state)]


def _rel(a, b):
    return float((a.double() - b.double()).norm()
                 / (b.double().norm() + 1e-30))


def _run(step, state, batch, steps=3):
    """Losses, grad norms, the first step's collective bytes and the final
    state of ``steps`` steps."""
    losses, norms, colls = [], [], None
    for i in range(steps):
        reset_collective_bytes()
        state, m = step(state, batch)
        if i == 0:
            colls = collective_bytes()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return dict(losses=losses, norms=norms, colls=colls, final=_full(state))


def _nudged(state):
    """``state`` with its embedding one f32 ulp up."""
    e = state["params"]["embed"]
    e.copy_(torch.nextafter(e, torch.full_like(e, math.inf)))
    return state


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs (as
    tests/test_torch_train_tp.py: the reduced models gain nothing from
    more, and the suite's test processes share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's tensor-parallel steps of every case on a forced
    8-device host mesh (each case on its first devices), their initial
    states and batches, from one subprocess."""
    import json

    out = tmp_path_factory.mktemp("jax_tp_heads") / "ref.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_RUN),
                        str(out), json.dumps(CASES)], capture_output=True,
                       text=True, env=env, timeout=900)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, jax_ref):
    """Per M: the port's unsharded three steps and its tensor-parallel
    ones on the case's mesh, from the JAX model's initial state."""
    arch, shape, over = CASES[request.param]
    _, cfg = _cfgs(arch, **over)
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    ref = jax_ref[request.param]
    batch = {k: torch.as_tensor(v) for k, v in ref["batch"].items()}
    specs = state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                       tp="model"), c)
    out = {}
    for M in (1, 2):
        scfg = StepConfig(microbatches=M)
        run = {"jax": ref[M], "lm": lm, "scfg": scfg, "shape": shape}
        run["plain"] = _run(make_train_step(lm, c, scfg),
                            train_state_from_arrays(cfg, ref["init"],
                                                    device="cpu"), batch)
        run["nudged"] = _run(make_train_step(lm, c, scfg),
                             _nudged(train_state_from_arrays(
                                 cfg, ref["init"], device="cpu")), batch)
        mesh = _mesh(shape)
        state = sh.shard_tree(train_state_from_arrays(cfg, ref["init"],
                                                      device="cpu"),
                              specs, mesh)
        run["tp"] = _run(make_train_step(lm, c, scfg, mesh=mesh), state,
                         batch)
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
    for (ka, a), (kb, b), (_, c) in zip(got["final"], want["final"],
                                        runs[M]["nudged"]["final"]):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape
        if ka == "params/embed":  # the nudged leaf itself: no floor
            assert _rel(a, b) <= 1e-5, (ka, _rel(a, b))
            continue
        tol = max(1e-5, 2 * _rel(c, b))
        assert _rel(a, b) <= tol, (ka, _rel(a, b), tol)


@pytest.mark.parametrize("M", [1, 2])
def test_tp_collective_bytes_equal_the_dry_run(runs, M):
    """One step's operand bytes of a position, by kind, are what the dry
    run works out: the model axis's reduce-outs, copy-ins, max and, where
    the axis does not divide the kv heads, the regroups of ``wk`` and
    ``wv`` (and ``wq`` and ``wo``); the data axis's gathers and
    reduce-scatters."""
    run = runs[M]
    lm, scfg, (n, tp) = run["lm"], run["scfg"], run["shape"]
    want = dict(fsdp_collectives(lm, scfg, n, B, tp=tp))
    want.update(tp_collectives(lm, scfg, n, tp, (B, S)))
    assert run["tp"]["colls"] == want
    assert want["reduce-out"] and want["copy-in"] and want["max"]
    assert ("regroup" in want) == bool(lm.cfg.n_kv % tp)


# --------------------------------------------------------------------------
# the sub-layers against the JAX package
# --------------------------------------------------------------------------


def _group(tp):
    mesh = _mesh((1, tp))
    return ModelGroup(mesh, "model", list(range(tp)))


def _cols(t, tp, j, dim):
    n = t.shape[dim] // tp
    return t.narrow(dim, j * n, n)


def _attn_slices(p, tp):
    """Each model position's slices of an attention block's leaves (the
    specs' model dims: columns of wq/wk/wv, rows of wo)."""
    out = []
    for j in range(tp):
        attn = {k: _cols(p["attn"][k], tp, j, 1) for k in ("wq", "wk", "wv")}
        attn["wo"] = _cols(p["attn"]["wo"], tp, j, 0)
        out.append(dict(ln1=p["ln1"], attn=attn))
    return out


def _jax_block(arch, heads, kv, which, seed=0):
    """One block's parameters of a reduced config with ``heads`` / ``kv``
    heads (the vlm's cross block where ``which`` is "cross"), an input and
    an output gradient, and for the vlm an image."""
    jcfg, cfg = _cfgs(arch, n_heads=heads, n_kv=kv)
    jp = JLM(jcfg).init(jax.random.PRNGKey(seed))
    seg = jp["seg0"]
    block = seg["cross"] if which == "cross" else seg
    block = jax.tree.map(lambda a: np.asarray(a[0]), block)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    img = (rng.standard_normal((2, cfg.n_img_tokens or 8, cfg.d_model))
           * 0.1).astype(np.float32)
    return jcfg, cfg, block, x, dy, img


def _check_sublayer(jfn, tfn, block, x, dy, tp):
    jy, vjp = jax.vjp(jfn, block, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    whole = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True),
                         block)
    xt = torch.tensor(x, requires_grad=True)
    y = tfn(_attn_slices(whole, tp), xt)
    y.backward(torch.tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), _np(jgx), rtol=1e-5,
                               atol=1e-5)
    for key in ("wq", "wk", "wv", "wo"):
        np.testing.assert_allclose(whole["attn"][key].grad.numpy(),
                                   _np(jgp["attn"][key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(whole["ln1"].grad.numpy(), _np(jgp["ln1"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("heads,kv,tp", [
    (6, 2, 4),    # the axis divides neither: 1, 2, 1, 2 heads
    (4, 2, 8),    # four positions hold no head
    (9, 3, 4),    # smollm-135m's heads: 2, 2, 2, 3
    (9, 3, 16),   # smollm-135m on the production model axis
    (8, 1, 4),    # one kv head over every position
])
def test_resharded_self_attention_matches_jax(heads, kv, tp):
    jcfg, cfg, block, x, dy, _img = _jax_block(SMOLLM, heads, kv, "self")
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    ctx = dict(cfg=cfg, group=_group(tp), force=None,
               positions=torch.as_tensor(pos))
    _check_sublayer(
        lambda p, xx: jmodel._self_attn_full(p, xx, jnp.asarray(pos), jcfg,
                                             False, False)[0],
        lambda ps, xx: tmodel._tp_self_attn_full(ps, xx, ctx), block, x, dy,
        tp)


@pytest.mark.parametrize("heads,kv,tp", [
    (4, 2, 1),
    (4, 2, 2),    # whole kv heads a position
    (4, 2, 4),    # each kv head's columns on two positions
    (8, 1, 4),    # llama-3.2-vision on 16 positions, scaled: 2 heads a
                  # position, one kv head on all of them
    (6, 2, 4),    # the axis divides neither
])
def test_cross_attention_sublayer_matches_jax(heads, kv, tp):
    jcfg, cfg, block, x, dy, img = _jax_block(VLM, heads, kv, "cross")
    ctx = dict(cfg=cfg, group=_group(tp), force=None,
               img=torch.as_tensor(img))
    _check_sublayer(
        lambda p, xx: jmodel._cross_attn_full(p, xx, jnp.asarray(img), jcfg,
                                              False)[0],
        lambda ps, xx: tmodel._tp_cross_attn_full(ps, xx, ctx), block, x,
        dy, tp)


@pytest.mark.parametrize("heads,tp,want", [
    (9, 4, [2, 2, 2, 3]),
    (9, 16, [0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 1]),
    (64, 16, [4] * 16),
    (4, 8, [0, 1] * 4),
])
def test_head_ranges_split_the_heads(heads, tp, want):
    ranges = [tmodel.head_range(heads, tp, j) for j in range(tp)]
    assert [hi - lo for lo, hi in ranges] == want
    assert ranges[0][0] == 0 and ranges[-1][1] == heads
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_positions_without_heads_run_no_attention(monkeypatch):
    """Reduced smollm-135m (4 heads) on (1, 8): each layer's forward runs
    the attention forward once on each of the four positions with a head
    (its B rows) and none on the others, whose partials are zero; the
    backward the same."""
    _, cfg = _cfgs(SMOLLM)
    lm = LM(cfg)
    rows = {"flash_attention_fwd": [], "flash_attention_bwd": []}
    for name in rows:
        fn = getattr(ops, name)

        def call(q, *a, _fn=fn, _name=name, **kw):
            rows[_name].append(int(q.shape[0]))
            return _fn(q, *a, **kw)
        monkeypatch.setattr(ops, name, call)
    params = lm.init(0, device="cpu")
    mesh = _mesh((1, 8))
    specs = sh.param_specs(params, ("data",), tp="model")
    parts = [sh._zip_specs(
        lambda _p, leaf, spec: leaf[sh.slices_of(leaf.shape, spec, mesh, j,
                                                 ("model",))].clone()
        .requires_grad_(True), params, specs) for j in range(8)]
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    loss, _ = lm.tp_loss(parts, toks, ModelGroup(mesh, "model",
                                                 list(range(8))))
    loss.backward()
    # forward and remat's recompute, 4 positions a layer, 2 rows each
    assert rows["flash_attention_fwd"] == [2] * (2 * 4 * cfg.n_layers)
    assert rows["flash_attention_bwd"] == [2] * (4 * cfg.n_layers)


# --------------------------------------------------------------------------
# every LM config on the production mesh's model axis
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_lm_config_trains_on_a_model_axis_of_16(arch):
    """``check_tensor_parallel`` passes for each of the ten LM configs
    (``ARCH_IDS``: every config but the DMMC one) at the production
    meshes' model axis of 16, and the dry run counts its train cell's
    model-axis collectives on (16, 16) and (2, 16, 16), with the regroups
    where 16 does not divide the kv heads (or a Mamba2 block's leaves are
    regrouped)."""
    cfg = get_config(arch)
    tmodel.check_tensor_parallel(cfg, 16)
    lm = LM(cfg)
    shape = SHAPES["train_4k"]
    for n_dp in (16, 32):
        got = tp_collectives(lm, StepConfig(), n_dp, 16,
                             (shape.global_batch, shape.seq_len))
        assert got["reduce-out"] > 0 and got["copy-in"] > 0
        assert got["max"] > 0
        regroup = bool(cfg.n_kv and cfg.n_kv % 16) or bool(cfg.ssm_state)
        assert ("regroup" in got) == regroup
