"""The moe family on a mesh, beyond the parity of its steps with the JAX
package's (tests/test_torch_train_moe_sharded.py): the experts-split
sub-layer and its parts, batches that do not split, meshes that must give
another mesh's bits, checkpoints, refusals and the launcher.

* ``models.model._tp_moe_sub`` on 1, 2 and 4 model positions (each with
  ``E / tp`` experts, the router and norm replicated) against the JAX
  package's ``_moe_sub``: the output, the aux and every gradient within
  1e-5; ``moe.moe_experts`` on each slice of the experts, the slices'
  outputs adding up to the whole stack's in f32 bit for bit;
* a batch that does not split over the data positions: no routing pass,
  nothing summed, the unsharded steps within 1e-6 (losses) and 1e-5
  (relative L2 per leaf);
* (n, 1) placed by the tensor-parallel specs against (n,) placed by the
  FSDP ones, bit for bit, bytes included;
* a moe checkpoint saved on (2, 2) restored onto (4,) and one position,
  and back;
* a model axis that does not divide ``n_experts`` refused naming the
  rule, also where it does not divide ``n_kv`` either (the kv heads
  split over any model axis, ROADMAP.md step 13.11);
* ``launch.train`` on a data axis of 2;
* the dry run's count of a moe train cell on a meta mesh against what a
  step of that shape moves.

Reduced phi3.5-moe and llama4-maverick in f32 (the launcher's bf16), B =
8, S = 32.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import make_mesh
from repro_torch.launch import train as launch_train
from repro_torch.launch.dryrun import (
    count_cell,
    fsdp_collectives,
    meta_mesh,
    tp_collectives,
)
from repro_torch.launch.mesh import (
    ModelGroup,
    collective_bytes,
    reset_collective_bytes,
)
from repro_torch.models import LM
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
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

ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b"]
B, S = 8, 32



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
    return dict(losses=losses, norms=norms, colls=colls, final=_full(state))


@pytest.mark.parametrize("shape,batch", [((4,), 6), ((2, 2), 3)])
def test_unsplit_batch_counts_the_density_once(shape, batch):
    """A batch that does not split over the data positions: each takes it
    whole, its own counts are the batch's, and no routing pass runs and
    nothing is summed; the steps are the unsharded ones."""
    _, cfg = _cfgs("phi3.5-moe-42b-a6.6b")
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    toks = _tokens(cfg, batch=batch)
    want = _run(make_train_step(lm, c), init_train_state(lm, 0, c,
                                                          device="cpu"),
                toks, steps=2)
    mesh = _mesh(shape)
    spy = _Spy(lm)
    got = _run(make_train_step(lm, c, mesh=mesh),
               init_train_state(lm, 0, c, mesh=mesh,
                                specs=_specs(lm, c, shape)), toks, steps=2)
    assert spy.seen == []
    tp = shape[1] if len(shape) == 2 else 1
    assert got["colls"]["all-reduce"] == 4  # the clip norm's alone
    assert got["colls"] == {**fsdp_collectives(lm, StepConfig(), shape[0],
                                               batch, tp=tp),
                            **tp_collectives(lm, StepConfig(), shape[0], tp,
                                             (batch, S))}
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    for (k, a), (_, b) in zip(got["final"], want["final"]):
        assert _rel(a, b) <= 1e-5, (k, _rel(a, b))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_axis_of_one_is_the_fsdp_step_bit_for_bit(arch, n):
    """(n, 1) placed by the tensor-parallel specs against (n,) placed by
    the FSDP ones: the same steps, states and collective bytes, bit for
    bit, M = 1 and 2."""
    _, cfg = _cfgs(arch)
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    toks = _tokens(cfg)
    for M in (1, 2):
        scfg = StepConfig(microbatches=M)
        outs = []
        for shape in ((n, 1), (n,)):
            mesh = _mesh(shape)
            state = init_train_state(lm, 0, c, mesh=mesh,
                                     specs=_specs(lm, c, shape))
            outs.append(_run(make_train_step(lm, c, scfg, mesh=mesh),
                             state, toks, steps=2))
        a, b = outs
        assert a["losses"] == b["losses"] and a["norms"] == b["norms"]
        assert a["colls"] == b["colls"]
        for (ka, x), (kb, y) in zip(a["final"], b["final"]):
            assert ka == kb and torch.equal(x, y), ka


def test_moe_checkpoint_restores_across_meshes(tmp_path):
    """A moe state trained a step on (2, 2) restores onto (4,) and one
    position, each holding the saved values bit for bit, and one more step
    on each agrees with the (2, 2) run's; and back: what one position
    saves restores onto (2, 2), each position holding its experts."""
    _, cfg = _cfgs("phi3.5-moe-42b-a6.6b")
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batch = {"tokens": torch.as_tensor(_tokens(cfg))}
    m22 = _mesh((2, 2))
    state = init_train_state(lm, 0, c, mesh=m22, specs=_specs(lm, c, (2, 2)))
    step = make_train_step(lm, c, mesh=m22)
    state, _m = step(state, batch)
    CheckpointManager(str(tmp_path / "tp"), async_write=False).save(1, state)
    saved = _full(state)
    state, m = step(state, batch)
    want, want_state = float(m["loss"]), _full(state)
    abstract = abstract_train_state(lm, c)
    for mesh, specs in ((_mesh((4,)), _specs(lm, c, (4,))), (None, None)):
        back = CheckpointManager(str(tmp_path / "tp")).restore(
            1, abstract, mesh=mesh, specs=specs, device="cpu")
        for (k, a), (_, b) in zip(_full(back), saved):
            assert torch.equal(a, b), k
        back, m = make_train_step(lm, c, mesh=mesh)(back, batch)
        np.testing.assert_allclose(float(m["loss"]), want, rtol=1e-6)
        for (k, a), (_, b) in zip(_full(back), want_state):
            assert _rel(a, b) <= 1e-5, (k, _rel(a, b))
    src = init_train_state(lm, 1, c, device="cpu")
    CheckpointManager(str(tmp_path / "one"), async_write=False).save(0, src)
    back = CheckpointManager(str(tmp_path / "one")).restore(
        0, abstract, mesh=m22, specs=_specs(lm, c, (2, 2)))
    w_in = back.shards[3]["params"]["seg0"]["moe"]["w_in"]
    assert w_in.shape == (cfg.n_layers, cfg.n_experts // 2,
                          cfg.d_model // 2, cfg.d_ff)
    assert torch.equal(w_in, src["params"]["seg0"]["moe"]["w_in"][
        :, 2:, cfg.d_model // 2:])
    for (k, a), (_, b) in zip(_full(back), _full(src)):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("n_kv,n_experts,tp,rule", [
    (2, 3, 2, "experts"),  # 2 divides the kv heads, not 3 experts
    (2, 6, 4, "experts"),  # 4 divides neither: the experts rule (the
                           # kv heads split over any axis, step 13.11)
])
def test_refused_where_the_model_axis_does_not_divide_the_experts(
        n_kv, n_experts, tp, rule):
    _, cfg = _cfgs("phi3.5-moe-42b-a6.6b", n_kv=n_kv, n_experts=n_experts)
    lm = LM(cfg)
    with pytest.raises(NotImplementedError, match=rule):
        tmodel.check_tensor_parallel(cfg, tp)
    mesh = _mesh((1, tp))
    with pytest.raises(NotImplementedError, match=rule):  # the step's loss
        lm.tp_loss([lm.init(0, device="cpu")] * tp,
                   torch.as_tensor(_tokens(cfg, batch=2, seq=8)),
                   ModelGroup(mesh, "model", list(range(tp))))


def test_launcher_trains_a_moe_arch_on_a_data_axis():
    """``launch.train`` with ``--data-axis-size 2`` on the CPU (the reduced
    config in bf16) against one position on the same batches: the first
    step's loss within 1e-6 (the same parameters), the later ones within
    1e-3 relative, as each position's bf16 gradient is rounded before the
    two are summed (3.2e-4 measured at step 3)."""
    base = ["--arch", "phi3.5-moe-42b-a6.6b", "--reduced", "--device",
            "cpu", "--steps", "3", "--batch", "8", "--seq", "32",
            "--log-every", "1", "--no-diverse-data"]
    one = launch_train.main(base)
    two = launch_train.main(base + ["--data-axis-size", "2"])
    assert len(two) == 3 and all(np.isfinite(two))
    np.testing.assert_allclose(two[0], one[0], rtol=1e-6)
    np.testing.assert_allclose(two, one, rtol=1e-3)


def _moe_block(arch, seed=0):
    """The first MoE block of the port's seeded parameters as numpy
    arrays, an input and a cotangent."""
    jcfg, cfg = _cfgs(arch)
    params = LM(cfg).init(seed, device="cpu")
    seg = params["seg0"]["moe"] if cfg.moe_every == 2 else params["seg0"]
    block = tmodel.tree_map(lambda t: t[0].numpy(), seg)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, block, x, dy


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_moe_sublayer_matches_jax(arch, tp):
    """``_tp_moe_sub`` with each position's experts (``E / tp``; the
    router and norm replicated) against the JAX package's ``_moe_sub``:
    the output, the aux and every gradient (x, ln2, router, experts)
    within 1e-5, under a cotangent on both."""
    jcfg, cfg, block, x, dy = _moe_block(arch)
    da = 0.7

    def jfn(p, xx):
        return jmodel._moe_sub(p, xx, jcfg)

    (jy, jaux), vjp = jax.vjp(jfn, block, jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(dy), jnp.float32(da)))
    whole = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True),
                         block)
    n = cfg.n_experts // tp
    ps = [dict(ln2=whole["ln2"], moe=dict(
        router=whole["moe"]["router"],
        **{k: whole["moe"][k][j * n:(j + 1) * n]
           for k in ("w_in", "w_gate", "w_out")})) for j in range(tp)]
    xt = torch.tensor(x, requires_grad=True)
    ctx = dict(cfg=cfg, group=ModelGroup(_mesh((1, tp)), "model",
                                         list(range(tp))))
    y, aux = tmodel._tp_moe_sub(ps, xt, ctx)
    torch.autograd.backward((y, aux), (torch.tensor(dy), torch.tensor(da)))
    np.testing.assert_allclose(y.detach().numpy(), _np(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), _np(jgx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(whole["ln2"].grad.numpy(), _np(jgp["ln2"]),
                               rtol=1e-5, atol=1e-5)
    for key in ("router", "w_in", "w_gate", "w_out"):
        np.testing.assert_allclose(whole["moe"][key].grad.numpy(),
                                   _np(jgp["moe"][key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("top_k,cf", [(2, 4.0), (1, 1.25), (2, 1.0)])
def test_expert_parallel_parts_sum_to_moe_apply(parts, top_k, cf):
    """``moe_experts`` on each slice of the experts gives zero for the
    pairs it does not own, and the slices' outputs, added in order, are
    the whole stack's in f32 bit for bit (one nonzero term per (token,
    choice)), drops included."""
    g = torch.Generator().manual_seed(parts * 10 + top_k)
    E, d, f = 8, 16, 24
    x = torch.randn(3, 24, d, generator=g)
    p = dict(router=torch.randn(d, E, generator=g),
             w_in=torch.randn(E, d, f, generator=g) * 0.3,
             w_gate=torch.randn(E, d, f, generator=g) * 0.3,
             w_out=torch.randn(E, f, d, generator=g) * 0.3)
    r = tmoe.moe_route(x, p["router"], top_k=top_k, capacity_factor=cf)
    want = tmoe.moe_experts(x, p, r)
    y, _aux = tmoe.moe_apply(x, p, top_k=top_k, capacity_factor=cf)
    assert torch.equal(y, want)
    n = E // parts
    outs = [tmoe.moe_experts(x, {k: v[j * n:(j + 1) * n] for k, v in
                                 p.items() if k != "router"} | {
        "router": p["router"]}, r, first=j * n) for j in range(parts)]
    acc = outs[0]
    for o in outs[1:]:
        acc = acc + o
    assert torch.equal(acc, want)
    for j, o in enumerate(outs):
        own = ((r.eidx >= j * n) & (r.eidx < (j + 1) * n)).any(-1)
        assert bool((o[~own] == 0).all())


@pytest.mark.parametrize("arch,shape,M", [(ARCHS[0], (2, 2), 2),
                                          (ARCHS[1], (4,), 1)])
def test_dry_run_cell_counts_the_moe_steps_collectives(arch, shape, M):
    """``count_cell`` for a moe train cell on a meta mesh: its data-axis
    collectives (the densities' all-reduce among them) and model-axis
    ones are what one in-process step of the same shape moves, by kind;
    its trace runs the routing pass, so K4 counts three launches an
    attention layer a microbatch (the routing pass, the forward, remat's
    recompute)."""
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    opt = AdamWConfig()
    scfg = StepConfig(microbatches=M)
    mesh = _mesh(shape)
    state = init_train_state(lm, 0, opt, mesh=mesh,
                             specs=_specs(lm, opt, shape))
    toks = torch.as_tensor(_tokens(cfg, seq=16), dtype=torch.int32)
    reset_collective_bytes()
    make_train_step(lm, opt, scfg, mesh=mesh, force="ref")(
        state, {"tokens": toks})
    moved = collective_bytes()
    c = count_cell(cfg, ShapeConfig("t", "train", 16, B),
                   meta_mesh(shape, mesh.axis_names), opt_cfg=opt,
                   step_cfg=scfg)
    tp_kinds = ("reduce-out", "copy-in", "max")
    assert c["tp_collectives"] == {k: moved[k] for k in tp_kinds
                                   if k in moved}
    assert c["tp_collectives_reason"] is None
    assert c["collectives"] == {k: v for k, v in moved.items()
                                if k not in tp_kinds}
    attn = sum(n * (2 if kind == "moe_pair" else 1) for kind, n in lm.plan)
    (k4,) = [k for k in c["kernels"] if k["name"] == "flash_attention_fwd"]
    assert k4["launches"] == 3 * attn * M
