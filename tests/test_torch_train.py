"""CPU parity of the port's training slice with the JAX package's, at the
reduced smollm-135m config: the model gradient, AdamW, the train step
(M = 1 and M = 2 microbatches), checkpoints in both directions, the
device SeqCoreset and diverse pick of the data pipeline, and the
resumable CLI.

The JAX model draws the weights; they cross to the port through
``convert``, and the same numpy tokens go to both. Tolerances: gradients
within 1e-4 relative L2 per leaf in f32; in bf16 each leaf within 3e-2 of
the largest entry of the f32 gradient, or within twice the JAX bf16
gradient's own error (bf16 rounding alone moves a gradient by 2-5%
here; the JAX model rounds the attention probabilities to bf16 before
P V, as the bf16 routes of K4 and K5 on the card do, while the plain
versions that run here keep them in f32, ROADMAP §3); three steps'
losses within 1e-5 and parameters within 1e-4 (f32).
"""
import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core.coreset import seq_coreset as jax_seq_coreset
from repro.core.matroid import MatroidSpec as JSpec
from repro.core.matroid import rank_in_group as jax_rank_in_group
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import Pipeline as JPipeline
from repro.data.pipeline import _candidate_pool, _diverse_pick
from repro.models import LM as JLM
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import train_state as jts
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_arrays, train_state_from_arrays
from repro_torch.core import MatroidSpec, rank_in_group, seq_coreset
from repro_torch.data import DataConfig, Pipeline, diverse_pick
from repro_torch.launch import train as launch_train
from repro_torch.models import LM
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.train import (
    AdamWConfig,
    CheckpointManager,
    StepConfig,
    abstract_train_state,
    adamw_init,
    adamw_update,
    init_train_state,
    lr_at,
    make_train_step,
)

B, S = 4, 24


def _cfgs(dtype):
    return (dataclasses.replace(jax_get_config("smollm-135m").reduced(),
                                dtype=dtype),
            dataclasses.replace(get_config("smollm-135m").reduced(),
                                dtype=dtype))


def _np(a):
    return np.asarray(a, np.float32)


def _jax_leaves(tree):
    return [_np(x) for x in jax.tree.leaves(tree)]


def _tokens(cfg, seed=1, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, S))


@pytest.fixture(scope="module")
def jax_f32():
    """The JAX model, its weights and its train state (f32)."""
    jcfg, cfg = _cfgs("float32")
    jlm = JLM(jcfg)
    opt_cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = jts.init_train_state(jlm, jax.random.PRNGKey(0), opt_cfg)
    return dict(jlm=jlm, cfg=cfg, state=state, opt_cfg=opt_cfg)


def _port_loss_and_grads(lm, params, toks):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = lm.loss(live, torch.as_tensor(toks))
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), metrics, grads


def _jax_loss_and_grads(jlm, jparams, toks):
    (loss, _), grads = jax.value_and_grad(
        lambda p: jlm.loss(p, jnp.asarray(toks, jnp.int32)),
        has_aux=True)(jparams)
    return loss, _jax_leaves(grads)


def _rel_max(a, b, scale):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(scale)) + 1e-30))


def test_loss_and_grad_match_jax_f32():
    jcfg, cfg = _cfgs("float32")
    jlm, lm = JLM(jcfg), LM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    toks = _tokens(cfg)
    jloss, jgrads = _jax_loss_and_grads(jlm, jparams, toks)
    loss, metrics, grads = _port_loss_and_grads(lm, params, toks)
    assert loss.dtype == torch.float32 and float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for g, jg in zip(grads, jgrads):
        assert g.dtype == torch.float32
        rel = np.linalg.norm(_np(g) - jg) / (np.linalg.norm(jg) + 1e-30)
        assert rel <= 1e-4, rel


def bf16_grad_errors(seed=1):
    """Per leaf, on tokens drawn with ``seed``: (the port's bf16 gradient's
    largest error, the JAX bf16 gradient's), each against the JAX f32
    gradient of the same bf16-valued weights and relative to its largest
    entry; and the port's bf16, the JAX bf16 and the f32 losses."""
    jcfg, cfg = _cfgs("bfloat16")
    jlm, lm = JLM(jcfg), LM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    toks = _tokens(cfg, seed)
    jloss, jgrads = _jax_loss_and_grads(jlm, jparams, toks)
    loss, _, grads = _port_loss_and_grads(lm, params, toks)
    jlm32 = JLM(dataclasses.replace(jcfg, dtype="float32"))
    loss32, truth = _jax_loss_and_grads(
        jlm32, jax.tree.map(lambda a: a.astype(jnp.float32), jparams), toks)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    errs = [(_rel_max(_np(g.float()), t, t), _rel_max(jg, t, t))
            for g, jg, t in zip(grads, jgrads, truth)]
    return errs, (float(loss), float(jloss), float(loss32))


def test_loss_and_grad_bf16_as_close_as_jax():
    """bf16: the f32 gradient of the same (bf16-valued) weights is the
    yardstick. bf16 rounding alone moves the JAX model's own gradient by
    2-5% of a leaf's largest entry from it, more than the 3e-2 that was
    planned for port vs JAX; so every leaf of the port's bf16 gradient
    must be within 3e-2 of the largest entry of the f32 gradient, or
    within twice the JAX bf16 gradient's own error there."""
    errs, (loss, jloss, loss32) = bf16_grad_errors()
    np.testing.assert_allclose(loss, loss32, rtol=1e-2)
    np.testing.assert_allclose(jloss, loss32, rtol=1e-2)
    for err, jax_err in errs:
        assert err <= max(3e-2, 2 * jax_err), (err, jax_err)


def test_remat_changes_no_gradient():
    _, cfg = _cfgs("float32")
    lm = LM(cfg)
    params = tree_map(lambda p: p.requires_grad_(True),
                      lm.init(0, device="cpu"))
    toks = torch.as_tensor(_tokens(cfg))
    g1 = torch.autograd.grad(lm.loss(params, toks, remat=True)[0],
                             tree_leaves(params))
    g2 = torch.autograd.grad(lm.loss(params, toks, remat=False)[0],
                             tree_leaves(params))
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_lr_schedule_matches_jax():
    for sched in ("cosine", "constant"):
        jc = jopt.AdamWConfig(lr=0.7, warmup_steps=10, total_steps=100,
                              schedule=sched)
        c = AdamWConfig(lr=0.7, warmup_steps=10, total_steps=100,
                        schedule=sched)
        for s in (0, 3, 9, 10, 11, 50, 99, 100, 130):
            np.testing.assert_allclose(float(lr_at(c, s)),
                                       float(jopt.lr_at(jc, jnp.int32(s))),
                                       rtol=1e-6)


@pytest.mark.parametrize("master", [None, "float32"])
def test_adamw_update_matches_jax(jax_f32, master):
    """Per leaf, over three updates, including the decay mask p.ndim >= 2:
    a stacked RMSNorm gain (count, d) is decayed, final_norm (d,) is not."""
    cfg = jax_f32["cfg"]
    jparams = jax_f32["state"]["params"]
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5,
                            weight_decay=0.5, master_dtype=master)
    c = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5, weight_decay=0.5,
                    master_dtype=master)
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    jstate, state = jopt.adamw_init(jparams, jcfg), adamw_init(params, c)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = jax.tree.map(
            lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
            jparams)
        jparams, jstate, jstats = jopt.adamw_update(g, jstate, jparams, jcfg)
        tg = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, g),
                                   device="cpu")
        params, state, stats = adamw_update(tg, state, params, c)
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(jstats["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(stats["lr"]), float(jstats["lr"]),
                                   rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
    for name in ("m", "v"):
        for a, b in zip(tree_leaves(state[name]), _jax_leaves(jstate[name])):
            np.testing.assert_allclose(_np(a), b, rtol=1e-5, atol=1e-7)
    for a, b in zip(tree_leaves(params), _jax_leaves(jparams)):
        np.testing.assert_allclose(_np(a), b, rtol=1e-5, atol=1e-6)
    # the decay mask: from fresh moments and zero gradients only the decay
    # moves a parameter; a stacked gain shrinks, final_norm does not
    zero = tree_map(torch.zeros_like, params)
    before = params["seg0"]["ln1"].clone(), params["final_norm"].clone()
    adamw_update(zero, adamw_init(params, c), params, c)
    assert bool(torch.all(params["seg0"]["ln1"] < before[0]))
    assert torch.equal(params["final_norm"], before[1])


@pytest.mark.parametrize("M", [1, 2])
def test_three_train_steps_match_jax(jax_f32, M):
    jlm, cfg, jopt_cfg = jax_f32["jlm"], jax_f32["cfg"], jax_f32["opt_cfg"]
    jstate = jax_f32["state"]
    jstep = jax.jit(jts.make_train_step(jlm, jopt_cfg,
                                        jts.StepConfig(microbatches=M)))
    state = train_state_from_arrays(cfg, jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(lm, c, StepConfig(microbatches=M))
    toks = _tokens(cfg, seed=5)
    for _ in range(3):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks, jnp.int32)})
        state, m = step(state, {"tokens": torch.as_tensor(toks)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert int(state["step"]) == int(jstate["step"]) == 3
    for a, b in zip(tree_leaves(state["params"]),
                    _jax_leaves(jstate["params"])):
        np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-4)


def _flat(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_checkpoint_cross_restore_is_bit_identical(tmp_path):
    """A JAX checkpoint restores into the port, and a port checkpoint into
    the JAX package's manager; the same keys and the same bytes (bf16
    parameters as a uint16 view, f32 moments, int32 counters)."""
    jcfg, cfg = _cfgs("bfloat16")
    jlm, lm = JLM(jcfg), LM(cfg)
    jopt_cfg = jopt.AdamWConfig()
    jstate = jts.init_train_state(jlm, jax.random.PRNGKey(2), jopt_cfg)
    jstate = dict(jstate, step=jnp.int32(7))
    jmgr = jckpt.CheckpointManager(str(tmp_path / "jax"), async_write=False)
    jmgr.save(7, jstate)
    mgr = CheckpointManager(str(tmp_path / "jax"), async_write=False)
    assert mgr.latest_step() == 7
    state = mgr.restore(7, abstract_train_state(lm, AdamWConfig()),
                        device="cpu")
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert int(state["step"]) == 7 and state["step"].dtype == torch.int32
    for a, b in zip(tree_leaves(state), jax.tree.leaves(jstate)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(_np(a.float()), _np(b))
    # and back: the port writes, the JAX package reads
    out = CheckpointManager(str(tmp_path / "port"), async_write=True)
    out.save(7, state)
    out.wait()
    j_again = jckpt.CheckpointManager(str(tmp_path / "port")).restore(
        7, jts.abstract_train_state(jlm, jopt_cfg))
    for a, b in zip(jax.tree.leaves(j_again), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))
    fa = _flat(tmp_path / "jax" / "step_0000000007")
    fb = _flat(tmp_path / "port" / "step_0000000007")
    assert sorted(fa) == sorted(fb)
    assert {"params/seg0/attn/wq", "opt/m/embed", "opt/step",
            "step"} <= set(fa)
    for key in fa:
        assert fa[key].dtype == fb[key].dtype, key
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


def test_checkpoint_keep_n_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"a": torch.ones((4,))}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    # a stale .tmp dir must be invisible to restore
    os.makedirs(os.path.join(str(tmp_path), "step_0000000099.tmp"))
    assert mgr.latest_step() == 4
    got = mgr.restore(4, {"a": torch.empty(4, device="meta")}, device="cpu")
    assert torch.equal(got["a"], tree["a"])


def test_train_state_from_jax_arrays(jax_f32):
    cfg = jax_f32["cfg"]
    jstate = jax_f32["state"]
    state = train_state_from_arrays(cfg, jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    assert state["opt"]["step"].dtype == torch.int32
    for a, b in zip(tree_leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_np(a), _np(b))
    like = abstract_train_state(LM(cfg), AdamWConfig())
    for a, b in zip(tree_leaves(state), tree_leaves(like)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_rank_in_group_and_seq_coreset_match_jax(rng):
    from conftest import make_clustered_points

    n, h, k, tau = 300, 4, 3, 12
    P = make_clustered_points(rng, n=n, d=6)
    cats = rng.integers(0, h, n).astype(np.int32)[:, None]
    caps = np.array([2, 1, 3, 2], np.int32)
    valid = rng.random(n) > 0.05
    gid = rng.integers(0, 7, n).astype(np.int32)
    np.testing.assert_array_equal(
        rank_in_group(torch.as_tensor(gid), torch.as_tensor(valid), 7).numpy(),
        np.asarray(jax_rank_in_group(jnp.asarray(gid), jnp.asarray(valid),
                                     7)))
    for kind in ("uniform", "partition", "transversal"):
        jspec = JSpec(kind, num_categories=h, gamma=1)
        spec = MatroidSpec(kind, num_categories=h, gamma=1)
        jcs, _, jovf = jax_seq_coreset(
            jnp.asarray(P), jnp.asarray(cats), jnp.asarray(valid), jspec,
            jnp.asarray(caps), k, tau)
        cs, _, ovf = seq_coreset(P, cats, valid, spec, caps, k, tau,
                                 device="cpu")
        np.testing.assert_array_equal(cs.src_idx.numpy(),
                                      np.asarray(jcs.src_idx))
        np.testing.assert_array_equal(cs.valid.numpy(), np.asarray(jcs.valid))
        np.testing.assert_array_equal(cs.cats.numpy(), np.asarray(jcs.cats))
        np.testing.assert_allclose(cs.points.numpy(), np.asarray(jcs.points))
        assert int(ovf) == int(jovf) == 0


@pytest.mark.parametrize("step", [0, 1, 7])
def test_diverse_pick_matches_jax_on_its_pool(step):
    jcfg = JDataConfig(vocab=128, seq_len=16, global_batch=8, num_domains=4,
                       selector_tau=6)
    _tok, dom, emb = _candidate_pool(jcfg, step)
    caps = JPipeline(jcfg).caps
    want = _diverse_pick(emb.astype(jnp.float32), dom[:, None], caps, 8, 6,
                         4, cap_total=48)
    got = diverse_pick(torch.as_tensor(np.array(emb)),
                       torch.as_tensor(np.array(dom))[:, None],
                       torch.as_tensor(np.array(caps)), 8, 6, 4, 48)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pipeline_deterministic_seekable_and_capped():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=8, num_domains=4,
                     selector_tau=4)
    p1, p2 = Pipeline(cfg, device="cpu"), Pipeline(cfg, device="cpu")
    b5a = p1.batch_at(5)
    b6 = p1.batch_at(6)
    b5b = p2.batch_at(5)  # a fresh pipeline, direct seek
    assert torch.equal(b5a["tokens"], b5b["tokens"])
    assert not torch.equal(b5a["tokens"], b6["tokens"])
    cap = (8 + 4 - 1) // 4 * 2
    for b in (b5a, b6):
        assert b["tokens"].shape == (8, 16) and b["tokens"].dtype == torch.int32
        assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 128
        counts = torch.bincount(b["domains"].long(), minlength=4)
        assert int(counts.max()) <= cap
    plain = Pipeline(dataclasses.replace(cfg, diverse_selection=False),
                     device="cpu").batch_at(5)
    assert plain["tokens"].shape == (8, 16)


def test_cli_resumes_to_the_uninterrupted_run(tmp_path):
    """--steps 6 preempted by SIGTERM after step 4 (checkpoint, return),
    then the same command again: it resumes at 4, and steps 5-6 and the
    final checkpoint equal an uninterrupted 6-step run bit for bit."""
    base = ["--reduced", "--device", "cpu", "--steps", "6", "--batch", "4",
            "--seq", "16", "--log-every", "3", "--ckpt-every", "10"]
    full = launch_train.main(base + ["--ckpt-dir", str(tmp_path / "a")])

    def preempt(step):
        if step == 4:
            os.kill(os.getpid(), signal.SIGTERM)

    first = launch_train.main(base + ["--ckpt-dir", str(tmp_path / "b")],
                              after_step=preempt)
    assert CheckpointManager(str(tmp_path / "b")).all_steps() == [4]
    rest = launch_train.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    assert len(full) == 6 and len(first) == 4 and len(rest) == 2
    assert first + rest == full
    assert all(np.isfinite(full))
    fa = _flat(tmp_path / "a" / "step_0000000006")
    fb = _flat(tmp_path / "b" / "step_0000000006")
    assert sorted(fa) == sorted(fb)
    for key in fa:
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)
