"""CPU parity of the port's training of the ssm (mamba2-2.7b) and hybrid
(zamba2-7b) families with the JAX package's, at their reduced configs:
the loss and every gradient leaf against ``jax.value_and_grad`` of the
JAX ``LM.loss``, the bf16 gradients against JAX's own bf16 error, three
``make_train_step`` steps (M = 1 and M = 2 microbatches), remat, the
shared attention block's gradient summed over its uses, and the
resumable CLI.

The JAX model draws the weights; they cross to the port through
``convert``, and the same numpy tokens go to both. The Mamba2 layers'
intra-chunk step is ``SSDIntraChunk`` (K6's plain version forward, K6b's
backward here on the CPU). Tolerances, as tests/test_torch_train.py's
for the dense family: the loss within 1e-5 and every gradient leaf
within 1e-4 relative L2 in f32; in bf16 each leaf within 3e-2 of the
largest entry of the f32 gradient, or within twice the JAX bf16
gradient's own error there; three steps' losses within 1e-5 and
parameters within 1e-4 (f32).
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
from repro.models import LM as JLM
from repro.train import optimizer as jopt
from repro.train import train_state as jts
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_arrays, train_state_from_arrays
from repro_torch.launch import train as launch_train
from repro_torch.models import LM, model
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.train import (
    AdamWConfig,
    CheckpointManager,
    StepConfig,
    adamw_init,
    adamw_update,
    make_train_step,
)
from repro_torch.train import optimizer

ARCHS = ["mamba2-2.7b", "zamba2-7b"]
B, S = 4, 32  # S: two chunks of the reduced configs' 16


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _np(a):
    return np.asarray(a, np.float32)


def _jax_leaves(tree):
    return [_np(x) for x in jax.tree.leaves(tree)]


def _tokens(cfg, seed=1, batch=B):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, S))


def _models(arch, dtype):
    """(JAX model, its weights, port model, the same weights)."""
    jcfg, cfg = _cfgs(arch, dtype)
    jlm, lm = JLM(jcfg), LM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jlm, jparams, lm, params


def _port_loss_and_grads(lm, params, toks, **kw):
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = lm.loss(live, torch.as_tensor(toks), **kw)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), metrics, grads


def _jax_loss_and_grads(jlm, jparams, toks):
    (loss, _), grads = jax.value_and_grad(
        lambda p: jlm.loss(p, jnp.asarray(toks, jnp.int32)),
        has_aux=True)(jparams)
    return loss, _jax_leaves(grads)


def _rel_max(a, b, scale):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(scale)) + 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_match_jax_f32(arch):
    jlm, jparams, lm, params = _models(arch, "float32")
    toks = _tokens(lm.cfg)
    jloss, jgrads = _jax_loss_and_grads(jlm, jparams, toks)
    loss, metrics, grads = _port_loss_and_grads(lm, params, toks)
    assert loss.dtype == torch.float32 and float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert len(grads) == len(jgrads)
    for g, jg in zip(grads, jgrads):
        assert g.dtype == torch.float32 and tuple(g.shape) == jg.shape
        rel = np.linalg.norm(_np(g) - jg) / (np.linalg.norm(jg) + 1e-30)
        assert rel <= 1e-4, rel


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_bf16_as_close_as_jax(arch):
    """bf16: the JAX f32 gradient of the same (bf16-valued) weights is the
    yardstick; every leaf of the port's bf16 gradient within 3e-2 of its
    largest entry, or within twice the JAX bf16 gradient's own error
    (tests/test_torch_train.py's rule)."""
    jlm, jparams, lm, params = _models(arch, "bfloat16")
    toks = _tokens(lm.cfg)
    jloss, jgrads = _jax_loss_and_grads(jlm, jparams, toks)
    loss, _, grads = _port_loss_and_grads(lm, params, toks)
    jlm32 = JLM(dataclasses.replace(jlm.cfg, dtype="float32"))
    loss32, truth = _jax_loss_and_grads(
        jlm32, jax.tree.map(lambda a: a.astype(jnp.float32), jparams), toks)
    assert all(g.dtype == p.dtype for g, p in zip(grads, tree_leaves(params)))
    np.testing.assert_allclose(float(loss), float(loss32), rtol=1e-2)
    np.testing.assert_allclose(float(jloss), float(loss32), rtol=1e-2)
    for g, jg, t in zip(grads, jgrads, truth):
        err, jax_err = _rel_max(_np(g.float()), t, t), _rel_max(jg, t, t)
        assert err <= max(3e-2, 2 * jax_err), (err, jax_err)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient(arch):
    _, cfg = _cfgs(arch, "float32")
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


def test_shared_attention_gradient_sums_its_uses(monkeypatch):
    """zamba2's shared attention block is one set of weights applied once
    a super block: its gradient is the sum of the gradients of each use.
    Each use is given its own copy of the weights, and the copies'
    gradients, summed, are the shared leaf's."""
    _, cfg = _cfgs("zamba2-7b", "float32")
    lm = LM(cfg)
    params = tree_map(lambda p: p.requires_grad_(True),
                      lm.init(0, device="cpu"))
    toks = torch.as_tensor(_tokens(cfg))
    shared = tree_leaves(params["shared"])
    whole = torch.autograd.grad(lm.loss(params, toks, remat=False)[0],
                                shared)
    uses = []
    apply = model.block_apply_full

    def per_use(kind, p, x, ctx, *, want_cache):
        if kind == "dense" and p is ctx["shared"]:
            p = tree_map(lambda t: t.detach().requires_grad_(True), p)
            uses.append(p)
        return apply(kind, p, x, ctx, want_cache=want_cache)

    monkeypatch.setattr(model, "block_apply_full", per_use)
    loss = lm.loss(params, toks, remat=False)[0]
    assert len(uses) == cfg.n_layers // cfg.shared_attn_every == 2
    parts = torch.autograd.grad(loss, [t for u in uses
                                       for t in tree_leaves(u)])
    k = len(shared)
    for i, g in enumerate(whole):
        total = sum(parts[u * k + i] for u in range(len(uses)))
        assert float(parts[i].abs().max()) > 0
        torch.testing.assert_close(g, total, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("master", [None, "float32"])
def test_adamw_update_in_slices_changes_no_bit(monkeypatch, master):
    """A stacked segment's leaf is updated in slices along its stacked
    axis when it is large (mamba2-2.7b's in_proj): the same bits as the
    whole leaf at once; the norm within f32 rounding."""
    _, cfg = _cfgs("mamba2-2.7b", "bfloat16")
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5,
                    weight_decay=0.5, master_dtype=master)
    rng = np.random.default_rng(0)
    grads = tree_map(lambda p: torch.as_tensor(
        rng.normal(size=p.shape), dtype=torch.float32).to(p.dtype),
        lm.init(0, device="cpu"))
    runs = []
    for elems in (2**28, 1000):  # whole leaves; slices of a few rows
        monkeypatch.setattr(optimizer, "_SLICE_ELEMS", elems)
        params = lm.init(0, device="cpu")
        state = adamw_init(params, c)
        for _ in range(2):
            params, state, stats = adamw_update(grads, state, params, c)
        runs.append((params, state, stats))
    (p1, s1, st1), (p2, s2, st2) = runs
    assert len(optimizer._slices(p2["seg0"]["mamba"]["in_proj"])) > 1
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        assert torch.equal(a, b)
    torch.testing.assert_close(st1["grad_norm"], st2["grad_norm"],
                               rtol=1e-6, atol=0)


@pytest.fixture(scope="module", params=ARCHS)
def jax_f32(request):
    """The JAX model and its train state (f32), per family."""
    jcfg, cfg = _cfgs(request.param, "float32")
    jlm = JLM(jcfg)
    opt_cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = jts.init_train_state(jlm, jax.random.PRNGKey(0), opt_cfg)
    return dict(jlm=jlm, cfg=cfg, state=state, opt_cfg=opt_cfg)


@pytest.mark.parametrize("M", [1, 2])
def test_three_train_steps_match_jax(jax_f32, M):
    jlm, cfg, jopt_cfg = jax_f32["jlm"], jax_f32["cfg"], jax_f32["opt_cfg"]
    jstate = jax_f32["state"]
    jstep = jax.jit(jts.make_train_step(jlm, jopt_cfg,
                                        jts.StepConfig(microbatches=M)))
    state = train_state_from_arrays(cfg, jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    step = make_train_step(LM(cfg), c, StepConfig(microbatches=M))
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


def test_cli_resumes_to_the_uninterrupted_run(tmp_path):
    """--arch mamba2-2.7b --reduced: --steps 6 preempted by SIGTERM after
    step 4 (checkpoint, return), then the same command again: it resumes
    at 4, and steps 5-6 and the final checkpoint equal an uninterrupted
    6-step run bit for bit."""
    base = ["--arch", "mamba2-2.7b", "--reduced", "--device", "cpu",
            "--steps", "6", "--batch", "4", "--seq", "32", "--log-every",
            "3", "--ckpt-every", "10"]
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
    assert "params/seg0/mamba/A_log" in fa
    for key in fa:
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)
