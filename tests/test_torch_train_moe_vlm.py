"""CPU parity of the port's training of the moe (phi3.5-moe-42b-a6.6b:
top-2 ``moe`` blocks; llama4-maverick-400b-a17b: top-1 ``moe_pair``
blocks) and vlm (llama-3.2-vision-90b: ``vlm_super`` blocks with cross
attention over image embeddings) families with the JAX package's, at
their reduced configs: the loss, its aux and every gradient leaf against
``jax.value_and_grad`` of the JAX ``LM.loss``, three ``make_train_step``
steps (M = 1 and M = 2 microbatches, the vlm's images split with its
tokens), remat, the train state carried across with its f32 router, and
the resumable CLI.

The JAX model draws the weights; they cross to the port through
``convert``, and the same numpy tokens (and image embeddings, seeded
normals times 0.1 as tests/test_models.py:19) go to both. phi runs at
capacity factor 1.0 (the reduced config's 4.0 never drops), so the
gradients pass through dropped tokens. Tolerances, as
tests/test_torch_train_ssm.py's: the loss within 1e-5 and every gradient
leaf within 1e-4 relative L2 (f32); three steps' losses within 1e-5 and
parameters within 1e-4.
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
from repro_torch.models import LM, moe
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.train import AdamWConfig, CheckpointManager, StepConfig
from repro_torch.train import make_train_step

ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
         "llama-3.2-vision-90b"]
B, S = 4, 32


def _cfgs(arch, dtype):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    if arch.startswith("phi3.5"):  # drops happen at 1.0
        jcfg = dataclasses.replace(jcfg, capacity_factor=1.0)
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    return jcfg, cfg


def _np(a):
    return np.asarray(a, np.float32)


def _jax_leaves(tree):
    return [_np(x) for x in jax.tree.leaves(tree)]


def _batch(cfg, seed=1, batch=B):
    """Tokens and, for the vlm, image embeddings, as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, S))
    img = None
    if cfg.family == "vlm":
        img = 0.1 * rng.standard_normal((batch, cfg.n_img_tokens,
                                         cfg.d_model), dtype=np.float32)
    return toks, img


def _models(arch, dtype):
    """(JAX model, its weights, port model, the same weights)."""
    jcfg, cfg = _cfgs(arch, dtype)
    jlm, lm = JLM(jcfg), LM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    return jlm, jparams, lm, params


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a, dtype=None):
    return None if a is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grad_match_jax_f32(arch, monkeypatch):
    jlm, jparams, lm, params = _models(arch, "float32")
    toks, img = _batch(lm.cfg)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.loss(p, _j(toks, jnp.int32), _j(img)),
        has_aux=True)(jparams)
    routes = []
    route = moe.moe_route

    def count(x, router, **kw):
        r = route(x, router, **kw)
        routes.append(r)
        return r

    monkeypatch.setattr(moe, "moe_route", count)
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = lm.loss(live, _t(toks), _t(img), remat=False)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jm["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               rtol=1e-5)
    if lm.cfg.family == "moe":
        assert float(metrics["aux"]) > 0
        assert len(routes) == lm.cfg.n_layers // lm.cfg.moe_every
        if arch.startswith("phi3.5"):  # some tokens dropped
            assert any(not bool(r.keep.all()) for r in routes)
    else:
        assert float(metrics["aux"]) == 0.0 and not routes
    jg = _jax_leaves(jgrads)
    assert len(grads) == len(jg)
    for g, w in zip(grads, jg):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        rel = np.linalg.norm(_np(g) - w) / (np.linalg.norm(w) + 1e-30)
        assert rel <= 1e-4, rel


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_loss_or_gradient(arch):
    """remat checkpoints each block and returns its aux with its output:
    the same loss, aux and gradients, bit for bit."""
    _, cfg = _cfgs(arch, "float32")
    lm = LM(cfg)
    params = tree_map(lambda p: p.requires_grad_(True),
                      lm.init(0, device="cpu"))
    toks, img = _batch(cfg)
    out = []
    for remat in (True, False):
        loss, m = lm.loss(params, _t(toks), _t(img), remat=remat)
        out.append((loss, m["aux"],
                    torch.autograd.grad(loss, tree_leaves(params))))
    (l1, a1, g1), (l2, a2, g2) = out
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


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
    toks, img = _batch(cfg, seed=5)
    jbatch = {"tokens": _j(toks, jnp.int32)}
    batch = {"tokens": _t(toks)}
    if img is not None:
        jbatch["img"], batch["img"] = _j(img), _t(img)
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert int(state["step"]) == int(jstate["step"]) == 3
    for a, b in zip(tree_leaves(state["params"]),
                    _jax_leaves(jstate["params"])):
        np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-4)


def test_vlm_microbatches_split_the_images_with_the_tokens(monkeypatch):
    """M = 2: each microbatch's loss sees the image rows of its own token
    rows."""
    _, cfg = _cfgs("llama-3.2-vision-90b", "float32")
    lm = LM(cfg)
    seen = []
    loss = lm.loss

    def spy(params, tokens, img=None, **kw):
        seen.append((tokens.clone(), img.clone()))
        return loss(params, tokens, img, **kw)

    monkeypatch.setattr(lm, "loss", spy)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = {"params": lm.init(0, device="cpu")}
    from repro_torch.train import adamw_init

    state["opt"] = adamw_init(state["params"], c)
    state["step"] = torch.zeros((), dtype=torch.int32)
    toks, img = _batch(cfg, seed=6)
    make_train_step(lm, c, StepConfig(microbatches=2))(
        state, {"tokens": _t(toks), "img": _t(img)})
    assert len(seen) == 2
    for i, (t, im) in enumerate(seen):
        rows = slice(i * B // 2, (i + 1) * B // 2)
        assert torch.equal(t, _t(toks)[rows])
        assert torch.equal(im, _t(img)[rows])


def test_bf16_train_state_keeps_the_f32_router():
    """``train_state_from_arrays`` on a bf16 JAX state: the routers stay
    f32 among bf16 weights (their moments keep the arrays' dtypes), and
    the port's own init draws the same dtypes."""
    jcfg, cfg = _cfgs("llama4-maverick-400b-a17b", "bfloat16")
    jlm = JLM(jcfg)
    opt_cfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jstate = jts.init_train_state(jlm, jax.random.PRNGKey(0), opt_cfg)
    state = train_state_from_arrays(cfg, jax.tree.map(np.asarray, jstate),
                                    device="cpu")
    p = state["params"]["seg0"]
    assert p["moe"]["moe"]["router"].dtype == torch.float32
    assert p["moe"]["moe"]["w_in"].dtype == torch.bfloat16
    assert p["dense"]["mlp"]["w_in"].dtype == torch.bfloat16
    jr = jstate["opt"]["m"]["seg0"]["moe"]["moe"]["router"]
    assert str(state["opt"]["m"]["seg0"]["moe"]["moe"]["router"].dtype) \
        == f"torch.{jr.dtype.name}"
    mine = LM(cfg).init(0, device="cpu")["seg0"]["moe"]["moe"]
    assert mine["router"].dtype == torch.float32
    assert mine["w_out"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(p["moe"]["moe"]["router"]),
        _np(jstate["params"]["seg0"]["moe"]["moe"]["router"]))


def _flat(path):
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def test_cli_resumes_to_the_uninterrupted_run(tmp_path):
    """--arch phi3.5-moe-42b-a6.6b --reduced: --steps 6 preempted by
    SIGTERM after step 4 (checkpoint, return), then the same command
    again: it resumes at 4, and steps 5-6 and the final checkpoint equal an
    uninterrupted 6-step run bit for bit."""
    base = ["--arch", "phi3.5-moe-42b-a6.6b", "--reduced", "--device",
            "cpu", "--steps", "6", "--batch", "4", "--seq", "32",
            "--log-every", "3", "--ckpt-every", "10"]
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
    assert "params/seg0/moe/router" in fa
    for key in fa:
        np.testing.assert_array_equal(fa[key], fb[key], err_msg=key)


def test_cli_refuses_the_vlm():
    """The data pipeline makes no image input: the CLI says so."""
    with pytest.raises(ValueError, match="image"):
        launch_train.main(["--arch", "llama-3.2-vision-90b", "--reduced",
                           "--device", "cpu", "--steps", "1"])
