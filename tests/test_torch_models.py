"""CPU parity of the port's LM stack with the JAX package's, for the
dense (smollm-135m), ssm (mamba2-2.7b) and hybrid (zamba2-7b) families at
the reduced configs.

The JAX model draws its weights; they cross to the port through
``convert.lm_params_from_arrays``, and the same numpy tokens go to both.
In f32 the logits and caches agree within 1e-4 of their largest value.
In bf16 the bound is 3e-2: the JAX model rounds the probabilities to bf16
before P V (repro/models/attention.py:56-58) while K4 and its plain
version keep them in f32 (repro/kernels/flash.py:56-61). The JAX results
are computed once per family (module-scoped fixtures).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.models import LM as JLM
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import pad_caches as jax_pad_caches
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import LM
from repro_torch.models.model import tree_leaves
from repro_torch.serve.engine import Engine, pad_caches

ARCHS = ["smollm-135m", "mamba2-2.7b", "zamba2-7b"]
B, S, PROMPT, STEPS, MAX_LEN = 2, 32, 24, 6, 32
TOL_F32, TOL_BF16, GAP_TOL = 1e-4, 3e-2, 1e-4


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _np(a):
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """The JAX model's results on one family (f32), and the port's model
    with the same weights."""
    arch = request.param
    jcfg, cfg = _cfgs(arch, "float32")
    jlm, lm = JLM(jcfg), LM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(0))
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    jt = jnp.asarray(toks, jnp.int32)
    logits, _, _ = jlm.forward(jparams, jt, remat=False)
    pre_logits, pre_caches = jlm.prefill(jparams, jt[:, :PROMPT])
    padded = jax_pad_caches(jlm, pre_caches, PROMPT, MAX_LEN)
    dec_logits, dec_caches = jlm.decode_step(
        jparams, jt[:, PROMPT:PROMPT + 1], padded, jnp.int32(PROMPT))
    eng = JEngine(jlm, jparams, MAX_LEN)
    gen = eng.generate(jt[:, :PROMPT], STEPS)
    # the logits each generated token was picked from, by the engine's own
    # jitted steps
    lg, caches = eng._prefill(jparams, jt[:, :PROMPT], None)
    caches = jax_pad_caches(jlm, caches, PROMPT, MAX_LEN)
    step_logits = [lg]
    for i in range(STEPS - 1):
        lg, caches = eng._decode(jparams, gen[:, i:i + 1], caches,
                                 jnp.int32(PROMPT + i), None)
        step_logits.append(lg)
    return dict(
        arch=arch, jlm=jlm, jparams=jparams, lm=lm, cfg=cfg, params=params,
        toks=toks, logits=_np(logits), pre_logits=_np(pre_logits),
        pre_caches=[_np(c) for c in jax.tree.leaves(pre_caches)],
        dec_logits=_np(dec_logits),
        dec_caches=[_np(c) for c in jax.tree.leaves(dec_caches)],
        gen=np.asarray(gen), step_logits=np.stack(
            [_np(x) for x in step_logits], axis=1),
    )


def test_param_tree_matches_jax_init(run):
    """The port's init draws the reference's tree: every leaf's shape and
    dtype (A_log, D, dt_bias stay f32)."""
    mine = run["lm"].init(0, device="cpu")
    want = jax.tree.leaves(run["jparams"])
    got = tree_leaves(mine)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == b.dtype.name


def test_init_draws_the_reference_distributions(run):
    """Statistics of the port's draw against the JAX draw: the same means
    and spreads per leaf (not the same numbers: the generators differ)."""
    mine = tree_leaves(run["lm"].init(3, device="cpu"))
    for a, b in zip(mine, jax.tree.leaves(run["jparams"])):
        a, b = a.to(torch.float32).numpy(), _np(b)
        if a.size < 64:  # too few draws for moments: the JAX draw's range
            lo, hi = b.min(), b.max()
            assert lo - (hi - lo) <= a.min() and a.max() <= hi + (hi - lo)
            continue
        np.testing.assert_allclose(a.std(), b.std(), rtol=0.15, atol=1e-6)
        np.testing.assert_allclose(a.mean(), b.mean(),
                                   atol=0.15 * b.std() + 1e-6)


def test_full_width_param_count_matches_jax(run):
    arch = run["arch"]
    want = JLM(jax_get_config(arch)).param_count()
    assert LM(get_config(arch)).param_count() == want
    if arch == "zamba2-7b":
        assert want == 6_751_130_832


def test_forward_logits_match_jax(run):
    got, aux, caches = run["lm"].forward(run["params"],
                                         torch.as_tensor(run["toks"]))
    assert caches is None and float(aux) == 0.0
    assert got.shape == (B, S, run["cfg"].vocab_padded)
    assert _rel(got, run["logits"]) < TOL_F32


def test_prefill_logits_and_caches_match_jax(run):
    logits, caches = run["lm"].prefill(
        run["params"], torch.as_tensor(run["toks"][:, :PROMPT]))
    assert _rel(logits, run["pre_logits"]) < TOL_F32
    got = tree_leaves(caches)
    assert len(got) == len(run["pre_caches"])
    for a, b in zip(got, run["pre_caches"]):
        assert tuple(a.shape) == b.shape
        assert _rel(a, b) < TOL_F32


def test_decode_step_matches_jax(run):
    lm, params = run["lm"], run["params"]
    toks = torch.as_tensor(run["toks"])
    _, caches = lm.prefill(params, toks[:, :PROMPT], cache_len=MAX_LEN)
    logits, caches = lm.decode_step(params, toks[:, PROMPT:PROMPT + 1],
                                    caches, PROMPT)
    assert _rel(logits, run["dec_logits"]) < TOL_F32
    for a, b in zip(tree_leaves(caches), run["dec_caches"]):
        assert tuple(a.shape) == b.shape
        assert _rel(a, b) < TOL_F32


def test_pad_caches_matches_prefill_at_full_length(run):
    lm, params = run["lm"], run["params"]
    toks = torch.as_tensor(run["toks"][:, :PROMPT])
    _, short = lm.prefill(params, toks)
    _, full = lm.prefill(params, toks, cache_len=MAX_LEN)
    grown = pad_caches(lm, short, PROMPT, MAX_LEN)
    for a, b in zip(tree_leaves(grown), tree_leaves(full)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_engine_generates_the_jax_tokens(run):
    """Greedy tokens equal the JAX engine's at every step, unless the JAX
    top-2 gap at the first differing step is under GAP_TOL relative (a
    near-tie that rounding may flip); the comparison stops there."""
    eng = Engine(run["lm"], run["params"], MAX_LEN, device="cpu")
    toks, logits = eng.generate(run["toks"][:, :PROMPT], STEPS,
                                return_logits=True)
    assert toks.shape == (B, STEPS) and toks.dtype == torch.int32
    assert torch.equal(toks, eng.generate(run["toks"][:, :PROMPT], STEPS))
    want, jl = run["gen"], run["step_logits"]
    for b in range(B):
        for t in range(STEPS):
            assert _rel(logits[b, t], jl[b, t]) < TOL_F32
            if int(toks[b, t]) != int(want[b, t]):
                top2 = np.sort(jl[b, t])[-2:]
                gap = (top2[1] - top2[0]) / np.max(np.abs(jl[b, t]))
                assert gap < GAP_TOL, (b, t, gap)
                print(f"row {b}: near-tie at step {t} (gap {gap:.2e}); "
                      f"stopped comparing")
                break


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_jax(arch):
    jcfg, cfg = _cfgs(arch, "bfloat16")
    jlm, lm = JLM(jcfg), LM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(2))
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, S))
    want, _, _ = jlm.forward(jparams, jnp.asarray(toks, jnp.int32),
                             remat=False)
    got, _, _ = lm.forward(params, torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16
    assert _rel(got.to(torch.float32), want) < TOL_BF16


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own decode-vs-forward check (tests/test_models.py:60):
    the last position decoded against the prefill's caches equals the full
    forward's last logits."""
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    params = lm.init(0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)))
    full, _, _ = lm.forward(params, toks)
    _, caches = lm.prefill(params, toks[:, :S - 1], cache_len=S)
    dec, _ = lm.decode_step(params, toks[:, S - 1:], caches, S - 1)
    err = _rel(dec.to(torch.float32), full[:, -1].to(torch.float32))
    assert err < 0.05, err


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_prefill_structure(arch):
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    params = lm.init(0, device="cpu")
    toks = torch.zeros((2, 16), dtype=torch.long)
    _, caches = lm.prefill(params, toks)
    want = lm.init_caches(2, 16, device="cpu")
    for a, b in zip(tree_leaves(caches), tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_init_is_seeded():
    lm = LM(get_config("zamba2-7b").reduced())
    a, b = (tree_leaves(lm.init(7, device="cpu")) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    g = torch.Generator().manual_seed(7)
    c = tree_leaves(lm.init(g, device="cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, c))
    d = tree_leaves(lm.init(8, device="cpu"))
    assert not torch.equal(a[0], d[0])


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b",
                                  "llama-3.2-vision-90b"])
def test_not_ported_families_raise(arch):
    lm = LM(get_config(arch).reduced())
    with pytest.raises(NotImplementedError, match="ROADMAP.md step 13"):
        lm.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md step 13"):
        lm.param_count()
