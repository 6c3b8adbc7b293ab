"""CPU parity of the port's LM stack with the JAX package's, for the
dense (smollm-135m), ssm (mamba2-2.7b), hybrid (zamba2-7b), moe
(phi3.5-moe-42b-a6.6b: top-2 ``moe`` blocks; llama4-maverick-400b-a17b:
top-1 interleaved ``moe_pair`` blocks) and vlm (llama-3.2-vision-90b:
``vlm_super`` blocks with cross attention over image embeddings)
families at the reduced configs.

The JAX model draws its weights; they cross to the port through
``convert.lm_params_from_arrays``, and the same numpy tokens go to both.
In f32 the logits and caches agree within 1e-4 of their largest value.
In bf16 the bound is 3e-2: the JAX model rounds the probabilities to bf16
before P V (repro/models/attention.py:56-58) while K4 and its plain
version keep them in f32 (repro/kernels/flash.py:56-61). The JAX results
are computed once per family (module-scoped fixtures). The vlm's image
embeddings are seeded numpy normals times 0.1 (tests/test_models.py:19),
and its prompt (24) is not ``n_img_tokens`` (8) long: the JAX engine's
``pad_caches`` would pad the image cache too at that length (ROADMAP.md
§3). The reduced moe configs never drop a token (capacity factor 4), so
their routes decide nothing near a tie there; ``tests/test_torch_moe.py``
holds the routes, drops and positions.
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

ARCHS = ["smollm-135m", "mamba2-2.7b", "zamba2-7b", "phi3.5-moe-42b-a6.6b",
         "llama4-maverick-400b-a17b", "llama-3.2-vision-90b"]
B, S, PROMPT, STEPS, MAX_LEN = 2, 32, 24, 6, 32
TOL_F32, TOL_BF16, GAP_TOL = 1e-4, 3e-2, 1e-4


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _np(a):
    return np.asarray(a, np.float32)


def _img(cfg, seed=3, batch=B):
    """Seeded image embeddings (batch, n_img, d) as float32 numpy, or None
    for a family without images."""
    if cfg.family != "vlm":
        return None
    return 0.1 * np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_img_tokens, cfg.d_model), dtype=np.float32)


def _jimg(img, dtype):
    return None if img is None else jnp.asarray(img, dtype)


def _timg(img, dtype):
    return None if img is None else torch.as_tensor(img).to(dtype)


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
    img = _img(cfg)
    jt, ji = jnp.asarray(toks, jnp.int32), _jimg(img, jnp.float32)
    logits, aux, _ = jlm.forward(jparams, jt, ji, remat=False)
    pre_logits, pre_caches = jlm.prefill(jparams, jt[:, :PROMPT], ji)
    padded = jax_pad_caches(jlm, pre_caches, PROMPT, MAX_LEN)
    dec_logits, dec_caches = jlm.decode_step(
        jparams, jt[:, PROMPT:PROMPT + 1], padded, jnp.int32(PROMPT), ji)
    eng = JEngine(jlm, jparams, MAX_LEN)
    gen = eng.generate(jt[:, :PROMPT], STEPS, ji)
    # the logits each generated token was picked from, by the engine's own
    # jitted steps
    lg, caches = eng._prefill(jparams, jt[:, :PROMPT], ji)
    caches = jax_pad_caches(jlm, caches, PROMPT, MAX_LEN)
    step_logits = [lg]
    for i in range(STEPS - 1):
        lg, caches = eng._decode(jparams, gen[:, i:i + 1], caches,
                                 jnp.int32(PROMPT + i), ji)
        step_logits.append(lg)
    return dict(
        arch=arch, jlm=jlm, jparams=jparams, lm=lm, cfg=cfg, params=params,
        toks=toks, img=_timg(img, torch.float32), aux=float(aux),
        logits=_np(logits), pre_logits=_np(pre_logits),
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
    jlm, lm = JLM(jax_get_config(arch)), LM(get_config(arch))
    want = jlm.param_count()
    assert lm.param_count() == want
    assert lm.active_param_count() == jlm.active_param_count()
    if arch == "zamba2-7b":
        assert want == 6_751_130_832


def test_reduced_param_counts_match_jax(run):
    """``param_count`` and ``active_param_count`` (MoE: the experts a
    token does not route to left out) of the reduced config as JAX's."""
    assert run["lm"].param_count() == run["jlm"].param_count()
    assert run["lm"].active_param_count() == run["jlm"].active_param_count()
    if run["cfg"].n_experts:
        assert run["lm"].active_param_count() < run["lm"].param_count()


def test_forward_logits_match_jax(run):
    got, aux, caches = run["lm"].forward(run["params"],
                                         torch.as_tensor(run["toks"]),
                                         run["img"])
    assert caches is None and aux.dtype == torch.float32
    # the MoE blocks' load-balancing sum; 0 for a family without experts
    np.testing.assert_allclose(float(aux), run["aux"], rtol=1e-5, atol=0)
    assert (float(aux) > 0) == (run["cfg"].family == "moe")
    assert got.shape == (B, S, run["cfg"].vocab_padded)
    assert _rel(got, run["logits"]) < TOL_F32


def test_prefill_logits_and_caches_match_jax(run):
    logits, caches = run["lm"].prefill(
        run["params"], torch.as_tensor(run["toks"][:, :PROMPT]), run["img"])
    assert _rel(logits, run["pre_logits"]) < TOL_F32
    got = tree_leaves(caches)
    assert len(got) == len(run["pre_caches"])
    for a, b in zip(got, run["pre_caches"]):
        assert tuple(a.shape) == b.shape
        assert _rel(a, b) < TOL_F32


def test_decode_step_matches_jax(run):
    lm, params = run["lm"], run["params"]
    toks = torch.as_tensor(run["toks"])
    _, caches = lm.prefill(params, toks[:, :PROMPT], run["img"],
                           cache_len=MAX_LEN)
    logits, caches = lm.decode_step(params, toks[:, PROMPT:PROMPT + 1],
                                    caches, PROMPT)
    assert _rel(logits, run["dec_logits"]) < TOL_F32
    for a, b in zip(tree_leaves(caches), run["dec_caches"]):
        assert tuple(a.shape) == b.shape
        assert _rel(a, b) < TOL_F32


def test_pad_caches_matches_prefill_at_full_length(run):
    lm, params = run["lm"], run["params"]
    toks = torch.as_tensor(run["toks"][:, :PROMPT])
    _, short = lm.prefill(params, toks, run["img"])
    _, full = lm.prefill(params, toks, run["img"], cache_len=MAX_LEN)
    grown = pad_caches(lm, short, PROMPT, MAX_LEN)
    for a, b in zip(tree_leaves(grown), tree_leaves(full)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "llama-3.2-vision-90b"])
def test_pad_caches_grows_self_attention_only(arch):
    """``pad_caches`` on a ``moe_pair`` tree ({"dense", "moe"}) grows both
    self-attention caches; on a ``vlm_super`` tree it grows the self-
    attention caches and leaves the image cache at ``n_img_tokens``, also
    when the prompt is ``n_img_tokens`` long (where the reference's shape
    heuristic pads the image cache too)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    lm = LM(cfg)
    params = lm.init(0, device="cpu")
    img = _timg(_img(cfg), torch.float32)
    n = cfg.n_img_tokens if img is not None else 6
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, n)))
    _, short = lm.prefill(params, toks, img)
    grown = pad_caches(lm, short, n, MAX_LEN)
    (kind, count), = lm.plan
    if kind == "moe_pair":
        assert sorted(grown[0]) == ["dense", "moe"]
        for part in ("dense", "moe"):
            for a, b in zip(grown[0][part], short[0][part]):
                assert a.shape == (count, B, MAX_LEN, cfg.n_kv, cfg.hd)
                assert torch.equal(a[:, :, :n], b)
                assert not bool(a[:, :, n:].any())
    else:
        assert sorted(grown[0]) == ["cross", "dense"]
        for a, b in zip(grown[0]["cross"], short[0]["cross"]):
            assert a is b
            assert a.shape == (count, B, cfg.n_img_tokens, cfg.n_kv, cfg.hd)
        for a in grown[0]["dense"]:
            assert a.shape == (count, cfg.cross_attn_every - 1, B, MAX_LEN,
                               cfg.n_kv, cfg.hd)
    # decoding from the grown caches equals decoding from caches the
    # prefill made at full length
    _, full = lm.prefill(params, toks, img, cache_len=MAX_LEN)
    nxt = toks[:, -1:]
    a, _ = lm.decode_step(params, nxt, grown, n)
    b, _ = lm.decode_step(params, nxt, full, n)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_engine_generates_the_jax_tokens(run):
    """Greedy tokens equal the JAX engine's at every step, unless the JAX
    top-2 gap at the first differing step is under GAP_TOL relative (a
    near-tie that rounding may flip); the comparison stops there."""
    eng = Engine(run["lm"], run["params"], MAX_LEN, device="cpu")
    toks, logits = eng.generate(run["toks"][:, :PROMPT], STEPS, run["img"],
                                return_logits=True)
    assert toks.shape == (B, STEPS) and toks.dtype == torch.int32
    assert torch.equal(toks, eng.generate(run["toks"][:, :PROMPT], STEPS,
                                          run["img"]))
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


def _replay_jax_routes(monkeypatch):
    """Record the JAX model's top-k experts of every MoE layer (a
    ``jax.debug.callback`` beside its ``moe_apply``; the JAX package is
    not changed), and replay them in the port's ``moe_route``, in layer
    order. Returns the list of (JAX experts, port experts, port probs)
    each port layer saw."""
    import repro.models.model as jmodel
    from repro_torch.models import moe

    jax_routes, seen = [], []
    jax_moe, port_route = jmodel.moe_apply, moe.moe_route

    def spy(x, p, *, top_k, capacity_factor):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
        _, eidx = jax.lax.top_k(probs, top_k)
        jax.debug.callback(lambda e: jax_routes.append(np.array(e)), eidx,
                           ordered=True)
        return jax_moe(x, p, top_k=top_k, capacity_factor=capacity_factor)

    def replay(x, router, **kw):
        own = port_route(x, router, **kw)
        want = torch.as_tensor(jax_routes[len(seen)])
        seen.append((want, own.eidx, own.probs))
        return port_route(x, router, eidx=want, **kw)

    monkeypatch.setattr(jmodel, "moe_apply", spy)
    monkeypatch.setattr(moe, "moe_route", replay)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_jax(arch, monkeypatch):
    """bf16 logits within TOL_BF16 of the JAX model's. In a MoE model a
    near-tie of the router may go the other way in the two models (their
    attention rounds differently, this file's header): the port then
    replays the JAX model's routes, the flips are reported, and each must
    be a near-tie of the port's own probabilities (the flipped expert's
    probability within TOL_BF16 of the largest one of the row).

    The vlm runs two attentions a super block's layer (self and cross),
    and the header's known difference (JAX rounds P to bf16 before P V,
    the port keeps it in f32) adds up to TOL_BF16 there: for it alone,
    where the direct comparison fails, that cause is taken out and the
    direct rule applied again (the port with P rounded as JAX rounds it,
    ``blockwise_attention_ref`` on a bf16 v, within TOL_BF16 of JAX),
    and the port's own logits must be within TOL_BF16 of the f32 logits
    of the same weights and no farther from them than JAX's bf16 are."""
    seen = _replay_jax_routes(monkeypatch)
    jcfg, cfg = _cfgs(arch, "bfloat16")
    jlm, lm = JLM(jcfg), LM(cfg)
    jparams = jlm.init(jax.random.PRNGKey(2))
    params = lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                   device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, S))
    img = _img(cfg)
    want, _, _ = jlm.forward(jparams, jnp.asarray(toks, jnp.int32),
                             _jimg(img, jnp.bfloat16), remat=False)
    got, _, _ = lm.forward(params, torch.as_tensor(toks),
                           _timg(img, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = _rel(got.to(torch.float32), want)
    if cfg.family != "vlm" or err < TOL_BF16:
        assert err < TOL_BF16, err
    else:
        import repro_torch.models.model as model
        from repro_torch.models.common import blockwise_attention_ref

        monkeypatch.setattr(
            model, "blockwise_attention",
            lambda q, k, v, *, causal, force=None:
            blockwise_attention_ref(q, k, v, causal=causal))
        got_p, _, _ = lm.forward(params, torch.as_tensor(toks),
                                 _timg(img, torch.bfloat16))
        monkeypatch.undo()
        err_p = _rel(got_p.to(torch.float32), want)
        assert err_p < TOL_BF16, (err, err_p)
        jlm32 = JLM(dataclasses.replace(jcfg, dtype="float32"))
        truth, _, _ = jlm32.forward(
            jax.tree.map(lambda a: a.astype(jnp.float32), jparams),
            jnp.asarray(toks, jnp.int32),  # the bf16 image, upcast
            None if img is None
            else jnp.asarray(img, jnp.bfloat16).astype(jnp.float32),
            remat=False)
        mine, theirs = _rel(got.to(torch.float32), truth), _rel(want, truth)
        print(f"{arch}: bf16 logits {err:.4f} from JAX's, {err_p:.4f} with "
              f"P rounded as JAX rounds it; from f32 {mine:.4f} (port) and "
              f"{theirs:.4f} (JAX)")
        assert mine < TOL_BF16 and mine <= theirs, (err, mine, theirs)
    moe_layers = cfg.n_layers // cfg.moe_every if cfg.n_experts else 0
    assert len(seen) == moe_layers
    flips = 0
    for layer, (want_e, own_e, probs) in enumerate(seen):
        for b, s_ in (want_e != own_e).any(-1).nonzero().tolist():
            flips += 1
            pr = probs[b, s_]
            gap = float(pr[own_e[b, s_]].min() - pr[want_e[b, s_]].min())
            assert gap <= TOL_BF16 * float(pr.max()), (layer, b, s_, gap)
    if flips:
        print(f"{arch}: {flips} of {moe_layers * B * S} (layer, token) routes "
              f"flipped at a near-tie; the JAX routes were replayed")


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
    img = _timg(_img(cfg), lm.dtype)
    full, _, _ = lm.forward(params, toks, img)
    _, caches = lm.prefill(params, toks[:, :S - 1], img, cache_len=S)
    dec, _ = lm.decode_step(params, toks[:, S - 1:], caches, S - 1)
    err = _rel(dec.to(torch.float32), full[:, -1].to(torch.float32))
    assert err < 0.05, err


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_prefill_structure(arch):
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    params = lm.init(0, device="cpu")
    toks = torch.zeros((2, 16), dtype=torch.long)
    _, caches = lm.prefill(params, toks, _timg(_img(cfg, batch=2), lm.dtype))
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


def test_vlm_forward_needs_an_image():
    """A vlm forward without ``img`` raises a ValueError that names it (the
    reference fails inside its cross attention)."""
    lm = LM(get_config("llama-3.2-vision-90b").reduced())
    params = lm.init(0, device="cpu")
    toks = torch.zeros((2, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="img"):
        lm.forward(params, toks)
    with pytest.raises(ValueError, match="img"):
        lm.loss(params, toks)
    with pytest.raises(ValueError, match="img"):
        Engine(lm, params, 16, device="cpu").generate(toks, 2)


@pytest.mark.parametrize("n_img", [3, 9])
def test_vlm_image_of_another_length_raises(n_img):
    """The image cache holds ``n_img_tokens`` keys, so an image of any
    other length is refused before it reaches a cache: a shorter one
    would leave zero keys for the decode steps to attend to."""
    cfg = get_config("llama-3.2-vision-90b").reduced()
    lm = LM(cfg)
    params = lm.init(0, device="cpu")
    toks = torch.zeros((2, 8), dtype=torch.long)
    img = torch.zeros((2, n_img, cfg.d_model))
    assert n_img != cfg.n_img_tokens
    with pytest.raises(ValueError, match="img of shape"):
        lm.forward(params, toks, img)
    with pytest.raises(ValueError, match="img of shape"):
        lm.prefill(params, toks, img, cache_len=16)
    with pytest.raises(ValueError, match="img of shape"):
        Engine(lm, params, 16, device="cpu").generate(toks, 2, img)


@pytest.mark.parametrize("sq,skv,H,KV,causal,q_offset,blocks", [
    (24, 24, 4, 2, True, 0, (8, 16)),     # GQA, padding, causal
    (24, 40, 4, 4, False, 0, (16, 16)),   # Sq != Skv, kv padded
    (9, 40, 8, 2, False, 0, (4, 32)),     # cross attention's shape
    (16, 40, 4, 1, True, 24, (8, 16)),    # queries at the end of kv
])
def test_blockwise_attention_ref_matches_jax(sq, skv, H, KV, causal,
                                             q_offset, blocks):
    """The plain online-softmax oracle against the JAX package's, f32, and
    its gradients (autograd against ``jax.vjp``); and against the model's
    attention on the plain path of K4."""
    from repro.models.common import blockwise_attention_ref as jax_ref
    from repro_torch.models.common import (
        blockwise_attention, blockwise_attention_ref)

    rng = np.random.default_rng(sq * 100 + skv)
    hd = 16
    q, k, v = (rng.standard_normal((2, s, h, hd), dtype=np.float32)
               for s, h in ((sq, H), (skv, KV), (skv, KV)))
    do = rng.standard_normal((2, sq, H, hd), dtype=np.float32)
    kw = dict(causal=causal, q_offset=q_offset, q_block=blocks[0],
              kv_block=blocks[1])
    want, vjp = jax.vjp(lambda a, b, c: jax_ref(a, b, c, **kw),
                        *(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.as_tensor(t).requires_grad_(True) for t in (q, k, v))
    got = blockwise_attention_ref(tq, tk, tv, **kw)
    assert got.shape == (2, sq, H, hd) and got.dtype == torch.float32
    assert _rel(got.detach(), want) < TOL_F32
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.as_tensor(do))
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        assert _rel(g, w) < TOL_F32
    if q_offset == 0 and (not causal or sq == skv):
        plain = blockwise_attention(*(torch.as_tensor(t) for t in (q, k, v)),
                                    causal=causal, force="ref")
        assert _rel(plain, want) < TOL_F32
