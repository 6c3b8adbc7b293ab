"""CPU parity of serving on a ("data", "model") mesh (ROADMAP.md step
13.12): ``LM.tp_prefill``, ``LM.tp_decode_step`` and ``Engine(mesh=)``
against the JAX package's ``prefill`` and ``decode_step`` jitted on
sharded inputs, and against the port's unsharded ``Engine``.

Six cases in f32, one per family, B = 4 prompts of 16 tokens, the prefill
and three greedy decode steps, from the JAX model's random weights
(``convert.lm_params_from_arrays``):

* reduced zamba2-7b on (2, 2): Mamba2 heads and the shared block's heads;
* reduced mamba2-2.7b on (1, 2);
* reduced smollm-135m with 6 heads and 2 kv on (1, 4): the axis divides
  neither, so kv heads are regrouped and one is cached on two positions;
* reduced musicgen-medium on (1, 2);
* reduced phi3.5-moe on (2, 2): experts over "model";
* reduced llama-3.2-vision-90b on (1, 4): the cross attention's image
  cache, kv heads regrouped.

The JAX side runs in one subprocess on a forced 8-device host mesh:
``jax.jit(lm.prefill, in_shardings=(param_specs(..., tp="model"),
batch_spec), out_shardings=(..., cache_specs(...)))``, its caches grown to
the decode length by ``serve.engine.pad_caches`` and placed by
``cache_specs`` again, then three ``lm.decode_step`` calls under the same
shardings. Gates: the prefill's and every decode step's logits within
1e-5 of the largest logit (rtol 1e-5) and the greedy tokens equal; the
port's per-position caches, assembled whole
(``sharding.assemble_caches``), equal to the JAX package's gathered caches
within 1e-5 after the prefill and after the last step; against the
port's unsharded ``Engine``, logits within 1e-6 of the largest logit (or
within twice a one-ulp embedding nudge's move, the nudge rule) and the
same tokens; ``Engine.generate``'s collective bytes equal to the dry
run's count by kind (``serve_collectives``), to the byte. Then the cache
layout against the reference's ``cache_specs(..., mode="heads")``, its
assembly, and every LM config on the production mesh's model axis of 16
(the reference's "hd" and "seq" layouts, step 13.13, are
tests/test_torch_serve_tp_layouts.py's).
"""
import dataclasses
import json
import math
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import make_mesh
from repro_torch.launch.dryrun import serve_collectives
from repro_torch.launch.mesh import (
    ModelGroup,
    collective_bytes,
    reset_collective_bytes,
)
from repro_torch.models import LM
from repro_torch.models import sharding as sh
from repro_torch.models.model import (
    check_tensor_parallel,
    tree_leaves,
    tree_map,
)
from repro_torch.serve.engine import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, STEPS = 4, 16, 4  # the prefill's token and three decode steps'
MAX_LEN = P + STEPS
CASES = {
    "zamba2-2x2": ("zamba2-7b", (2, 2), {}),
    "mamba2-1x2": ("mamba2-2.7b", (1, 2), {}),
    "smollm-6h2kv-1x4": ("smollm-135m", (1, 4), {"n_heads": 6, "n_kv": 2}),
    "musicgen-1x2": ("musicgen-medium", (1, 2), {}),
    "phi-moe-2x2": ("phi3.5-moe-42b-a6.6b", (2, 2), {}),
    "vlm-1x4": ("llama-3.2-vision-90b", (1, 4), {}),
}

JAX_RUN = """
import dataclasses, json, pickle, sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.models import LM
from repro.models.sharding import (batch_spec, cache_specs, param_specs,
                                   set_activation_mesh)
from repro.serve.engine import pad_caches
B, S, STEPS = 4, 16, 4
res = {}
for name, (arch, shape, over) in json.loads(sys.argv[2]).items():
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("data", "model"))
    set_activation_mesh(("data",), "model")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **over)
    lm = LM(cfg)
    params = lm.init(jax.random.PRNGKey(0))
    pspecs = param_specs(lm.abstract_params(), ("data",), tp="model")
    bspec = batch_spec(True, ("data",))
    cspecs = cache_specs(lm, ("data",), batch_shardable=True,
                         tp_size=shape[1])
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    img = ((rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)) * 0.1)
           .astype(np.float32) if cfg.family == "vlm" else None)
    imgs = () if img is None else (jnp.asarray(img),)
    img_sp = () if img is None else (P(*bspec, None, None),)

    def ns(tree):
        return jax.tree.map(lambda sp: NamedSharding(mesh, sp), tree,
                            is_leaf=lambda x: isinstance(x, P))

    with mesh:
        prefill = jax.jit(lambda p, t, *i: lm.prefill(p, t, *i),
                          in_shardings=ns((pspecs, bspec) + img_sp),
                          out_shardings=ns((P(*bspec, None), cspecs)))
        step = jax.jit(lambda p, t, c, q, *i: lm.decode_step(p, t, c, q, *i),
                       in_shardings=ns((pspecs, bspec, cspecs, P()) + img_sp),
                       out_shardings=ns((P(*bspec, None), cspecs)))
        ps = jax.device_put(params, ns(pspecs))
        logits, caches = prefill(ps, jnp.asarray(tokens), *imgs)
        caches = jax.device_put(pad_caches(lm, caches, S, S + STEPS),
                                ns(cspecs))
        out = [np.asarray(logits)]
        toks = [np.asarray(jnp.argmax(logits, -1)).astype(np.int32)]
        first = jax.tree.map(np.asarray, caches)
        for i in range(STEPS - 1):
            logits, caches = step(ps, jnp.asarray(toks[-1][:, None]), caches,
                                  jnp.int32(S + i), *imgs)
            out.append(np.asarray(logits))
            toks.append(np.asarray(jnp.argmax(logits, -1)).astype(np.int32))
    res[name] = dict(params=jax.tree.map(np.asarray, params), tokens=tokens,
                     img=img, logits=np.stack(out, 1), toks=np.stack(toks, 1),
                     caches_prefill=first,
                     caches=jax.tree.map(np.asarray, caches))
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
"""


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread while this module runs (the reduced models gain
    nothing from more, and the suite's test processes share the host's
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """Every case's JAX prefill and decode steps on a forced 8-device host
    mesh, with its parameters, prompts and caches, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_serve_tp") / "ref.pkl"
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


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * math.prod(shape))


def _batch_axis(lm) -> list:
    """Each cache leaf's batch axis (where a batch of 2 and of 1 differ)."""
    two = tree_leaves(lm.init_caches(2, 4, device="meta"))
    one = tree_leaves(lm.init_caches(1, 4, device="meta"))
    return [next(d for d, (a, b) in enumerate(zip(t.shape, o.shape))
                 if a != b) for t, o in zip(two, one)]


def _whole(lm, rows_caches: list, tp: int) -> list:
    """The leaves of the whole cache tree from each data row's positions'
    caches (rows in order)."""
    rows = [tree_leaves(sh.assemble_caches(lm, c, tp)) for c in rows_caches]
    return [torch.cat(leaves, dim=ax)
            for leaves, ax in zip(zip(*rows), _batch_axis(lm))]


@pytest.fixture(scope="module", params=list(CASES))
def run(request, jax_ref):
    """One case: the port's mesh engine and unsharded engine (greedy), and
    its rows' ``tp_prefill`` and ``tp_decode_step`` fed the JAX package's
    tokens, with their caches assembled whole."""
    arch, shape, over = CASES[request.param]
    ref = jax_ref[request.param]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **over)
    lm = LM(cfg)
    params = lm_params_from_arrays(cfg, ref["params"], device="cpu")
    tokens = torch.as_tensor(ref["tokens"])
    img = None if ref["img"] is None else torch.as_tensor(ref["img"])
    out = dict(ref=ref, lm=lm, shape=shape)
    plain = Engine(lm, params, MAX_LEN, device="cpu")
    out["plain"] = plain.generate(tokens, STEPS, img, return_logits=True)
    # the unsharded engine with its embedding one f32 ulp up, fed the same
    # tokens: how far the model's own rounding moves the logits
    nudged = dict(params, embed=torch.nextafter(
        params["embed"], torch.full_like(params["embed"], math.inf)))
    out["nudged"] = Engine(lm, nudged, MAX_LEN, device="cpu").generate(
        tokens, STEPS, img, return_logits=True,
        forced=out["plain"][0][:, :-1])[1]
    mesh = _mesh(shape)
    eng = Engine(lm, params, MAX_LEN, mesh=mesh, device="cpu")
    reset_collective_bytes()
    out["tp"] = eng.generate(tokens, STEPS, img, return_logits=True)
    out["colls"] = collective_bytes()
    # each data row's positions, fed the JAX tokens
    n, tp = shape
    rows = B // n
    jtoks = torch.as_tensor(ref["toks"]).long()
    firsts, lasts = [], []
    for d, members in sorted(eng.rows.items()):
        group = ModelGroup(mesh, "model", [p for p, _t in members],
                           count=False)
        parts = [t for _p, t in members]
        sl = slice(d * rows, (d + 1) * rows)
        _, caches = lm.tp_prefill(parts, tokens[sl], group,
                                  None if img is None else img[sl],
                                  cache_len=MAX_LEN)
        firsts.append([tree_map(torch.clone, c) for c in caches])
        for i in range(STEPS - 1):
            lm.tp_decode_step(parts, jtoks[sl, i:i + 1], caches, P + i,
                              group)
        lasts.append(caches)
    out["caches_prefill"] = _whole(lm, firsts, tp)
    out["caches"] = _whole(lm, lasts, tp)
    return out


def _random_caches(lm, batch: int, seq: int, seed: int) -> list:
    """A whole cache tree of normal draws."""
    g = torch.Generator().manual_seed(seed)
    tree = lm.init_caches(batch, seq, device="cpu")
    for t in tree_leaves(tree):
        t.normal_(generator=g)
    return tree


def _np(t):
    return np.asarray(t.detach(), np.float32)


def test_logits_and_tokens_match_jax(run):
    toks, logits = run["tp"]
    want = run["ref"]["logits"]
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(_np(logits), want, rtol=1e-5,
                               atol=1e-5 * scale)
    np.testing.assert_array_equal(toks.numpy(), run["ref"]["toks"])


@pytest.mark.parametrize("when", ["prefill", "last_step"])
def test_caches_assembled_whole_match_jax(run, when):
    got = run["caches_prefill" if when == "prefill" else "caches"]
    want = jax_leaves(run["ref"]["caches_prefill" if when == "prefill"
                                 else "caches"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), b, rtol=1e-5, atol=1e-5)


def jax_leaves(tree) -> list:
    """The leaves of a JAX cache tree of numpy arrays, in the port's
    flattening order (dict keys sorted, as ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in jax_leaves(t)]
    return [np.asarray(tree, np.float32)]


def test_matches_the_unsharded_engine(run):
    """Each step's logits within 1e-6 of the largest logit of the
    unsharded engine's, or within twice what a one-ulp nudge of the
    embedding moves that step's logits on the unsharded engine (the nudge
    rule of tests/test_torch_train_tp_heads.py: reduced zamba2-7b and the
    6-head smollm land at 1.4-1.7e-6 across the split, where the nudge
    moves 0.6-2.0e-6, measured on a CPU host); the same tokens."""
    toks, logits = run["tp"]
    toks0, logits0 = run["plain"]
    scale = float(logits0.abs().max())
    for s in range(STEPS):
        nudge = float((run["nudged"][:, s] - logits0[:, s]).abs().max())
        got = float((logits[:, s] - logits0[:, s]).abs().max())
        assert got <= max(1e-6 * scale, 2 * nudge), (s, got, scale, nudge)
    assert torch.equal(toks, toks0)


def test_collective_bytes_equal_the_dry_run(run):
    """One ``generate``'s operand bytes of a position, by kind: the
    prefill's and each decode step's, as ``serve_collectives`` works them
    out (and as a prefill or decode cell of the dry run records them)."""
    lm, (n, tp) = run["lm"], run["shape"]
    rows = B // n
    want = dict(serve_collectives(lm, tp, rows, P, "prefill"))
    for k, v in serve_collectives(lm, tp, rows, P, "decode").items():
        want[k] = want.get(k, 0) + (STEPS - 1) * v
    assert run["colls"] == want
    assert want["reduce-out"] and want["gather-out"]
    regrouped = (lm.cfg.n_kv and lm.cfg.n_kv % tp) or lm.cfg.ssm_state
    assert ("regroup" in want) == bool(regrouped)


# --------------------------------------------------------------------------
# the cache layout
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", [
    ("zamba2-7b", (2, 2)), ("phi3.5-moe-42b-a6.6b", (2, 2)),
    ("llama-3.2-vision-90b", (1, 2))])
def test_cache_slice_is_the_reference_heads_slice(arch, shape):
    """Where the axis divides ``n_kv``, a position's attention caches are
    its slice by ``cache_specs(..., mode="heads")`` (its data rows and kv
    heads) byte for byte, as are its Mamba2 states; a vlm's image cache,
    which the reference keeps whole on the model axis, is its kv heads
    here."""
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    n, tp = shape
    mesh = _mesh(shape)
    tree = _random_caches(lm, 4, 8, 0)
    whole = tree_leaves(tree)
    specs = sh.spec_leaves(tree, sh.cache_specs(lm, tp_size=tp,
                                                mode="heads"))
    tags = tree_leaves(sh._cache_tags(lm))
    for p in range(n * tp):
        d, j = mesh.coords(p)
        mine = tree_leaves(sh.cache_slice(lm, tree, tp, j))
        for t, spec, tag, got, ax in zip(whole, specs, tags, mine,
                                         _batch_axis(lm)):
            rows = slice(d * 4 // n, (d + 1) * 4 // n)
            got = got.narrow(ax, rows.start, rows.stop - rows.start)
            ref = t[sh.slices_of(t.shape, spec, mesh, p)]
            if tag == "conv":  # x of its heads, B and C whole
                assert got.shape[-1] == (cfg.ssm_expand * cfg.d_model // tp
                                         + 2 * cfg.ssm_state)
                continue
            if spec[-2] is None and tag == "kv":  # the image cache
                ref = ref[..., j * cfg.n_kv // tp:(j + 1) * cfg.n_kv // tp,
                          :]
            assert torch.equal(got, ref), (p, tag, spec)


@pytest.mark.parametrize("heads,kv,tp", [(6, 2, 4), (4, 2, 8), (9, 3, 4),
                                         (4, 2, 2)])
def test_assembled_slices_give_the_whole_tree(heads, kv, tp):
    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(),
                              n_heads=heads, n_kv=kv)
    lm = LM(cfg)
    tree = _random_caches(lm, 2, 8, 1)
    slices = [sh.cache_slice(lm, tree, tp, j) for j in range(tp)]
    for j, s in enumerate(slices):  # init_caches(tp=, j=) allocates these
        alloc = lm.init_caches(2, 8, device="meta", tp=tp, j=j)
        assert [t.shape for t in tree_leaves(s)] == \
            [t.shape for t in tree_leaves(alloc)]
    for a, b in zip(tree_leaves(sh.assemble_caches(lm, slices, tp)),
                    tree_leaves(tree)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_on_a_model_axis_of_16(arch):
    """Each LM config on the production mesh's model axis: accepted by
    ``check_tensor_parallel``, its caches split into 16 positions' slices
    that assemble back whole (on meta), and a decode step's model-axis
    bytes counted, in the port's "heads" layout and in the reference's
    ``auto`` pick (``cache_specs(mode="auto")``, "hd" or "seq" where 16
    does not divide the kv heads: their all-to-alls and all-reduces); or
    refused, naming the rule."""
    cfg = get_config(arch)
    lm = LM(cfg)
    try:
        check_tensor_parallel(cfg, 16)
    except NotImplementedError as e:
        assert "does not divide" in str(e)
        return
    whole = lm.init_caches(2, 64, device="meta")
    for mode in ("heads", "auto"):
        slices = [sh.cache_slice(lm, whole, 16, j, mode) for j in range(16)]
        back = sh.assemble_caches(lm, slices, 16, mode)
        assert [t.shape for t in tree_leaves(back)] == \
            [t.shape for t in tree_leaves(whole)]
        colls = serve_collectives(lm, 16, 1, 64, "decode", mode)
        assert colls["reduce-out"] > 0 and colls["gather-out"] > 0
        split = (cfg.n_kv and sh.resolve_cache_mode(cfg, 16, mode)
                 != "heads")
        assert bool(colls.get("all-to-all")) == bool(split)
        assert bool(colls.get("all-reduce")) == bool(split)
