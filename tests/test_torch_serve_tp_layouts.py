"""CPU parity of serving on a ("data", "model") mesh in the reference's
"hd" and "seq" kv cache layouts (ROADMAP.md step 13.13): ``LM.tp_prefill``,
``LM.tp_decode_step`` and ``Engine(mesh=, cache_mode=)`` against the JAX
package's ``prefill`` and ``decode_step`` jitted with their caches laid
out by ``cache_specs(..., mode=)``, and against the port's unsharded
``Engine``.

Five cases in f32, B = 4 prompts of 16 tokens, the prefill and three
greedy decode steps, from the JAX model's random weights
(``convert.lm_params_from_arrays``):

* reduced smollm-135m with 9 heads and 3 kv heads on (1, 4) under "auto",
  which picks "hd" (4 divides neither the heads nor the kv heads);
* the same under "seq";
* reduced zamba2-7b on (2, 2) under "hd": the shared attention block's
  caches beside the Mamba2 states, which keep their heads;
* reduced phi3.5-moe on (2, 2) under "seq": experts over "model";
* reduced llama-3.2-vision-90b on (1, 4) under "hd": the image cache
  keeps its kv heads.

The cache holds ``tp x (16 + 1)`` slots, so that under "seq" the first
decode step writes slot 16, the last of position 0's, and the second
slot 17, the first of position 1's (a write that crosses a slot
boundary), while at the first step every position but the first holds
no valid slot (its local max is ``NEG_INF``). The JAX side runs in one
subprocess on a forced 8-device host mesh, as
``tests/test_torch_serve_tp.py``'s, its prefill's caches grown by
``serve.engine.pad_caches`` and placed by ``cache_specs(..., mode=)``.
Gates as that file's: logits within 1e-5 of the largest logit and the
greedy tokens equal; the port's per-position caches, assembled whole
(``sharding.assemble_caches(..., mode)``), equal to the JAX package's
within 1e-5 after the prefill and after the last step; against the
unsharded ``Engine``, 1e-6 of the largest logit or the nudge rule, the
same tokens; ``Engine.generate``'s collective bytes equal to
``serve_collectives(..., mode)`` by kind, to the byte. Then the layouts
against the reference's ``cache_specs(mode=)`` model slices, their
assembly, the refusal of an axis that does not divide the head dim or
the cache length, which the reference refuses too, and four gloo ranks
against the in-process mesh bit for bit.
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

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.convert import lm_params_from_arrays
from repro_torch.launch import make_mesh
from repro_torch.launch.dryrun import count_cell, meta_mesh, serve_collectives
from repro_torch.launch.mesh import (
    ModelGroup,
    collective_bytes,
    reset_collective_bytes,
)
from repro_torch.models import LM
from repro_torch.models import sharding as sh
from repro_torch.models.model import kv_range, tree_leaves, tree_map
from repro_torch.serve.engine import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, STEPS = 4, 16, 4  # the prefill's token and three decode steps'
SMOLLM_9H = {"n_heads": 9, "n_kv": 3}
CASES = {
    "smollm-9h3kv-1x4-auto": ("smollm-135m", (1, 4), SMOLLM_9H, "auto"),
    "smollm-9h3kv-1x4-seq": ("smollm-135m", (1, 4), SMOLLM_9H, "seq"),
    "zamba2-2x2-hd": ("zamba2-7b", (2, 2), {}, "hd"),
    "phi-moe-2x2-seq": ("phi3.5-moe-42b-a6.6b", (2, 2), {}, "seq"),
    "vlm-1x4-hd": ("llama-3.2-vision-90b", (1, 4), {}, "hd"),
}
# axes that the reference's cache_specs(mode=) cannot split: (arch, tp,
# mode, config overrides, cache length)
REFUSED = {
    "hd": ("smollm-135m", 4, "hd", {"head_dim": 6}, 16),
    "seq": ("smollm-135m", 4, "seq", {}, 18),
}


def cache_len(tp: int) -> int:
    return tp * (P + 1)


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
cases, refused = json.loads(sys.argv[2]), json.loads(sys.argv[3])
res = {}
for name, (arch, shape, over, mode) in cases.items():
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("data", "model"))
    set_activation_mesh(("data",), "model")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **over)
    lm = LM(cfg)
    L = shape[1] * (S + 1)
    params = lm.init(jax.random.PRNGKey(0))
    pspecs = param_specs(lm.abstract_params(), ("data",), tp="model")
    bspec = batch_spec(True, ("data",))
    cspecs = cache_specs(lm, ("data",), batch_shardable=True, mode=mode,
                         tp_size=shape[1])
    rng = np.random.default_rng(11)
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
        caches = jax.device_put(pad_caches(lm, caches, S, L), ns(cspecs))
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
# the reference's refusals: its caches placed by cache_specs(mode=) on an
# axis that does not divide the split dim
res["refused"] = {}
for name, (arch, tp, mode, over, length) in refused.items():
    mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("data", "model"))
    lm = LM(dataclasses.replace(get_config(arch).reduced(), **over))
    caches = lm.init_caches(1, length)
    specs = cache_specs(lm, ("data",), batch_shardable=False, mode=mode,
                        tp_size=tp)
    try:
        jax.device_put(caches, jax.tree.map(
            lambda sp: NamedSharding(mesh, sp), specs,
            is_leaf=lambda x: isinstance(x, P)))
        res["refused"][name] = None
    except ValueError as e:
        res["refused"][name] = str(e)
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
    mesh, with its parameters, prompts and caches, and the reference's
    refusals, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_serve_tp_layouts") / "ref.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_RUN),
                        str(out), json.dumps(CASES), json.dumps(REFUSED)],
                       capture_output=True, text=True, env=env, timeout=900)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * math.prod(shape))


def _cfg(arch, over, dtype="float32"):
    return dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                               **over)


def _batch_axis(lm) -> list:
    """Each cache leaf's batch axis (where a batch of 2 and of 1 differ)."""
    two = tree_leaves(lm.init_caches(2, 4, device="meta"))
    one = tree_leaves(lm.init_caches(1, 4, device="meta"))
    return [next(d for d, (a, b) in enumerate(zip(t.shape, o.shape))
                 if a != b) for t, o in zip(two, one)]


def _whole(lm, rows_caches: list, tp: int, mode: str) -> list:
    """The leaves of the whole cache tree from each data row's positions'
    caches (rows in order)."""
    rows = [tree_leaves(sh.assemble_caches(lm, c, tp, mode))
            for c in rows_caches]
    return [torch.cat(leaves, dim=ax)
            for leaves, ax in zip(zip(*rows), _batch_axis(lm))]


@pytest.fixture(scope="module", params=list(CASES))
def run(request, jax_ref):
    """One case: the port's mesh engine in its layout and the unsharded
    engine (greedy), and its rows' ``tp_prefill`` and ``tp_decode_step``
    fed the JAX package's tokens, with their caches assembled whole."""
    arch, shape, over, mode = CASES[request.param]
    ref = jax_ref[request.param]
    cfg = _cfg(arch, over)
    lm = LM(cfg)
    n, tp = shape
    L = cache_len(tp)
    params = lm_params_from_arrays(cfg, ref["params"], device="cpu")
    tokens = torch.as_tensor(ref["tokens"])
    img = None if ref["img"] is None else torch.as_tensor(ref["img"])
    out = dict(ref=ref, lm=lm, shape=shape, mode=mode,
               layout=sh.resolve_cache_mode(cfg, tp, mode))
    plain = Engine(lm, params, L, device="cpu")
    out["plain"] = plain.generate(tokens, STEPS, img, return_logits=True)
    # the unsharded engine with its embedding one f32 ulp up, fed the same
    # tokens: how far the model's own rounding moves the logits
    nudged = dict(params, embed=torch.nextafter(
        params["embed"], torch.full_like(params["embed"], math.inf)))
    out["nudged"] = Engine(lm, nudged, L, device="cpu").generate(
        tokens, STEPS, img, return_logits=True,
        forced=out["plain"][0][:, :-1])[1]
    mesh = _mesh(shape)
    eng = Engine(lm, params, L, mesh=mesh, device="cpu", cache_mode=mode)
    reset_collective_bytes()
    out["tp"] = eng.generate(tokens, STEPS, img, return_logits=True)
    out["colls"] = collective_bytes()
    # each data row's positions, fed the JAX tokens
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
                                  cache_len=L, cache_mode=mode)
        assert caches.mode == out["layout"]
        firsts.append([tree_map(torch.clone, c) for c in caches])
        for i in range(STEPS - 1):
            lm.tp_decode_step(parts, jtoks[sl, i:i + 1], caches, P + i,
                              group)
        lasts.append(caches)
    out["caches_prefill"] = _whole(lm, firsts, tp, mode)
    out["caches"] = _whole(lm, lasts, tp, mode)
    return out


def _np(t):
    return np.asarray(t.detach(), np.float32)


def jax_leaves(tree) -> list:
    """The leaves of a JAX cache tree of numpy arrays, in the port's
    flattening order (dict keys sorted, as ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in jax_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in jax_leaves(t)]
    return [np.asarray(tree, np.float32)]


def test_the_case_is_its_layout(run):
    """"auto" on (1, 4) with 3 kv heads is the reference's "hd"; the
    others are the layouts they name."""
    mode = run["mode"]
    assert run["layout"] == ("hd" if mode == "auto" else mode)


def test_seq_writes_cross_a_slot_boundary():
    """The lengths the cases use: under "seq" the decode writes land on
    two positions, and at the first decode step the positions past the
    first hold no valid slot."""
    for _arch, (_n, tp), _over, _mode in CASES.values():
        per = cache_len(tp) // tp
        owners = {(P + i) // per for i in range(STEPS - 1)}
        assert owners == {0, 1}
        assert all(j * per > P for j in range(1, tp))


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


def test_matches_the_unsharded_engine(run):
    """Each step's logits within 1e-6 of the largest logit of the
    unsharded engine's, or within twice what a one-ulp nudge of the
    embedding moves that step's logits on the unsharded engine (the nudge
    rule of tests/test_torch_serve_tp.py); the same tokens."""
    toks, logits = run["tp"]
    toks0, logits0 = run["plain"]
    scale = float(logits0.abs().max())
    for s in range(STEPS):
        nudge = float((run["nudged"][:, s] - logits0[:, s]).abs().max())
        got = float((logits[:, s] - logits0[:, s]).abs().max())
        assert got <= max(1e-6 * scale, 2 * nudge), (s, got, scale, nudge)
    assert torch.equal(toks, toks0)


def test_collective_bytes_equal_the_dry_run(run):
    """One ``generate``'s operand bytes of a position, by kind, as
    ``serve_collectives(..., mode)`` works them out: the all-to-alls and
    all-reduces of the layout beside the heads layout's kinds."""
    lm, (n, tp), mode = run["lm"], run["shape"], run["mode"]
    rows, L = B // n, cache_len(tp)
    want = dict(serve_collectives(lm, tp, rows, P, "prefill", mode, L))
    for k, v in serve_collectives(lm, tp, rows, P, "decode", mode,
                                  L).items():
        want[k] = want.get(k, 0) + (STEPS - 1) * v
    assert run["colls"] == want
    assert want["all-to-all"] and want["all-reduce"]
    assert ("max" in want) == (run["layout"] == "seq")


# --------------------------------------------------------------------------
# the layouts
# --------------------------------------------------------------------------


def _random_caches(lm, batch: int, seq: int, seed: int) -> list:
    """A whole cache tree of normal draws."""
    g = torch.Generator().manual_seed(seed)
    tree = lm.init_caches(batch, seq, device="cpu")
    for t in tree_leaves(tree):
        t.normal_(generator=g)
    return tree


@pytest.mark.parametrize("mode", ["hd", "seq"])
@pytest.mark.parametrize("arch,shape", [
    ("zamba2-7b", (2, 2)), ("phi3.5-moe-42b-a6.6b", (2, 2)),
    ("llama-3.2-vision-90b", (1, 4))])
def test_cache_slice_is_the_reference_model_slice(arch, shape, mode):
    """A position's self-attention caches are its slice by
    ``cache_specs(..., mode=)`` (its data rows and its head-dim columns or
    sequence slots) byte for byte, as are its Mamba2 states; a vlm's image
    cache, which the reference keeps whole on the model axis, is its kv
    heads here, as in the "heads" layout."""
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    n, tp = shape
    mesh = _mesh(shape)
    tree = _random_caches(lm, 4, 8, 0)
    whole = tree_leaves(tree)
    specs = sh.spec_leaves(tree, sh.cache_specs(lm, tp_size=tp, mode=mode))
    tags = tree_leaves(sh._cache_tags(lm, cross=True))
    for p in range(n * tp):
        d, j = mesh.coords(p)
        mine = tree_leaves(sh.cache_slice(lm, tree, tp, j, mode))
        for t, spec, tag, got, ax in zip(whole, specs, tags, mine,
                                         _batch_axis(lm)):
            rows = slice(d * 4 // n, (d + 1) * 4 // n)
            got = got.narrow(ax, rows.start, rows.stop - rows.start)
            ref = t[sh.slices_of(t.shape, spec, mesh, p)]
            if tag == "conv":  # x of its heads, B and C whole
                continue
            if tag == "img":
                g0, g1 = kv_range(cfg.n_heads, cfg.n_kv, tp, j)
                ref = ref[..., g0:g1, :]
            assert torch.equal(got, ref), (p, tag, spec)


@pytest.mark.parametrize("mode", ["hd", "seq", "auto"])
@pytest.mark.parametrize("arch,heads,kv,tp", [
    ("zamba2-7b", 6, 2, 4), ("zamba2-7b", 4, 2, 8),
    ("llama-3.2-vision-90b", 9, 3, 4), ("phi3.5-moe-42b-a6.6b", 4, 2, 2)])
def test_assembled_slices_give_the_whole_tree(arch, heads, kv, tp, mode):
    """``cache_slice`` in every layout, assembled, is the whole tree, and
    ``init_caches(tp=, j=, mode=)`` allocates its shapes."""
    lm = LM(dataclasses.replace(get_config(arch).reduced(), n_heads=heads,
                                n_kv=kv))
    tree = _random_caches(lm, 2, 8, 1)
    slices = [sh.cache_slice(lm, tree, tp, j, mode) for j in range(tp)]
    for j, s in enumerate(slices):
        alloc = lm.init_caches(2, 8, device="meta", tp=tp, j=j, mode=mode)
        assert [t.shape for t in tree_leaves(s)] == \
            [t.shape for t in tree_leaves(alloc)]
    for a, b in zip(tree_leaves(sh.assemble_caches(lm, slices, tp, mode)),
                    tree_leaves(tree)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(REFUSED))
def test_an_axis_that_does_not_divide_is_refused(name, jax_ref):
    """"hd" on an axis that does not divide the head dim, "seq" on one
    that does not divide the cache length: the reference's placement by
    ``cache_specs(mode=)`` raises ``ValueError``, and so do the port's
    ``cache_slice``, ``init_caches``, ``tp_prefill``, ``Engine`` and the
    dry run's count, naming the rule; the dry run's decode cell gives no
    collectives and no memory figures, with the rule as the reason."""
    arch, tp, mode, over, length = REFUSED[name]
    assert jax_ref["refused"][name] is not None
    cfg = _cfg(arch, over)
    lm = LM(cfg)
    rule = "head dim" if mode == "hd" else "cache length"
    whole = lm.init_caches(1, length, device="meta")
    with pytest.raises(ValueError, match=rule):
        sh.cache_slice(lm, whole, tp, 0, mode)
    with pytest.raises(ValueError, match=rule):
        lm.init_caches(1, length, device="meta", tp=tp, j=0, mode=mode)
    with pytest.raises(ValueError, match=rule):
        serve_collectives(lm, tp, 1, length, "decode", mode)
    cell = count_cell(cfg, ShapeConfig("d", "decode", length, 1),
                      meta_mesh((1, tp), ("data", "model")),
                      {"cache_shard": mode})
    assert cell["tp_collectives"] is None
    assert rule in cell["tp_collectives_reason"]
    mem = cell["memory"]
    assert rule in mem["reason"]
    assert [mem[k] for k in ("argument_bytes", "output_bytes", "alias_bytes",
                             "peak_estimate_gib")] == [None] * 4
    mesh = _mesh((1, tp))
    eng = Engine(lm, lm.init(0, device="cpu"), length, mesh=mesh,
                 device="cpu", cache_mode=mode)
    with pytest.raises(ValueError, match=rule):
        eng.generate(torch.zeros((1, 4), dtype=torch.long), 2)


def test_decode_takes_the_layout_from_the_caches_or_refuses():
    """``tp_decode_step`` reads the layout the prefill's caches name, and
    raises for a plain list, which names none."""
    cfg = _cfg("smollm-135m", SMOLLM_9H)
    lm = LM(cfg)
    mesh = _mesh((1, 4))
    slices = sh.gather_over(sh.shard_tree(lm.init(0, device="cpu"),
                                          sh.param_specs(
                                              lm.abstract_params(),
                                              ("data",), tp="model"), mesh),
                            ("data",))
    parts = [slices[j] for j in range(4)]
    group = ModelGroup(mesh, "model", [0, 1, 2, 3])
    tokens = torch.zeros((1, 4), dtype=torch.long)
    token = torch.zeros((1, 1), dtype=torch.long)
    _, caches = lm.tp_prefill(parts, tokens, group, cache_len=8,
                              cache_mode="seq")
    assert (caches.mode, caches.length) == ("seq", 8)
    lm.tp_decode_step(parts, token, caches, 4, group)
    with pytest.raises(ValueError, match="name no kv cache layout"):
        lm.tp_decode_step(parts, token, list(caches), 5, group)


GLOO_RUN = """
import sys, dataclasses, json, pickle, torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch import make_mesh
from repro_torch.launch.mesh import (ModelGroup, collective_bytes,
                                     reset_collective_bytes)
from repro_torch.models import LM
from repro_torch.models import sharding as sh
kind, rank, d, world = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                        int(sys.argv[4]))
torch.set_num_threads(1)
if kind == "rank":
    dist.init_process_group("gloo", init_method="file://" + d + "/store",
                            world_size=world, rank=rank)
    mesh = make_mesh((1, world), ("data", "model"))
    group = ModelGroup(mesh, "model", [rank])
else:
    mesh = make_mesh((1, world), ("data", "model"), devices=["cpu"] * world)
    group = ModelGroup(mesh, "model", list(range(world)))
cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                          dtype="float32", n_heads=9, n_kv=3)
lm = LM(cfg)
tree = sh.shard_tree(lm.init(0, device="cpu"), sh.param_specs(
    lm.abstract_params(), ("data",), tp="model"), mesh)
slices = sh.gather_over(tree, ("data",))
parts = [slices[j] for j in sorted(slices)]
tokens = torch.randint(0, cfg.vocab, (2, 16),
                       generator=torch.Generator().manual_seed(3))
res = {}
for mode in json.loads(sys.argv[5]):
    reset_collective_bytes()
    logits, caches = lm.tp_prefill(parts, tokens, group, cache_len=4 * 17,
                                   cache_mode=mode)
    out = [logits]
    for i in range(3):
        out.append(lm.tp_decode_step(parts, out[-1].argmax(-1)[:, None],
                                     caches, 16 + i, group)[0])
    res[mode] = dict(logits=torch.stack(out), caches=list(caches),
                     bytes=collective_bytes())
with open(d + "/" + kind + str(rank) + ".pkl", "wb") as f:
    pickle.dump(res, f)
"""


def test_gloo_ranks_equal_the_in_process_mesh(tmp_path):
    """Four gloo ranks on (1, 4), each its own position of the 9-head /
    3-kv smollm (``ModelGroup.all_to_all`` across ranks: the pieces'
    shapes, then the pieces, uneven and empty ones included), against one
    process driving the in-process mesh, under "hd" and "seq": every
    rank's logits and its caches equal the in-process position's bit for
    bit, and each rank counts the bytes the in-process mesh counts for
    its first position."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    modes = json.dumps(["hd", "seq"])
    script = textwrap.dedent(GLOO_RUN)
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, kind, str(r), str(tmp_path), "4",
         modes], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for kind, r in [("rank", r) for r in range(4)]
        + [("local", 0)]]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-3000:]

    def load(name):
        with open(tmp_path / f"{name}.pkl", "rb") as f:
            return pickle.load(f)

    local = load("local0")
    for r in range(4):
        mine = load(f"rank{r}")
        for mode in ("hd", "seq"):
            assert torch.equal(mine[mode]["logits"], local[mode]["logits"])
            for a, b in zip(tree_leaves(mine[mode]["caches"][0]),
                            tree_leaves(local[mode]["caches"][r])):
                assert torch.equal(a, b), (r, mode)
            if r == 0:
                assert mine[mode]["bytes"] == local[mode]["bytes"]
