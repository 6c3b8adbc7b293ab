"""The port's dry run (``repro_torch.launch.dryrun``) and its op counter
(``launch/op_cost.py``) against the reference's ``launch/dryrun.py`` and
``launch/hlo_cost.py``, on the CPU.

* the op counter: the reference's loop case (``tests/test_system.py``'s
  scan of ``tanh(c @ w)``, seven trips) counts the same FLOPs exactly, and
  single ops count their products and bytes exactly;
* ``model_flops``: equal to the reference's for every arch and applicable
  shape at full size (the reference imported in a subprocess: it forces
  512 host devices on import);
* the dot FLOPs of a reduced cell of each family and kind (train,
  prefill, decode): the plain path's count within 1% of the reference's
  ``hlo_cost.analyze`` on a one-device CPU compile, for every family (the
  plain twins of K6 and K6b compute C B^T once per batch x chunk, as the
  reference's jnp SSD does);
* the kernel records: each plain twin's measured FLOPs equal its formula
  at the intercepted shapes, and the kernels' causal tiles;
* memory: ``argument_bytes`` equals a real CPU sharded state's bytes a
  position (and the position's token rows);
* collectives: the bytes the dry run derives for the FSDP step equal, to
  the byte, what a reduced sharded step moves on 2 and 4 in-process
  positions (``launch.mesh.collective_bytes``), and those it derives for
  the tensor-parallel step (``tp_collectives``, and ``fsdp_collectives``
  with ``tp``) what a reduced step moves on (2, 2), (1, 2) and (1, 4)
  ("data", "model") meshes, and those of a serving cell
  (``serve_collectives``) what one ``LM.tp_prefill`` or
  ``LM.tp_decode_step`` moves;
* the CLI writes a record with the reference's keys, a decode cell's
  model-axis bytes among them.
"""
import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import count_cell, fsdp_collectives, meta_mesh
from repro_torch.launch.mesh import (
    collective_bytes,
    make_mesh,
    reset_collective_bytes,
)
from repro_torch.launch.op_cost import OpCost, analyze
from repro_torch.models import LM
from repro_torch.models.model import tree_leaves
from repro_torch.models.sharding import param_specs
from repro_torch.train import AdamWConfig, init_train_state, make_train_step
from repro_torch.train.train_state import StepConfig, state_specs

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
META = "meta"

FAMILY_ARCHS = ["smollm-135m", "musicgen-medium", "phi3.5-moe-42b-a6.6b",
                "llama4-maverick-400b-a17b", "mamba2-2.7b", "zamba2-7b",
                "llama-3.2-vision-90b"]
KINDS = ["train", "prefill", "decode"]
CELLS = [(a, k) for a in FAMILY_ARCHS for k in KINDS]
RED_S, RED_B = 32, 2


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _run_ref(script: str, *args, timeout=900) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(script),
                        *args], env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


# --------------------------------------------------------------------------
# the op counter
# --------------------------------------------------------------------------


def test_loop_is_counted_per_trip_like_the_reference_scan():
    """tests/test_system.py's scan case: 7 steps of tanh(c @ w)."""
    ws, x = _meta(7, 64, 64), _meta(16, 64)

    def fn(ws, x):
        c = x
        for w in ws:
            c = torch.tanh(c @ w)
        return c.sum()

    res = analyze(fn, ws, x)
    assert res["flops"] == 2 * 16 * 64 * 64 * 7
    assert res["top_dots"][0][0] == 2 * 16 * 64 * 64 * 7


@pytest.mark.parametrize("case", ["mm", "addmm", "bmm", "add", "view",
                                  "inplace", "einsum"])
def test_single_op_flops_and_bytes(case):
    a, b = _meta(8, 32), _meta(32, 16)
    f32 = 4
    if case == "mm":
        res = analyze(lambda: a @ b)
        assert res["flops"] == 2 * 8 * 32 * 16
        assert res["hbm_bytes"] == (8 * 32 + 32 * 16 + 8 * 16) * f32
    elif case == "addmm":
        bias = _meta(16)
        res = analyze(lambda: torch.addmm(bias, a, b))
        assert res["flops"] == 2 * 8 * 32 * 16
        assert res["hbm_bytes"] == (16 + 8 * 32 + 32 * 16 + 8 * 16) * f32
    elif case == "bmm":
        x, y = _meta(3, 8, 32, dtype=torch.bfloat16), _meta(
            3, 32, 16, dtype=torch.bfloat16)
        res = analyze(lambda: torch.bmm(x, y))
        assert res["flops"] == 2 * 3 * 8 * 32 * 16
        assert res["hbm_bytes"] == 3 * (8 * 32 + 32 * 16 + 8 * 16) * 2
    elif case == "add":
        res = analyze(lambda: a + a)
        assert res["flops"] == 0
        assert res["all_flops"] == 8 * 32
        assert res["hbm_bytes"] == 3 * 8 * 32 * f32
    elif case == "view":
        res = analyze(lambda: a.t().reshape(4, 64).contiguous())
        # the transpose and the reshape of a contiguous tensor are views;
        # reshaping the transposed tensor copies it once
        assert res["hbm_bytes"] == 2 * 8 * 32 * f32
    elif case == "inplace":
        c = _meta(8, 32)
        res = analyze(lambda: c.mul_(2.0))
        assert res["hbm_bytes"] == 2 * 8 * 32 * f32
    else:
        x, y = _meta(2, 5, 7), _meta(2, 7, 3)
        res = analyze(lambda: torch.einsum("bij,bjk->bik", x, y))
        assert res["flops"] == 2 * 2 * 5 * 7 * 3


def test_memory_tracks_live_storages_and_saved_tensors():
    w = _meta(64, 64, dtype=torch.float32).requires_grad_(True)
    x = _meta(16, 64)
    with OpCost() as oc:
        watched = oc.watch((w, x))
        y = torch.tanh(x @ w)  # saves its output
        loss = y.sum()
        del y
        loss.backward()
    res = oc.result()
    assert watched == (64 * 64 + 16 * 64) * 4
    assert res["saved_bytes"] >= 16 * 64 * 4  # tanh's output, x is watched
    assert res["peak_live_bytes"] >= watched + 2 * 16 * 64 * 4
    assert res["largest_op_bytes"] == 64 * 64 * 4  # the weight's gradient


# --------------------------------------------------------------------------
# model_flops against the reference, every arch and applicable shape
# --------------------------------------------------------------------------

REF_MODEL_FLOPS = """
import json
from repro.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro.launch.dryrun import model_flops
from repro.models.model import LM
out = {}
for a in ARCH_IDS:
    cfg = get_config(a)
    for s, shape in SHAPES.items():
        if shape_applicable(cfg, shape):
            out[f"{a}/{s}"] = model_flops(cfg, shape, LM(cfg))
print(json.dumps(out))
"""


def test_model_flops_equal_the_reference_for_every_cell():
    ref = _run_ref(REF_MODEL_FLOPS)
    mine = {}
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s, shape in SHAPES.items():
            if shape_applicable(cfg, shape):
                mine[f"{a}/{s}"] = dryrun.model_flops(cfg, shape, LM(cfg))
    assert mine.keys() == ref.keys()
    for key in ref:
        assert mine[key] == ref[key], key


# --------------------------------------------------------------------------
# dot FLOPs of reduced cells against the reference's hlo_cost.analyze
# --------------------------------------------------------------------------

REF_CELLS = """
import json, sys
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.launch.hlo_cost import analyze
from repro.models.model import LM
from repro.train.optimizer import AdamWConfig
from repro.train.train_state import (StepConfig, abstract_train_state,
                                     make_train_step)
out = {}
S, B = int(sys.argv[2]), int(sys.argv[3])
for arch, kind in json.loads(sys.argv[1]):
    cfg = get_config(arch).reduced()
    lm = LM(cfg)
    toks = jax.ShapeDtypeStruct((B, S if kind != "decode" else 1), jnp.int32)
    img = (jax.ShapeDtypeStruct((B, cfg.n_img_tokens, cfg.d_model),
                                jnp.dtype(cfg.dtype))
           if cfg.family == "vlm" else None)
    ia = (img,) if img is not None else ()
    if kind == "train":
        opt = AdamWConfig(moment_dtype="float32", master_dtype="float32")
        batch = {"tokens": toks}
        if img is not None:
            batch["img"] = img
        co = jax.jit(make_train_step(lm, opt, StepConfig())).lower(
            abstract_train_state(lm, opt), batch).compile()
    elif kind == "prefill":
        co = jax.jit(lambda p, t, *i: lm.prefill(p, t, *i)).lower(
            lm.abstract_params(), toks, *ia).compile()
    else:
        caches = jax.eval_shape(lambda: lm.init_caches(B, S))
        pos = jax.ShapeDtypeStruct((), jnp.int32)
        co = jax.jit(lambda p, t, c, q, *i: lm.decode_step(p, t, c, q, *i)
                     ).lower(lm.abstract_params(), toks, caches, pos,
                             *ia).compile()
    out[f"{arch}/{kind}"] = analyze(co.as_text())["flops"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_cells():
    return _run_ref(REF_CELLS, json.dumps(CELLS), str(RED_S), str(RED_B))


def _reduced_cell(arch, kind, mesh=None):
    return count_cell(
        get_config(arch).reduced(), ShapeConfig("reduced", kind, RED_S,
                                                RED_B),
        mesh or meta_mesh((1, 1), ("data", "model")),
        opt_cfg=AdamWConfig(moment_dtype="float32", master_dtype="float32"),
        step_cfg=StepConfig())


@pytest.mark.parametrize("arch,kind", CELLS)
def test_reduced_cell_dot_flops_match_hlo_cost(ref_cells, arch, kind):
    c = _reduced_cell(arch, kind)
    want = ref_cells[f"{arch}/{kind}"]
    got = c["counted"]["flops"]
    assert abs(got / want - 1) <= 0.01, (got, want)
    if kind == "decode":
        assert got == want  # no kernel and no SSD chunk on decode


# --------------------------------------------------------------------------
# the kernel records
# --------------------------------------------------------------------------


def _plain_flops(name, shapes):
    if name == "flash_attention_fwd":
        (bh, sq, hd), (_, skv, _) = shapes[0], shapes[1]
        return 4 * bh * sq * skv * hd
    if name == "flash_attention_bwd":
        (bh, sq, hd), (_, skv, _) = shapes[0], shapes[1]
        return 10 * bh * sq * skv * hd
    *lead, q, p = shapes[0]
    n = shapes[2][-1]
    cells = math.prod(lead)
    groups = math.prod(shapes[2][:-2])  # the cells that share B and C
    gram = groups * 2 * q * q * n  # C B^T, once a group
    if name == "ssd_intra_chunk":
        return gram + cells * (2 * q * q * p + 2 * q * n * p)
    return gram + cells * (2 * 2 * q * q * n + 2 * 2 * q * q * p
                           + 2 * 2 * q * n * p)


def _padding(name, shapes):
    if not name.startswith("flash"):
        return 1.0
    sq, skv = shapes[0][1], shapes[1][1]
    tiled = 64 * -(-sq // 64) * 64 * -(-skv // 64)
    return tiled / (sq * skv) * (7 / 5 if name.endswith("bwd") else 1)


@pytest.mark.parametrize("arch,kind", [
    ("smollm-135m", "train"), ("mamba2-2.7b", "train"),
    ("zamba2-7b", "train"), ("llama-3.2-vision-90b", "prefill")])
def test_kernel_records_match_their_formulas(arch, kind):
    c = _reduced_cell(arch, kind)
    names = {k["name"] for k in c["kernels"]}
    want = {"flash_attention_fwd"}
    if kind == "train":
        want.add("flash_attention_bwd")
    if get_config(arch).family in ("ssm", "hybrid"):
        want |= {"ssd_intra_chunk"} | ({"ssd_intra_chunk_bwd"}
                                       if kind == "train" else set())
        if get_config(arch).family == "ssm":
            want -= {"flash_attention_fwd", "flash_attention_bwd"}
    assert names == want
    for k in c["kernels"]:
        assert sum(call["launches"] for call in k["calls"]) == k["launches"]
        assert k["plain_flops"] == sum(
            call["launches"] * _plain_flops(k["name"], call["shapes"])
            for call in k["calls"]), k["name"]
        # at most the twin's products over whole 64-row tiles (a 32-row
        # sequence fills half a tile), seven for five in K5
        most = sum(call["launches"] * _plain_flops(k["name"], call["shapes"])
                   * _padding(k["name"], call["shapes"])
                   for call in k["calls"])
        assert 0 < k["kernel_flops"] <= most, k["name"]
    per = c["per_position"]["flops"]
    assert per == (c["counted"]["flops"]
                   - sum(k["plain_flops"] for k in c["kernels"])
                   + sum(k["kernel_flops"] for k in c["kernels"]))


def test_causal_tiles():
    assert dryrun._tiles(64, 64, True) == 1
    assert dryrun._tiles(128, 128, True) == 3
    assert dryrun._tiles(129, 129, True) == 6
    assert dryrun._tiles(100, 300, False) == 2 * 5
    q = _meta(6, 256, 64)
    flops = dryrun.kernel_flops("flash_attention_fwd", (q, q, q), True)
    assert flops == 2 * 2 * 6 * 10 * 64 * 64 * 64


# --------------------------------------------------------------------------
# memory and collectives against a real sharded step
# --------------------------------------------------------------------------

TRAIN_ARCH = "smollm-135m"


def _cpu_mesh(n):
    return make_mesh((n,), ("data",), devices=["cpu"] * n)


@pytest.mark.parametrize("n", [2, 4])
def test_argument_bytes_equal_a_real_sharded_state(n):
    cfg = get_config(TRAIN_ARCH).reduced()
    lm = LM(cfg)
    opt = AdamWConfig(moment_dtype="float32", master_dtype="float32")
    batch, seq = 8, 16
    state = init_train_state(lm, 0, opt, mesh=_cpu_mesh(n))
    real = sum(t.numel() * t.element_size()
               for t in tree_leaves(state.shards[0]))
    real += (batch // n) * seq * 4  # the position's int32 token rows
    c = count_cell(cfg, ShapeConfig("t", "train", seq, batch),
                   meta_mesh((n,), ("data",)), opt_cfg=opt,
                   step_cfg=StepConfig())
    assert c["memory"]["argument_bytes"] == real


@pytest.mark.parametrize("n,M", [(2, 1), (4, 1), (2, 2), (4, 4)])
def test_collective_bytes_equal_what_a_sharded_step_moves(n, M):
    cfg = get_config(TRAIN_ARCH).reduced()
    lm = LM(cfg)
    opt = AdamWConfig()
    step_cfg = StepConfig(microbatches=M)
    batch, seq = 8, 16
    mesh = _cpu_mesh(n)
    state = init_train_state(lm, 0, opt, mesh=mesh)
    step = make_train_step(lm, opt, step_cfg, mesh=mesh, force="ref")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, seq)), dtype=torch.int32)
    reset_collective_bytes()
    step(state, {"tokens": tokens})
    moved = collective_bytes()
    want = fsdp_collectives(lm, step_cfg, n, batch)
    assert moved == want
    c = count_cell(cfg, ShapeConfig("t", "train", seq, batch),
                   meta_mesh((n,), ("data",)), opt_cfg=opt,
                   step_cfg=step_cfg)
    assert c["per_position"]["collectives"] == want
    assert c["per_position"]["collective_bytes"] == sum(want.values())


SERVE_CASES = {  # a prefill or decode cell: (arch, config overrides)
    "prefill": ("zamba2-7b", {}),
    "decode": ("llama-3.2-vision-90b", {}),
}


def _tp_serve_moves(arch, over, n, tp, kind, batch, seq):
    """The model axis's bytes by kind of one in-process ``Engine``
    prefill, or of one decode step after it, on a (n, tp) mesh."""
    from repro_torch.launch.mesh import ModelGroup
    from repro_torch.serve.engine import Engine

    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    lm = LM(cfg)
    mesh = make_mesh((n, tp), ("data", "model"), devices=["cpu"] * (n * tp))
    eng = Engine(lm, lm.init(0, device="cpu"), seq + 1, mesh=mesh,
                 device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, seq)))
    img = (torch.as_tensor(rng.standard_normal(
        (batch, cfg.n_img_tokens, cfg.d_model)), dtype=torch.float32)
        if cfg.family == "vlm" else None)
    ((_d, members),) = list(eng.rows.items())[:1]
    group = ModelGroup(mesh, "model", [p for p, _t in members])
    parts = [t for _p, t in members]
    rows = batch // n
    reset_collective_bytes()
    logits, caches = lm.tp_prefill(parts, tokens[:rows], group,
                                   None if img is None else img[:rows],
                                   cache_len=seq + 1, force="ref")
    if kind == "decode":
        reset_collective_bytes()
        lm.tp_decode_step(parts, logits.argmax(-1)[:, None], caches, seq,
                          group)
    return lm, cfg, collective_bytes()


@pytest.mark.parametrize("n,tp,M", [
    (2, 2, 1), (2, 2, 2), (1, 2, 1), (1, 4, 2),
    pytest.param(2, 2, "prefill", id="2-2-prefill"),
    pytest.param(1, 4, "decode", id="1-4-decode")])
def test_tp_collectives_equal_what_a_tp_step_moves(n, tp, M):
    """A train cell on a (n, tp) ("data", "model") mesh: the dry run's
    ``tp_collectives`` are the model axis's bytes that one in-process
    tensor-parallel step of the same shape moves, by kind, and its data
    axis's, in the record's ``collectives`` too, are ``fsdp_collectives``
    with ``tp``. ``M`` "prefill" or "decode": a serving cell, whose
    ``tp_collectives`` are the bytes of one ``LM.tp_prefill`` (zamba2-7b:
    Mamba2 regroups) or one ``LM.tp_decode_step`` after it (the vlm on
    (1, 4): kv heads regrouped, the cross attention's cached), and whose
    data axes move nothing."""
    if M in SERVE_CASES:
        arch, over = SERVE_CASES[M]
        batch, seq = 4, 16
        lm, cfg, moved = _tp_serve_moves(arch, over, n, tp, M, batch, seq)
        c = count_cell(cfg, ShapeConfig("s", M, seq, batch),
                       meta_mesh((n, tp), ("data", "model")))
        assert c["tp_collectives"] == moved
        assert "gather-out" in moved and "regroup" in moved
        assert c["tp_collectives_reason"] is None
        assert c["collectives"] == {}
        assert c["per_device"]["collective_bytes"] == sum(moved.values())
        return
    cfg = dataclasses.replace(get_config("musicgen-medium").reduced(),
                              n_kv=4)
    lm = LM(cfg)
    opt = AdamWConfig()
    step_cfg = StepConfig(microbatches=M)
    batch, seq = 8, 16
    mesh = make_mesh((n, tp), ("data", "model"), devices=["cpu"] * (n * tp))
    specs = state_specs(param_specs(lm.abstract_params(), ("data",),
                                    tp="model"), opt)
    state = init_train_state(lm, 0, opt, mesh=mesh, specs=specs)
    step = make_train_step(lm, opt, step_cfg, mesh=mesh, force="ref")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, seq)), dtype=torch.int32)
    reset_collective_bytes()
    step(state, {"tokens": tokens})
    moved = collective_bytes()
    c = count_cell(cfg, ShapeConfig("t", "train", seq, batch),
                   meta_mesh((n, tp), ("data", "model")), opt_cfg=opt,
                   step_cfg=step_cfg)
    tp_kinds = ("reduce-out", "copy-in", "max")
    assert c["tp_collectives"] == {k: moved[k] for k in tp_kinds}
    assert c["tp_collectives_reason"] is None
    data = {k: v for k, v in moved.items() if k not in tp_kinds}
    assert data == fsdp_collectives(lm, step_cfg, n, batch, tp=tp)
    assert c["collectives"] == data
    assert c["per_device"]["collective_bytes"] == sum(moved.values())


@pytest.mark.parametrize("mode", ["hd", "seq"])
def test_hd_and_seq_decode_cells_count_what_a_tp_decode_moves(mode):
    """A decode cell with ``--cache-shard hd`` or ``seq`` (the reference's
    kv cache layouts, ROADMAP.md step 13.13) on (1, 4), reduced
    smollm-135m with 9 heads and 3 kv heads: its ``tp_collectives`` are
    the model axis's bytes of one ``LM.tp_decode_step`` in that layout, by
    kind (the all-to-alls and all-reduces, and for "seq" the max, beside
    the "heads" layout's kinds); the record names the layout; its
    argument bytes exceed the "heads" cell's by what
    ``init_caches(tp=, j=, mode=)`` allocates beyond the "heads" layout's
    on the largest position."""
    from repro_torch.launch.mesh import ModelGroup
    from repro_torch.serve.engine import Engine

    cfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                              n_heads=9, n_kv=3)
    lm = LM(cfg)
    tp, batch, seq = 4, 4, 16
    mesh = make_mesh((1, tp), ("data", "model"), devices=["cpu"] * tp)
    eng = Engine(lm, lm.init(0, device="cpu"), seq, mesh=mesh,
                 device="cpu")
    ((_d, members),) = eng.rows.items()
    group = ModelGroup(mesh, "model", [p for p, _t in members])
    parts = [t for _p, t in members]
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, seq - 1)))
    logits, caches = lm.tp_prefill(parts, tokens, group, cache_len=seq,
                                   force="ref", cache_mode=mode)
    reset_collective_bytes()
    lm.tp_decode_step(parts, logits.argmax(-1)[:, None], caches, seq - 1,
                      group)
    moved = collective_bytes()
    shape = ShapeConfig("d", "decode", seq, batch)
    meta = meta_mesh((1, tp), ("data", "model"))
    c = count_cell(cfg, shape, meta, {"cache_shard": mode})
    assert c["tp_collectives"] == moved
    assert c["tp_collectives_reason"] is None
    assert {"all-to-all", "all-reduce"} <= set(moved)
    assert ("max" in moved) == (mode == "seq")
    assert c["extra"]["cache_mode"] == mode
    heads = count_cell(cfg, shape, meta)

    def most(m):
        return max(sum(t.numel() * t.element_size() for t in tree_leaves(
            lm.init_caches(batch, seq, device="meta", tp=tp, j=j, mode=m)))
            for j in range(tp))

    assert (c["memory"]["argument_bytes"]
            - heads["memory"]["argument_bytes"]) == most(mode) - most("heads")


# --------------------------------------------------------------------------
# the CLI record
# --------------------------------------------------------------------------


def _reference_record_keys():
    """The keyword names of ``rec = dict(...)`` and ``mem = dict(...)`` in
    the reference's ``run_cell``, read from its source (importing it
    would force 512 host devices on this process)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    keys = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id in ("rec", "mem")
                and isinstance(node.value, ast.Call)):
            keys[node.targets[0].id] = {k.arg for k in node.value.keywords
                                        if k.arg}
    return keys["rec"], keys["mem"]


def test_cli_writes_a_record_with_the_reference_keys(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "decode_32k", "--mesh", "both",
         "--out-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    rec_keys, mem_keys = _reference_record_keys()
    want = (rec_keys - {"xla_cost_analysis", "compile_s", "lower_s"}) \
        | {"trace_s"}
    for mk, chips in (("single", 256), ("multi", 512)):
        path = tmp_path / f"smollm-135m__decode_32k__{mk}__base.json"
        rec = json.loads(path.read_text())
        assert want <= set(rec), want - set(rec)
        assert mem_keys <= set(rec["memory"])
        assert rec["chips"] == chips
        # decode on the model axis of 16: one tp_decode_step's bytes
        # (test_tp_collectives_equal_... holds them to a real step), the
        # data axes' none; 3 kv heads do not split over 16
        tpc = rec["tp_collectives"]
        assert rec["tp_collectives_reason"] is None
        assert set(tpc) == {"reduce-out", "regroup", "gather-out"}
        assert all(v > 0 for v in tpc.values())
        assert rec["collectives"] == {}
        assert rec["cache_mode"] == "kv-heads-regrouped"
        assert rec["cache_mode_reference"] in ("hd", "seq")
        assert rec["dominant"] in rec["terms_s"]
        assert rec["roofline_bound_s"] == max(rec["terms_s"].values())
        assert rec["per_device"]["collective_bytes"] == sum(tpc.values())
        assert rec["memory"]["argument_bytes"] > 0
