"""Tensor-parallel training across gloo ranks against the in-process mesh.

One spawn of 4 gloo ranks (a ``file://`` store), and one more process
with the same threads driving the in-process meshes: reduced smollm-135m,
musicgen-medium, phi3.5-moe and zamba2-7b on a (2, 2) ("data", "model")
mesh, and reduced llama-3.2-vision-90b and a 6-head/2-kv smollm-135m on
(1, 4), in f32, three steps at M = 1 and 2 from one initial state. Each
rank runs its own position's share (the copy-ins' and reduce-outs' sums
gathered across the model group and added in shard order, the gradients
reduce-scattered across the data group; phi3.5-moe's experts split over
the model group, its routing pass's expert counts all-reduced across the
data group; zamba2-7b's Mamba2 heads split over the model group, its
``in_proj`` and conv slices gathered across it and their gradients
reduce-scattered back; the vlm's cross attention on a rank's head with
the image rows, and both (1, 4) cases' ``wk`` and ``wv`` gathered across
the model group, the 6-head smollm's ``wq`` and ``wo`` too, as the axis
divides neither its kv heads nor its heads), so every rank's losses,
grad norms, gathered state and collective bytes must be the in-process
run's bit for bit; and the checkpoint rank 0 writes alone must be the
in-process one's, byte for byte.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (name, arch, mesh, config overrides)
CASES = [("smollm-135m", "smollm-135m", (2, 2), {}),
         ("musicgen-medium", "musicgen-medium", (2, 2), {}),
         ("phi3.5-moe-42b-a6.6b", "phi3.5-moe-42b-a6.6b", (2, 2), {}),
         ("zamba2-7b", "zamba2-7b", (2, 2), {}),
         ("llama-3.2-vision-90b-1x4", "llama-3.2-vision-90b", (1, 4), {}),
         ("smollm-6h2kv-1x4", "smollm-135m", (1, 4),
          {"n_heads": 6, "n_kv": 2})]
RANKS = 4

RUN = """
import sys, dataclasses, json, numpy as np, torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.launch import make_mesh
from repro_torch.launch.mesh import collective_bytes, reset_collective_bytes
from repro_torch.models import LM
from repro_torch.models import sharding as sh
from repro_torch.train import (AdamWConfig, CheckpointManager, StepConfig,
                               init_train_state, make_train_step)
from repro_torch.train.checkpoint import _paths
from repro_torch.train.train_state import state_specs
kind, rank, d, world = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                        int(sys.argv[4]))
if kind == "rank":
    dist.init_process_group("gloo", init_method="file://" + d + "/store",
                            world_size=world, rank=rank)
meshes = {}
res = {}
for name, arch, shape, over in json.loads(sys.argv[5]):
    shape = tuple(shape)
    if shape not in meshes:
        if kind == "rank":
            meshes[shape] = make_mesh(shape, ("data", "model"))
            assert meshes[shape].multi_rank and meshes[shape].rank == rank
        else:
            meshes[shape] = make_mesh(shape, ("data", "model"),
                                      devices=["cpu"] * world)
    mesh = meshes[shape]
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              **over)
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    specs = state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                       tp="model"), c)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (8, 32)))}
    if cfg.family == "vlm":
        batch["img"] = torch.as_tensor(np.random.default_rng(6)
                                       .standard_normal((8, cfg.n_img_tokens,
                                                         cfg.d_model))
                                       .astype(np.float32) * 0.1)
    for M in (1, 2):
        state = init_train_state(lm, 0, c, mesh=mesh, specs=specs)
        step = make_train_step(lm, c, StepConfig(microbatches=M), mesh=mesh)
        out, colls = [], None
        for i in range(3):
            reset_collective_bytes()
            state, m = step(state, batch)
            if i == 0:
                colls = collective_bytes()
            out.append((float(m["loss"]), float(m["grad_norm"])))
        res[name, M] = (out, colls, [(k, t.clone()) for k, t in
                                     _paths(sh.gather_tree(state))])
    if name == "smollm-135m":
        mgr = CheckpointManager(d + "/ckpt_" + kind)
        mgr.save(3, state)
        mgr.wait()
torch.save(res, d + "/" + kind + str(rank) + ".pt")
if kind == "rank":
    dist.destroy_process_group()
"""


def _spawn(d, ranks: int, cases: list) -> tuple:
    """Each rank's results from one spawn of ``ranks`` gloo ranks, and the
    in-process mesh's, from one more process with the same threads."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    code = textwrap.dedent(RUN)
    jobs = [("rank", r) for r in range(ranks)] + [("inproc", 0)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, kind, str(r), str(d), str(ranks),
         json.dumps(cases)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for kind, r in jobs]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for (kind, r), p, log in zip(jobs, procs, logs):
        assert p.returncode == 0, f"{kind} {r}:\n{log}"
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(ranks)], torch.load(d / "inproc0.pt",
                                               weights_only=False)


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Each rank's results, from one spawn of 4 gloo ranks, and the
    in-process mesh's."""
    d = tmp_path_factory.mktemp("gloo_tp")
    return (d, *_spawn(d, RANKS, CASES))


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", [name for name, *_ in CASES])
def test_gloo_ranks_give_the_in_process_steps(gloo, arch, M):
    _d, ranks, inproc = gloo
    want_steps, want_colls, want_state = inproc[arch, M]
    assert want_colls["reduce-out"] and want_colls["copy-in"]
    if arch.endswith("1x4"):  # the kv heads' columns span two positions
        assert want_colls["regroup"] and want_colls["regroup-sum"]
    for res in ranks:
        steps, colls, state = res[arch, M]
        assert steps == want_steps
        assert colls == want_colls  # each rank counts its own position
        assert [k for k, _ in state] == [k for k, _ in want_state]
        for (k, x), (_, y) in zip(state, want_state):
            assert x.dtype == y.dtype and torch.equal(x, y), k


def test_gloo_tp_checkpoint_is_the_in_process_one(gloo):
    d, _ranks, _inproc = gloo
    with np.load(d / "ckpt_rank" / "step_0000000003" / "arrays.npz") as z, \
            np.load(d / "ckpt_inproc" / "step_0000000003" / "arrays.npz") \
            as w:
        assert sorted(z.files) == sorted(w.files)
        for key in z.files:
            np.testing.assert_array_equal(z[key], w[key], err_msg=key)


def test_gloo_ranks_without_heads_give_the_in_process_steps(
        tmp_path_factory):
    """8 gloo ranks on (1, 8), reduced smollm-135m's 4 heads: the ranks
    that hold no head run the same graph on empty tensors and launch no
    attention, so every rank takes part in each regroup and copy-in in
    the same order, and all give the in-process steps bit for bit."""
    d = tmp_path_factory.mktemp("gloo_tp_headless")
    ranks, inproc = _spawn(d, 8, [("smollm-1x8", "smollm-135m", (1, 8),
                                   {})])
    for M in (1, 2):
        want_steps, want_colls, want_state = inproc["smollm-1x8", M]
        assert want_colls["regroup"]
        for res in ranks:
            steps, colls, state = res["smollm-1x8", M]
            assert steps == want_steps and colls == want_colls
            for (k, x), (_, y) in zip(state, want_state):
                assert torch.equal(x, y), k
