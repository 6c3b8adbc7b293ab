"""Tensor-parallel training across gloo ranks against the in-process mesh.

One spawn of 4 gloo ranks (a ``file://`` store) on a (2, 2) ("data",
"model") mesh, and one more process with the same threads driving the
in-process mesh: reduced smollm-135m, musicgen-medium and phi3.5-moe in
f32, three steps at M = 1 and 2 from one initial state. Each rank runs
its own position's share (the copy-ins' and reduce-outs' sums gathered
across the model group and added in shard order, the gradients
reduce-scattered across the data group; phi3.5-moe's experts split over
the model group, its routing pass's expert counts all-reduced across the
data group; zamba2-7b's Mamba2 heads split over the model group, its
``in_proj`` and conv slices gathered across it and their gradients
reduce-scattered back), so every rank's losses, grad norms, gathered
state and collective bytes must be the in-process run's bit for bit; and
the checkpoint rank 0 writes alone must be the in-process one's, byte for
byte.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["smollm-135m", "musicgen-medium", "phi3.5-moe-42b-a6.6b",
         "zamba2-7b"]
RANKS = 4

RUN = """
import sys, dataclasses, numpy as np, torch
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
kind, rank, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
if kind == "rank":
    dist.init_process_group("gloo", init_method="file://" + d + "/store",
                            world_size=4, rank=rank)
    mesh = make_mesh((2, 2), ("data", "model"))
    assert mesh.multi_rank and mesh.rank == rank
else:
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
res = {}
for arch in sys.argv[4:]:
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    lm = LM(cfg)
    c = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    specs = state_specs(sh.param_specs(lm.abstract_params(), ("data",),
                                       tp="model"), c)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (8, 32)))
    for M in (1, 2):
        state = init_train_state(lm, 0, c, mesh=mesh, specs=specs)
        step = make_train_step(lm, c, StepConfig(microbatches=M), mesh=mesh)
        out, colls = [], None
        for i in range(3):
            reset_collective_bytes()
            state, m = step(state, {"tokens": toks})
            if i == 0:
                colls = collective_bytes()
            out.append((float(m["loss"]), float(m["grad_norm"])))
        res[arch, M] = (out, colls, [(k, t.clone()) for k, t in
                                     _paths(sh.gather_tree(state))])
    if arch == "smollm-135m":
        mgr = CheckpointManager(d + "/ckpt_" + kind)
        mgr.save(3, state)
        mgr.wait()
torch.save(res, d + "/" + kind + str(rank) + ".pt")
if kind == "rank":
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Each rank's results, from one spawn of 4 gloo ranks, and the
    in-process mesh's, from one more process with the same threads."""
    d = tmp_path_factory.mktemp("gloo_tp")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["OMP_NUM_THREADS"] = "1"
    code = textwrap.dedent(RUN)
    jobs = [("rank", r) for r in range(RANKS)] + [("inproc", 0)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, kind, str(r), str(d), *ARCHS], env=env,
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
    return d, [torch.load(d / f"rank{r}.pt", weights_only=False)
               for r in range(RANKS)], torch.load(d / "inproc0.pt",
                                                  weights_only=False)


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_gloo_ranks_give_the_in_process_steps(gloo, arch, M):
    _d, ranks, inproc = gloo
    want_steps, want_colls, want_state = inproc[arch, M]
    assert want_colls["reduce-out"] and want_colls["copy-in"]
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
