"""The port's twins of ``examples/*.py`` (``repro_torch.examples``) on the
CPU, at small sizes set through their own arguments.

Each keeps its reference's checks (matroid independence, the intent caps,
the served answers against the offline ``solve_dmmc``, the two training
runs exiting 0); ``quickstart``'s selections in all three settings equal
the JAX package's ``solve_dmmc`` on the same seeded inputs. The
``diversity_service`` twin's tree queries go to the host exhaustive
search, whose 2,000,000-node budget takes minutes on the CPU whatever the
stream's size: its test runs the search at a budget of 20,000 nodes (the
example's checks are on the sum queries). The twins refuse ``--device
cuda`` on a host without a card.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import solve_dmmc as jax_solve_dmmc
from repro.core.matroid import MatroidSpec as JSpec
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro_torch.core.solvers import host as host_engines
from repro_torch.examples import (
    diversity_service,
    quickstart,
    serving_diverse,
    streaming_topics,
)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
NAMES = ["quickstart", "streaming_topics", "diversity_service",
         "serving_diverse", "diverse_training"]


def _run_module(name, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *args],
        env=env, capture_output=True, text=True, timeout=timeout)


def test_quickstart_matches_jax_in_every_setting():
    n, k, tau = 1500, 8, 64
    sols = quickstart.run("cpu", n=n, k=k, tau=tau)
    points, cats, caps, _ = quickstart.instance(n)
    jspec = JSpec("partition", num_categories=6, gamma=1)
    for setting in quickstart.SETTINGS:
        kw = dict(setting=setting, tau=tau)
        if setting == "mapreduce":
            kw["mesh"] = jax_make_mesh((len(jax.devices()),), ("data",))
        want = jax_solve_dmmc(points, k, jspec, cats=cats, caps=caps, **kw)
        got = sols[setting]
        assert sorted(got.indices.tolist()) == sorted(
            np.asarray(want.indices).tolist()), setting
        assert got.coreset_size == want.coreset_size, setting
        np.testing.assert_allclose(got.diversity, want.diversity, rtol=1e-5)


def test_streaming_topics_twin():
    sol = streaming_topics.run("cpu", n=400, k=6, tau=16)
    assert len(sol.indices) == 6
    assert 0 < sol.coreset_size < 400


def test_serving_diverse_twin():
    sol, out = serving_diverse.run("cpu", B=12, steps=4, k=6)
    assert tuple(out.shape) == (12, 4)
    assert len(sol.indices) == 6


def test_diversity_service_twin(tmp_path, monkeypatch):
    monkeypatch.setattr(host_engines, "exhaustive_best", functools.partial(
        host_engines.exhaustive_best, max_nodes=20_000))
    out = diversity_service.run("cpu", n=2000, batch=500,
                                out_dir=str(tmp_path))
    with open(out["metrics"]) as f:
        names = {json.loads(line)["name"] for line in f if line.strip()}
    assert "serve.query.latency_s" in names
    with open(out["trace"]) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert any(e.get("name") == "query_batch" for e in events)


def test_diverse_training_twin_runs_both_arms(tmp_path):
    r = _run_module("diverse_training", "--device", "cpu", "--steps", "3",
                    "--batch", "4", "--seq", "16", "--ckpt-dir",
                    str(tmp_path / "ckpt"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "=== diverse" in r.stdout and "=== random" in r.stdout


@pytest.mark.parametrize("name", NAMES)
def test_twin_refuses_cuda_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default runs there")
    r = _run_module(name, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device available" in r.stderr
