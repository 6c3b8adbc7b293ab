"""The port stands alone: no JAX, no reference package, no silent CPU run."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import MatroidSpec, solve_dmmc

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "chip_smoke.py" in names
    assert "src/repro_torch/core/solve.py" in names
    assert "src/repro_torch/kernels/gmm_step.py" in names
    for f in ("models/model.py", "models/mamba.py", "serve/engine.py",
              "kernels/flash.py", "kernels/ssd.py", "train/optimizer.py",
              "train/train_state.py", "train/checkpoint.py",
              "data/pipeline.py", "data/songs.py", "launch/train.py",
              "obs/metrics.py", "obs/tracing.py", "obs/export.py",
              "obs/torchprof.py", "core/solvers/jit_sum.py",
              "core/solvers/jit_greedy.py", "core/solvers/stacked.py",
              "core/solvers/cost_model.py", "core/solvers/matching.py",
              "core/compose.py", "serve/diversity/__init__.py",
              "serve/diversity/query.py", "serve/diversity/cache.py",
              "serve/diversity/tenants.py", "serve/diversity/faults.py",
              "serve/diversity/runtime.py", "serve/diversity/frontend.py",
              "serve/diversity/service.py", "serve/diversity/wal.py",
              "serve/diversity/checkpoint.py", "serve/diversity/coalesce.py",
              "serve/diversity/health.py", "serve/diversity/replication.py",
              "serve/diversity/audit.py", "core/mapreduce.py",
              "core/distributed_gmm.py", "launch/mesh.py",
              "train/compression.py"):
        assert f"src/repro_torch/{f}" in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_solve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default runs there")
    rng = np.random.default_rng(0)
    P = rng.normal(size=(50, 4)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_dmmc(P, 3, MatroidSpec("uniform"), tau=4)


@pytest.mark.parametrize("entry", ["init", "engine"])
def test_lm_defaults_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default runs there")
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve.engine import Engine

    lm = LM(get_config("smollm-135m").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "init":
            lm.init(0)
        else:
            Engine(lm, lm.init(0, device="cpu"), 16)
