"""Quickstart: diversity maximization under a partition matroid, all three
settings (sequential Alg. 1 / streaming Alg. 2 / MapReduce over a mesh).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Reference: ``examples/quickstart.py``. MapReduce runs over
``launch.mesh.make_mesh`` on the visible cards (one position a card; on
``--device cpu`` one position on the host).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import PartitionMatroid, solve_dmmc
from repro_torch.core.matroid import MatroidSpec
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh

SETTINGS = ("sequential", "streaming", "mapreduce")


def instance(n: int = 5000, h: int = 6, seed: int = 0):
    """(points, cats, caps, spec): points on a low-dimensional manifold
    (the paper's doubling-dimension regime), each with a category; at most
    2 picks per category."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, 3)) @ rng.normal(size=(3, 16))
    points = (base + 0.05 * rng.normal(size=(n, 16))).astype(np.float32)
    cats = rng.integers(0, h, (n, 1)).astype(np.int32)
    caps = np.full(h, 2, np.int32)
    spec = MatroidSpec("partition", num_categories=h, gamma=1)
    return points, cats, caps, spec


def run(device: str = "cuda", n: int = 5000, k: int = 8,
        tau: int = 64) -> dict:
    """The solution of each setting, each checked for independence."""
    dev = resolve_device(device)
    points, cats, caps, spec = instance(n)
    sols = {}
    for setting in SETTINGS:
        kw = dict(setting=setting, tau=tau, device=dev)
        if setting == "mapreduce":
            if dev.type == "cuda":
                kw["mesh"] = make_mesh((torch.cuda.device_count(),),
                                       ("data",))
            else:
                kw["mesh"] = make_mesh((1,), ("data",), devices=[dev])
        sol = solve_dmmc(points, k, spec, cats=cats, caps=caps, **kw)
        m = PartitionMatroid(cats[:, 0], caps)
        assert m.is_independent(list(sol.indices))
        print(f"{setting:>11}: diversity={sol.diversity:9.2f}  "
              f"coreset={sol.coreset_size:4d}/{n}  "
              f"coreset_time={sol.timings['coreset_s']:.2f}s  "
              f"solver_time={sol.timings['solver_s']:.2f}s  "
              f"picked={sorted(sol.indices.tolist())}")
        sols[setting] = sol
    return sols


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=5000)
    args = ap.parse_args(argv)
    run(args.device, n=args.n)


if __name__ == "__main__":
    main()
