"""Streaming DMMC over a simulated Wikipedia-like stream (transversal
matroid over topics): one pass, bounded memory, topic-diverse summary.

    PYTHONPATH=src python -m repro_torch.examples.streaming_topics \\
        [--device cpu]

Reference: ``examples/streaming_topics.py``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import TransversalMatroid, solve_dmmc
from repro_torch.core.matroid import MatroidSpec


def instance(n: int = 30000, h: int = 20, gamma: int = 2, seed: int = 1):
    rng = np.random.default_rng(seed)
    topic_centers = rng.normal(size=(h, 4))
    basis = rng.normal(size=(4, 25))
    topic = rng.integers(0, h, n)
    points = (topic_centers[topic] @ basis
              + 0.1 * rng.normal(size=(n, 25))).astype(np.float32)
    cats = np.full((n, gamma), -1, np.int32)
    cats[:, 0] = topic
    extra = rng.random(n) < 0.3
    cats[extra, 1] = rng.integers(0, h, extra.sum())
    spec = MatroidSpec("transversal", num_categories=h, gamma=gamma)
    return points, cats, spec


def run(device: str = "cuda", n: int = 30000, k: int = 10, tau: int = 64):
    h = 20
    points, cats, spec = instance(n, h)
    sol = solve_dmmc(points, k, spec, cats=cats, tau=tau,
                     setting="streaming", metric="cosine", device=device)
    m = TransversalMatroid(cats, h)
    assert m.is_independent(list(sol.indices))
    picked_topics = sorted({int(t) for i in sol.indices for t in cats[i]
                            if t >= 0})
    print(f"one pass over {n} docs, working set = {sol.coreset_size} docs")
    print(f"diversity = {sol.diversity:.2f}")
    print(f"selected docs {sol.indices.tolist()}")
    print(f"respecting a matching into topics; topics touched: "
          f"{picked_topics}")
    return sol


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=30000)
    args = ap.parse_args(argv)
    run(args.device, n=args.n)


if __name__ == "__main__":
    main()
