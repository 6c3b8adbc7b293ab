"""Serving + DMMC: batched greedy decoding from a small LM, then a
diversity-maximized, category-constrained selection over the generated
continuations (diverse top-m responses: the paper's web-search use case).

    PYTHONPATH=src python -m repro_torch.examples.serving_diverse \\
        [--device cpu]

Reference: ``examples/serving_diverse.py``. The LM is the reduced
smollm-135m with random weights drawn from a seed; the ``Engine`` decodes
on ``--device`` (K4 on a card) and ``solve_dmmc`` selects there.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import solve_dmmc
from repro_torch.core.matroid import MatroidSpec
from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.serve.engine import Engine


def run(device: str = "cuda", B: int = 24, P: int = 8, steps: int = 16,
        k: int = 6):
    dev = resolve_device(device)
    cfg = get_config("smollm-135m").reduced()
    lm = LM(cfg)
    params = lm.init(0, device=dev)
    eng = Engine(lm, params, max_len=P + steps + 24, device=dev)

    g = torch.Generator(device=dev).manual_seed(3)
    prompts = torch.randint(0, cfg.vocab, (B, P), generator=g, device=dev)
    out = eng.generate(prompts, steps=steps)
    print(f"generated {B} continuations of {steps} tokens")

    # embed each continuation (the mean of the trunk's output) and pick a
    # diverse subset balanced across 4 prompt "intents" (partition matroid)
    with torch.no_grad():
        hidden, _, _ = lm.forward(params, torch.cat([prompts, out], dim=1))
    emb = hidden.float().mean(dim=1).cpu().numpy()
    intents = (np.arange(B) % 4).astype(np.int32)[:, None]
    caps = np.full(4, 2, np.int32)
    spec = MatroidSpec("partition", num_categories=4, gamma=1)
    sol = solve_dmmc(emb, k, spec, cats=intents, caps=caps, tau=12,
                     setting="sequential", metric="cosine", device=dev)
    print(f"diverse top-{k} responses: {sorted(sol.indices.tolist())} "
          f"(<=2 per intent), diversity={sol.diversity:.3f}")
    counts = np.bincount(intents[sol.indices, 0], minlength=4)
    assert counts.max() <= 2
    print(f"intent balance: {counts.tolist()}")
    return sol, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    run(args.device, B=args.batch, steps=args.steps)


if __name__ == "__main__":
    main()
