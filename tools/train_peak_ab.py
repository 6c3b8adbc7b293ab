#!/usr/bin/env python3
"""Peak device memory and step time of mamba2-2.7b training for two
checkouts of the port on one NVIDIA GPU, in turns.

    python3 tools/train_peak_ab.py --src build/parent/src --src src

Each ``--src`` is the ``src`` directory of a checkout (for the parent
commit: ``git archive <commit> src | tar -x -C build/parent``). The sources
run in the order given, then in reverse (A, B, B, A), each in a process of
its own that builds that checkout's kernels. A process sets the training
up as ``chip_smoke.py``'s ``train_ssm`` phase does (full width and depth,
bf16, random weights from ``--seed``, batch 8 x 2,048, diverse selection
on, the initial weights kept beside a fresh train state), runs one forward
and backward of the loss as a warm-up, then takes three steps with the
peak reset before the first, and prints one JSON line: the card
(``nvidia-smi`` name and power limit), the source, the peak
(``torch.cuda.max_memory_allocated``) over the three steps and each step's
time.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3

CHILD = r"""
import json, sys, time
import torch
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, Pipeline
from repro_torch.device import disable_tf32
from repro_torch.models import LM
from repro_torch.models.model import tree_leaves, tree_map
from repro_torch.train import AdamWConfig, adamw_init, make_train_step

disable_tf32()
seed, steps = int(sys.argv[1]), int(sys.argv[2])
cfg = get_config("mamba2-2.7b")
lm = LM(cfg)
params = lm.init(seed, device="cuda")
opt = AdamWConfig(total_steps=steps, warmup_steps=min(100, steps // 10 + 1))
pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=2048, global_batch=8,
                           seed=seed))
live = tree_map(lambda t: t.detach().requires_grad_(True), params)
loss, _ = lm.loss(live, pipe.batch_at(0)["tokens"])
torch.autograd.grad(loss, tree_leaves(live))
del live, loss
torch.cuda.synchronize()
torch.cuda.empty_cache()
torch.cuda.reset_peak_memory_stats()
p = tree_map(lambda t: t.detach().clone(), params)
state = {"params": p, "opt": adamw_init(p, opt),
         "step": torch.zeros((), dtype=torch.int32, device="cuda")}
step = make_train_step(lm, opt)
times = []
for i in range(steps):
    t0 = time.perf_counter()
    state, m = step(state, {"tokens": pipe.batch_at(i)["tokens"]})
    float(m["loss"])
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
print(json.dumps(dict(peak_device_bytes=torch.cuda.max_memory_allocated(),
                      step_s=times)))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a checkout's src directory (give two)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if card.returncode != 0:
        print("train_peak_ab: no NVIDIA GPU", file=sys.stderr)
        return 1
    order = args.src + args.src[::-1]
    for src in order:
        env = dict(os.environ, PYTHONPATH=str(Path(src).resolve()))
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, str(args.seed), str(STEPS)],
            env=env, cwd=ROOT, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(card=card.stdout.strip(), src=src, **res)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
