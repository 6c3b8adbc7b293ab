"""End-to-end training driver: a (reduced) smollm-135m trained for a few
hundred steps with DMMC diversity-maximized batch selection vs random
batches: the paper's technique as a data-curation feature.

    PYTHONPATH=src python -m repro_torch.examples.diverse_training \\
        [--steps 200] [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.diverse_training --full

Reference: ``examples/diverse_training.py``. Runs ``python -m
repro_torch.launch.train`` twice as subprocesses (diverse, then random
batches). Checkpoints land in ``--ckpt-dir`` and a rerun resumes (kill it
mid-run to see).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="full 135M config (slow on the CPU)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_diverse_ckpt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card: raise here, not in a child

    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", "smollm-135m", "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--log-every", "20", "--ckpt-every", "100",
        "--device", args.device,
    ]
    if not args.full:
        base.append("--reduced")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path
                                             else ""))

    print("=== diverse (coreset-selected) batches ===", flush=True)
    subprocess.run(base + ["--ckpt-dir", args.ckpt_dir], env=env, check=True)
    print("=== random batches (ablation) ===", flush=True)
    subprocess.run(base + ["--no-diverse-data"], env=env, check=True)


if __name__ == "__main__":
    main()
