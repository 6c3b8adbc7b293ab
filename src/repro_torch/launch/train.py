"""Training driver: resumable, preemption-safe, diverse data on.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 16 --seq 2048 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 20 --batch 8 --seq 32

Reference: ``repro/launch/train.py`` (``main`` :56). The contract is the
reference's:

* SIGTERM/SIGINT: finish the in-flight step, checkpoint, return (exit 0);
* a restart with the same ``--ckpt-dir`` resumes from the latest step and
  reproduces the uninterrupted run, because the data pipeline is seekable
  by step and the step is deterministic;
* a non-finite loss at a logged step aborts.

Diversity-maximised batch selection is on by default (``--no-diverse-
data`` to ablate): every batch is picked from a candidate pool by
SeqCoreset on K2 (``data/pipeline.py``). One device: the reference's
``--data-axis-size`` and mesh wait for the multi-GPU slice (ROADMAP.md
step 11) and are left out rather than accepted and ignored.

``main(argv)`` returns the losses of the steps it ran, so a caller can
drive it in process; ``after_step(n)``, if given, is called after step n
(the chip smoke run sends itself SIGTERM from it to test preemption).
"""
from __future__ import annotations

import argparse
import math
import signal
import threading
import time
from typing import Callable, Optional

from ..configs import ARCH_IDS, get_config
from ..data.pipeline import DataConfig, Pipeline
from ..device import disable_tf32, resolve_device
from ..models.model import LM
from ..train.checkpoint import CheckpointManager
from ..train.optimizer import AdamWConfig
from ..train.train_state import (
    StepConfig,
    abstract_train_state,
    init_train_state,
    make_train_step,
)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-diverse-data", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain kernels)")
    return ap.parse_args(argv)


def main(argv=None, *,
         after_step: Optional[Callable[[int], None]] = None) -> list[float]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        disable_tf32()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    lm = LM(cfg)
    print(f"[train] {cfg.name}: {lm.param_count():,} params "
          f"({'reduced' if args.reduced else 'full'}) on {dev}", flush=True)

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(100, args.steps // 10 + 1))
    train_step = make_train_step(
        lm, opt_cfg, StepConfig(microbatches=args.microbatches))
    pipe = Pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        diverse_selection=not args.no_diverse_data, seed=args.seed,
    ), device=dev)

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        print(f"[train] resuming from step {start}", flush=True)
        state = mgr.restore(start, abstract_train_state(lm, opt_cfg),
                            device=dev)
    else:
        state = init_train_state(lm, args.seed, opt_cfg, device=dev)

    stop = threading.Event()

    def on_signal(signum, frame):
        print(f"[train] signal {signum}: will checkpoint and exit after this "
              f"step", flush=True)
        stop.set()

    handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            handlers[sig] = signal.signal(sig, on_signal)
    losses = []
    try:
        t0 = time.perf_counter()
        tokens_done = 0
        for step in range(start, args.steps):
            batch = pipe.batch_at(step)
            state, metrics = train_step(state, {"tokens": batch["tokens"]})
            losses.append(metrics["loss"])
            tokens_done += args.batch * args.seq
            if (step + 1) % args.log_every == 0 or step == start:
                loss = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                dt = time.perf_counter() - t0
                print(f"[train] step {step + 1:5d} loss {loss:.4f} "
                      f"gnorm {gn:.3f} tok/s {tokens_done / dt:,.0f}",
                      flush=True)
                if not math.isfinite(loss):
                    raise RuntimeError("NaN/Inf loss — aborting")
            if after_step is not None:
                after_step(step + 1)
            if mgr and ((step + 1) % args.ckpt_every == 0 or stop.is_set()):
                mgr.save(step + 1, state)
            if stop.is_set():
                if mgr:
                    mgr.wait()
                print(f"[train] clean preemption exit at step {step + 1}",
                      flush=True)
                return [float(x) for x in losses]
        if mgr:
            mgr.save(args.steps, state)
            mgr.wait()
        out = [float(x) for x in losses]
        if out:
            print(f"[train] done: {args.steps} steps, final loss "
                  f"{out[-1]:.4f}", flush=True)
        return out
    finally:
        for sig, old in handlers.items():
            signal.signal(sig, old)


if __name__ == "__main__":
    main()
