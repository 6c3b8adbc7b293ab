"""Training driver: resumable, preemption-safe, diverse data on.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --batch 16 --seq 2048 --ckpt-dir ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --steps 20 --batch 8 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch phi3.5-moe-42b-a6.6b --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \
        --device cpu --data-axis-size 4 --steps 20 --batch 8 --seq 32
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --reduced --device cpu --data-axis-size 4 --steps 20 --batch 8

Reference: ``repro/launch/train.py`` (``main`` :56). The contract is the
reference's:

* SIGTERM/SIGINT: finish the in-flight step, checkpoint, return (exit 0);
* a restart with the same ``--ckpt-dir`` resumes from the latest step and
  reproduces the uninterrupted run, because the data pipeline is seekable
  by step and the step is deterministic;
* a non-finite loss at a logged step aborts.

Diversity-maximised batch selection is on by default (``--no-diverse-
data`` to ablate): every batch is picked from a candidate pool by
SeqCoreset on K2 (``data/pipeline.py``).

Sharded over a data axis (FSDP, the reference's ``--data-axis-size``,
``make_mesh`` and ``param_specs(..., ("data",), tp=None)``): the state is
placed on a ``("data",)`` mesh of ``--data-axis-size`` positions, each
holding its slice of the parameters and AdamW moments, and the batch is
split over them when it divides (the reference's activation-mesh rule).
When ``torch.distributed`` is initialised (``torchrun`` sets the
environment this reads), each rank drives its own position, gloo on the
CPU and NCCL on cards, and the axis is the world. Without it the axis
is one position unless ``--data-axis-size`` asks for more: N positions
in process, which run one after another (``--device cpu
--data-axis-size N`` on the CPU; on cards, N of them, 0 meaning every
visible card, which gains no speed over one: use ``torchrun`` to drive
cards at once). Asking for more cards than are visible raises; a run
never falls back to fewer. A resumed run restores onto whatever mesh it
has (elastic), as checkpoints are stored unsharded.

Every text family trains here (dense, audio, moe, ssm, hybrid), on any
data axis; the loss adds 0.01 times the MoE load-balancing aux, over the
whole batch (``train_state.make_train_step`` sums the expert densities
across the positions). A vlm (``llama-3.2-vision-90b``) is refused: the
data pipeline makes token batches only, and its loss needs image
embeddings beside them (``LM.loss(params, tokens, img)`` and
``make_train_step``'s ``{"tokens", "img"}`` batches train it from
Python).

``main(argv)`` returns the losses of the steps it ran, so a caller can
drive it in process; ``after_step(n)``, if given, is called after step n
(the chip smoke run sends itself SIGTERM from it to test preemption).
"""
from __future__ import annotations

import argparse
import math
import os
import signal
import threading
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..data.pipeline import DataConfig, Pipeline
from ..device import disable_tf32, resolve_device
from ..models.model import LM
from ..models.sharding import param_specs
from ..train.checkpoint import CheckpointManager
from ..train.optimizer import AdamWConfig
from ..train.train_state import (
    StepConfig,
    abstract_train_state,
    init_train_state,
    make_train_step,
    state_specs,
)
from .mesh import make_mesh


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
    ap.add_argument("--data-axis-size", type=int, default=None,
                    help="positions of the data axis the state is sharded "
                         "over (default: the torch.distributed world, "
                         "else 1); without torch.distributed they run in "
                         "process one after another, 0 = every visible "
                         "card")
    return ap.parse_args(argv)


def _mesh(args, dev):
    """The run's ("data",) mesh: a rank a position when torch.distributed
    is initialised with that world, else one position or as many
    in-process positions as asked for (cards must be visible, the CPU
    may repeat)."""
    if not dist.is_initialized() and \
            int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if dist.is_initialized():
        n = args.data_axis_size or dist.get_world_size()
        if n != dist.get_world_size():
            raise ValueError(f"--data-axis-size {n} under a world of "
                             f"{dist.get_world_size()} ranks")
        mesh = make_mesh((n,), ("data",))
        if mesh.devices[mesh.rank].type == "cuda":
            torch.cuda.set_device(mesh.devices[mesh.rank])
        return mesh
    n = 1 if args.data_axis_size is None else args.data_axis_size
    if dev.type == "cpu":
        n = n or 1
        return make_mesh((n,), ("data",), devices=[dev] * n)
    if n == 1:
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return make_mesh((1,), ("data",), devices=[dev])
    n = n or torch.cuda.device_count()
    return make_mesh((n,), ("data",))  # raises on fewer cards than n


def main(argv=None, *,
         after_step: Optional[Callable[[int], None]] = None) -> list[float]:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        disable_tf32()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "vlm":
        raise ValueError(
            f"--arch {args.arch} is a vlm: its loss needs image embeddings, "
            f"and the data pipeline makes token batches only; train it from "
            f"Python with make_train_step and {{'tokens', 'img'}} batches")
    lm = LM(cfg)
    mesh = _mesh(args, dev)
    n_dev = mesh.size
    lead = not mesh.multi_rank or mesh.rank == 0
    log = print if lead else (lambda *a, **k: None)
    log(f"[train] {cfg.name}: {lm.param_count():,} params "
        f"({'reduced' if args.reduced else 'full'}) on {n_dev} x "
        f"{mesh.devices[0]}", flush=True)

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=min(100, args.steps // 10 + 1))
    pspecs = param_specs(lm.abstract_params(), ("data",), tp=None)
    sspecs = state_specs(pspecs, opt_cfg)
    train_step = make_train_step(
        lm, opt_cfg, StepConfig(microbatches=args.microbatches),
        grad_specs=pspecs, mesh=mesh)
    pipe = Pipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        diverse_selection=not args.no_diverse_data, seed=args.seed,
    ), device=mesh.devices[mesh.local_positions()[0]])

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        start = mgr.latest_step()
        log(f"[train] resuming from step {start} (elastic restore onto "
            f"{n_dev} positions)", flush=True)
        state = mgr.restore(start, abstract_train_state(lm, opt_cfg),
                            mesh=mesh, specs=sspecs)
    else:
        state = init_train_state(lm, args.seed, opt_cfg, mesh=mesh,
                                 specs=sspecs)

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
                log(f"[train] step {step + 1:5d} loss {loss:.4f} "
                    f"gnorm {gn:.3f} tok/s {tokens_done / dt:,.0f}",
                    flush=True)
                if not math.isfinite(loss):
                    raise RuntimeError("NaN/Inf loss — aborting")
            if after_step is not None:
                after_step(step + 1)
            stopping = stop.is_set()
            if mesh.multi_rank:  # the ranks stop together or not at all
                flag = torch.tensor([float(stopping)],
                                    device=mesh.devices[mesh.rank])
                stopping = bool(mesh.pmax([flag], ("data",))[0])
            if mgr and ((step + 1) % args.ckpt_every == 0 or stopping):
                mgr.save(step + 1, state)
            if stopping:
                if mgr:
                    mgr.wait()
                log(f"[train] clean preemption exit at step {step + 1}",
                    flush=True)
                return [float(x) for x in losses]
        if mgr:
            mgr.save(args.steps, state)
            mgr.wait()
        out = [float(x) for x in losses]
        if out:
            log(f"[train] done: {args.steps} steps, final loss "
                f"{out[-1]:.4f}", flush=True)
        return out
    finally:
        for sig, old in handlers.items():
            signal.signal(sig, old)


if __name__ == "__main__":
    main()
