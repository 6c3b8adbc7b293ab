#!/usr/bin/env python3
"""Time K1 (pairwise distances) and K6 (SSD intra-chunk) of two checkouts of
the port on one NVIDIA GPU, in turns.

    python3 tools/kernel_ab.py --src build/parent/src --src src

Each ``--src`` is the ``src`` directory of a checkout (for the parent
commit: ``git archive <commit> | tar -x -C build/parent``). The sources run
in the order given, then in reverse (A, B, B, A), each in a process of its
own that builds that checkout's kernels, so two versions are compared
inside one call on one card. Each process prints one JSON line: the card
(``nvidia-smi`` name and power limit), and per shape the kernel's median
time over 20 CUDA-event timings after 3 warm-ups, the device time of each
kernel it launches (profiler, per call over 20 calls), its route where the
checkout records one, and its largest error against the plain version.

Shapes are the main paths' own: K1 on unit rows against themselves (327
rows, the songs-sim solve's coreset at seed 0, and 1,408 = k * tau rows,
d = 5000); K6 in zamba2-7b's layout (112 heads of p = 64, n = 64, B and C
stride-0 head views) at the 24 x 1,024-token prefill (96 x 112 cells of
q = 256) and at the embedding forward over 1,040 tokens (1,560 x 112
cells of q = 16). Inputs come from ``--seed``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# the repo root: chip_smoke's timing helpers (it imports no port module
# until a phase runs, so each --src below still picks the port it loads)
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

K1_ROWS = (327, 1408)
K1_DIM = 5000
# (batch * chunks, q): the prefill and the embedding forward
K6_CELLS = ((96, 256), (1560, 16))
K6_HEADS, K6_P, K6_N = 112, 64, 64


def device_ms(fn, reps: int = 20) -> dict:
    """Device time of each kernel a call of ``fn`` launches: chip_smoke's
    profiler window over ``reps`` calls, divided by them."""
    prof = chip_smoke.device_profile(lambda: [fn() for _ in range(reps)])
    return {t["name"][:60]: t["ms"] / reps for t in prof.get("top", [])}


def worker(src: str, seed: int) -> dict:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build, pdist, ref, ssd

    disable_tf32()
    g = torch.Generator(device="cuda").manual_seed(seed)
    res = dict(src=src, k1=[], k6=[])
    for m in K1_ROWS:
        x = torch.randn(m, K1_DIM, generator=g, device="cuda")
        x = x / x.norm(dim=1, keepdim=True)
        got = pdist.pairwise_sqdist(x, x)
        err = float((got - ref.pairwise_sqdist(x, x)).abs().max())
        res["k1"].append(dict(
            shape=[m, m, K1_DIM],
            ms=chip_smoke.time_ms(lambda: pdist.pairwise_sqdist(x, x)),
            device_ms=device_ms(lambda: pdist.pairwise_sqdist(x, x)),
            route=getattr(pdist, "last_route", None),
            splits=getattr(pdist, "last_splits", None), max_abs_err=err))
        del x, got
    for bc, q in K6_CELLS:
        H, P, N = K6_HEADS, K6_P, K6_N
        xbar = torch.randn(bc, q, H, P, generator=g,
                           device="cuda").permute(0, 2, 1, 3)
        loga = -(torch.rand(bc, q, H, generator=g, device="cuda") * 0.39
                 + 0.01).permute(0, 2, 1)
        B, C = (torch.randn(bc, 1, q, N, generator=g, device="cuda")
                .expand(-1, H, -1, -1) for _ in range(2))
        y, s = ssd.ssd_intra_chunk(xbar, loga, B, C)
        y_r, s_r = ref.ssd_intra_chunk(xbar, loga, B, C)
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in ((y, y_r), (s, s_r))]
        del y, s, y_r, s_r
        res["k6"].append(dict(
            shape=[bc, H, q, P, N],
            ms=chip_smoke.time_ms(
                lambda: ssd.ssd_intra_chunk(xbar, loga, B, C)),
            device_ms=device_ms(lambda: ssd.ssd_intra_chunk(xbar, loga, B, C)),
            route=getattr(ssd, "last_route", None),
            y_err_rel_to_max=errs[0], state_err_rel_to_max=errs[1]))
        del xbar, loga, B, C
        torch.cuda.empty_cache()
    res["ptxas"] = {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "Compiling entry" in ln]
                    for name, log in _build.BUILD_LOG.items()}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.src[0], args.seed)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for src in args.src + args.src[::-1]:
        out = subprocess.run(
            [sys.executable, __file__, "--worker", "--src", src, "--seed",
             str(args.seed)], capture_output=True, text=True)
        if out.returncode != 0:
            print(f"kernel_ab: {src} failed\n{out.stdout}{out.stderr}",
                  file=sys.stderr)
            runs.append(dict(src=src, failed=True))
            continue
        line = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        runs.append(line)
    print(json.dumps(dict(card=smi, runs=runs)))
    return 1 if any(r.get("failed") for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
