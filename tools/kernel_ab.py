#!/usr/bin/env python3
"""Time K1 (pairwise distances), K3 (center precheck) and K6 (SSD
intra-chunk), and a streaming pass whose center buffer stays full, of two
checkouts of the port on one NVIDIA GPU, in turns.

    python3 tools/kernel_ab.py --src build/parent/src --src src [--only k3,stream]

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
cells of q = 16); K3's stats route (``center_precheck_stats``, in every
checkout since it was ported) on a 128-point block of unit rows, d = 5000,
against 65 center slots with 3 valid (the songs-sim scan's final state) and
with all 65 valid, and against 257 slots all valid (tau 256), and its
fused route (``block_precheck``) where the checkout has one. ``stream``:
one streaming pass (radius variant, block 128, k = 22, 16 categories with
caps of 6) at the Songs widths (237,698 points, d = 5000) over a stream
that drifts along a smooth closed curve (8 harmonics in random directions,
plus 1e-4 noise): its first points are close, so R starts small and the
center buffer stays between half full and full (tau 64 and 256). The pass
is ingested in 16,384-point batches; each checkout prints its wall time,
points/s, the scan's counts, K3's launches, the valid centers after each
batch, the final state's epoch fingerprint (equal across checkouts: the
state is exact) and a profiled window of 64 blocks resumed into the final
state (CUDA kernels a block). Inputs come from ``--seed``.
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
# (B, T, valid slots, d)
K3_CASES = ((128, 65, 3, 5000), (128, 65, 65, 5000), (128, 257, 257, 5000))
STREAM_N, STREAM_DIM, STREAM_K, STREAM_TAUS = 237_698, 5000, 22, (64, 256)
STREAM_BATCH, STREAM_BLOCK, STREAM_HARMONICS = 16_384, 128, 8
KERNELS = ("k1", "k3", "k6", "stream")


def device_ms(fn, reps: int = 20) -> dict:
    """Device time of each kernel a call of ``fn`` launches: chip_smoke's
    profiler window over ``reps`` calls, divided by them."""
    prof = chip_smoke.device_profile(lambda: [fn() for _ in range(reps)])
    return {t["name"][:60]: t["ms"] / reps for t in prof.get("top", [])}


def drifting_stream(n: int, d: int, seed: int):
    """(n, d) f32 points along a smooth closed curve in stream order, plus
    1e-4 isotropic noise, and (n, 1) int32 categories of 16, on the card."""
    import math

    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    t = torch.arange(n, device="cuda", dtype=torch.float64) / n
    w = torch.arange(1, STREAM_HARMONICS + 1, device="cuda",
                     dtype=torch.float64)
    feats = torch.cat([torch.cos(2 * math.pi * w * t[:, None]),
                       torch.sin(2 * math.pi * w * t[:, None])], 1)
    dirs = torch.randn(2 * STREAM_HARMONICS, d, generator=g, device="cuda",
                       dtype=torch.float64) / math.sqrt(d)
    x = (feats / torch.cat([w, w]) @ dirs).float()
    x += 1e-4 / math.sqrt(d) * torch.randn(n, d, generator=g, device="cuda")
    cats = torch.randint(0, 16, (n, 1), generator=g, device="cuda")
    return x, cats.to(torch.int32).cpu().numpy()


def stream_pass(seed: int) -> list:
    import time

    import numpy as np
    import torch
    from repro_torch.core import epoch_fingerprint, ingest_batch
    from repro_torch.core import init_stream_state, streaming
    from repro_torch.core.matroid import MatroidSpec
    from repro_torch.kernels import ops

    x, cats = drifting_stream(STREAM_N, STREAM_DIM, seed)
    valid = np.ones(STREAM_N, bool)
    spec = MatroidSpec("partition", num_categories=16, gamma=1)
    caps = np.full(16, 6, np.int32)
    out = []
    for tau in STREAM_TAUS:
        def ingest(st, lo, hi):
            return ingest_batch(st, x[lo:hi], cats[lo:hi], valid[lo:hi],
                                spec, caps, STREAM_K, tau, base_index=lo,
                                block_size=STREAM_BLOCK)

        st = init_stream_state(STREAM_DIM, 1, spec, STREAM_K, tau,
                               device="cuda")
        centers = []
        torch.cuda.synchronize()
        ops.reset_launches()
        streaming.reset_scan_counts()
        t0 = time.perf_counter()
        for lo in range(0, STREAM_N, STREAM_BATCH):
            st = ingest(st, lo, min(STREAM_N, lo + STREAM_BATCH))
            centers.append(int(st.cvalid.sum()))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = streaming.scan_counts()
        k3 = ops.launch_counts()["center_precheck"]
        lo = STREAM_N // 2 // STREAM_BLOCK * STREAM_BLOCK
        before = streaming.scan_counts()
        window = chip_smoke.device_profile(
            lambda: ingest(st, lo, lo + 64 * STREAM_BLOCK), count="precheck")
        after = streaming.scan_counts()
        out.append(dict(
            tau=tau, n=STREAM_N, dim=STREAM_DIM, pass_s=secs,
            points_per_s=STREAM_N / secs, scan_counts=counts,
            k3_launches=k3, centers_after_each_batch=centers,
            fingerprint=list(epoch_fingerprint(st)),
            window_64_blocks=dict(
                kernels_per_block=window["launches"] / 64,
                k3_per_block=window["counted"] / 64,
                replays=after["replays"] - before["replays"],
                device_ms=window["device_ms"], wall_ms=window["wall_ms"],
                busy_share_of_span=window["busy_share_of_span"])))
    return out


def worker(src: str, seed: int, only: tuple) -> dict:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build, pdist, precheck, ref, ssd

    disable_tf32()
    g = torch.Generator(device="cuda").manual_seed(seed)
    res = dict(src=src, k1=[], k3=[], k6=[])
    for B, T, nv, d in K3_CASES if "k3" in only else ():
        x = torch.randn(B, d, generator=g, device="cuda")
        x = x / x.norm(dim=1, keepdim=True)
        c = torch.randn(T, d, generator=g, device="cuda")
        c = c / c.norm(dim=1, keepdim=True)
        cv = torch.arange(T, device="cuda") < nv
        got = precheck.center_precheck_stats(x, c, cv)
        want = ref.center_precheck_matmul(x, c, cv)
        res["k3"].append(dict(
            shape=[B, T, d], valid=nv,
            ms=chip_smoke.time_ms(
                lambda: precheck.center_precheck_stats(x, c, cv)),
            device_ms=device_ms(
                lambda: precheck.center_precheck_stats(x, c, cv)),
            dmin_max_abs_err=float((got[0] - want[0]).abs().max()),
            z_equal=bool(torch.equal(got[1], want[1]))))
        if hasattr(precheck, "block_precheck"):  # the fused route, since PR 17

            def fused():
                return precheck.block_precheck(x, c, cv, None, 1.0,
                                               ref.SLACK, 0.0, 0.0)

            res["k3"][-1].update(fused_ms=chip_smoke.time_ms(fused),
                                 fused_device_ms=device_ms(fused))
    for m in K1_ROWS if "k1" in only else ():
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
    for bc, q in K6_CELLS if "k6" in only else ():
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
    if "stream" in only:
        res["stream"] = stream_pass(seed)
    res["ptxas"] = {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln
                           or "Compiling entry" in ln]
                    for name, log in _build.BUILD_LOG.items()}
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=",".join(KERNELS),
                    help="comma-separated items to time (k1, k3, k6, stream)")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    only = tuple(args.only.split(","))
    if args.worker:
        print(json.dumps(worker(args.src[0], args.seed, only)), flush=True)
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
             str(args.seed), "--only", args.only], capture_output=True,
            text=True)
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
