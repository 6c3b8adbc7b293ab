#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--k 22] [--tau 64]

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. ``device``  the card's name and power limit (``nvidia-smi``).
2. ``build``   nvcc builds each CUDA source in ``src/repro_torch/kernels/
               csrc`` (one process per source, all at once) and Triton
               compiles the GMM step, with their seconds and ptxas lines;
               ``cuobjdump -sass`` counts the tensor-core instructions of
               the flash libraries (``HGMMA`` for wgmma, ``HMMA`` for
               mma.sync), which must be there.
3. ``data``    songs-sim at the paper's Songs widths (n = 237,698,
               dim = 5000, 16 genres, rank ~89), generated on the card.
4. ``kernels`` every kernel against its plain PyTorch version on the card,
               at test shapes and at the main path's shapes; K3 also
               against its exact oracle, under the blocked scan's index
               contract.
5. ``solve``   the sequential path: ``solve_dmmc(setting="sequential",
               metric="cosine", variant="sum", engine="host")`` with launch
               counts set to 0 before and read after. K1 is held to its
               plain version at the solve's coreset rows, and the final
               stage on the plain pdist must select the same points. Then
               the same solve on the plain versions (``force="ref"``) must
               give the same centres, coreset and selection (or a GMM tie,
               printed), and the same value with the diagonal out.
6. ``stream``  the streaming path (Alg. 2 blocked scan, radius variant,
               ``block_size=128``): ``stream_coreset`` on the kernel path;
               the same stream through ``ingest_batch(force="ref")`` in
               batches of 16,384 rows must give the same state bit for bit;
               blocked must equal per-point on a 2,048-point prefix; K3 at
               the main path's shape against the final centers; then
               ``solve_dmmc(setting="streaming")`` with launch counts set
               to 0 before and read after, whose coreset must be the
               scan's snapshot.
7. ``timing``  each kernel, its plain version and (K1) a library call, at
               the inputs the main path gave it, with the least time the
               card could take for the same work; the GMM loop alone.
8. ``lm``      the serving path of the LM stack at zamba2-7b's full width
               (81 Mamba2 layers, one shared attention block applied 13
               times, bf16, random weights from ``LM.init`` at ``--seed``):
               (a) K4 (flash forward) and K6 (SSD intra-chunk) against
               their plain versions at test shapes and at one layer's own
               inputs, captured from a prefill; (b) ``Engine.generate`` for
               24 prompts of 1,024 tokens and 16 new tokens, with launch
               counts set to 0 before and read after, then the same on the
               plain versions (``force="ref"``). The prefill run block by
               block on the plain path, each block also on the kernel path
               from the same input, must agree within 2e-2 of the largest
               value (each block's output, and the logits of the last);
               end to end, the prefill logits must agree within 2e-2 of
               the largest logit or within twice the difference that one
               bf16 step on 1e-4 of the embedding makes on the plain path
               (this random-weight model's own sensitivity); with the
               weights upcast to f32 (no bf16 rounding between layers) the
               two prefills' logits must agree within 2e-2; and the
               greedy tokens wherever the plain top-2 gap clears twice the
               logit difference; (c) the diverse selection of
               ``examples/serving_diverse.py``: each continuation embedded
               as the mean of ``forward``'s output, then ``solve_dmmc(k=6,
               tau=12, setting="sequential", metric="cosine")`` under a
               partition matroid of 4 intents with caps of 2, launch counts
               read around it; (d) one prefill and one decode step under
               the profiler, then K4 and K6 timed at the slice's shapes
               beside their plain versions, their bounds and (K4)
               ``scaled_dot_product_attention``, with K4's route (bf16:
               the tensor cores), TFLOP/s and kernel / library ratio.
9. ``train``   the training path at smollm-135m's full width and depth
               (bf16, random weights, batch 16 x 2,048, diverse selection
               on): (a) K5 (flash backward) against its plain version at
               test shapes, and K5 and K4 at one layer's own inputs,
               captured from a backward; (b) five steps of
               ``make_train_step`` with launch counts set to 0 before and
               read after (K2, K4, K5); the selection on plain GMM must
               pick the same batches; the same five steps on the plain
               versions: step i's loss within 2 (i + 1) times the largest
               difference that one bf16 step on 1e-4 of the embedding
               makes on the plain path up to step i; in f32, the step-0
               loss within 1e-5 and every gradient leaf within 1e-3
               relative L2; (c) ``launch.train.main`` preempted by SIGTERM
               after step 4, resumed to 6, equal to an uninterrupted run
               bit for bit; (d) step time, tokens/s, peak memory, a step
               under the profiler, and K5 beside its plain version, its
               bound and the backward of ``scaled_dot_product_attention``
               (route, TFLOP/s, ratio).

The last two lines are the kernel table and ``{"ok": true, "device": ...}``.
Without a CUDA device, or without the repository beside it, it fails.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # dense, tensor cores

PDIST_SHAPES = [(8, 8, 4), (33, 17, 7), (128, 64, 32), (200, 300, 25),
                (5, 1000, 3)]
GMM_SHAPES = [(16, 4), (100, 25), (1025, 7), (64, 128),
              (64, 32)]  # the last: the train pipeline's pool x embedding
PRECHECK_SHAPES = [(8, 5, 4), (37, 17, 7), (128, 33, 100), (200, 129, 25),
                   (128, 257, 100)]
CUDA_SOURCES = ("pdist", "precheck", "flash_fwd", "flash_bwd", "ssd")
# (BH, Sq, Skv, hd, causal): tests/test_kernels.py's FLASH_SHAPES, then
# hd in {64, 112, 128} with S off the 64-row tile, causal and not, then
# edges of the bf16 tensor-core tiles (hd 40 and 256, S off 128 rows)
FLASH_SHAPES = [(4, 64, 64, 16, True), (2, 48, 80, 32, False),
                (3, 33, 33, 8, True), (1, 128, 128, 64, True),
                (2, 96, 32, 16, False), (3, 100, 100, 64, True),
                (2, 200, 200, 112, True), (2, 130, 257, 112, False),
                (2, 70, 70, 128, True), (2, 90, 150, 128, False),
                (2, 255, 129, 40, True), (2, 129, 255, 256, False)]
# the SASS of the tensor-core routes: flash_fwd must hold wgmma, flash_bwd
# wgmma or mma.sync
TENSOR_CORE_SASS = {"flash_fwd": ("HGMMA",), "flash_bwd": ("HGMMA", "HMMA")}
# (g, q, p, n): tests/test_kernels.py's SSD_SHAPES, then model widths
SSD_SHAPES = [(2, 16, 8, 4), (3, 32, 16, 8), (1, 64, 32, 16), (4, 8, 64, 32),
              (5, 256, 64, 64), (3, 256, 64, 128), (7, 100, 64, 64)]
LM_ARCH = "zamba2-7b"
LM_BATCH, LM_PROMPT, LM_STEPS = 24, 1024, 16  # examples/serving_diverse.py:24
LM_K, LM_TAU, LM_INTENTS, LM_CAP = 6, 12, 4, 2
LM_LOGIT_TOL = 2e-2
LM_HEADS = 32  # zamba2-7b's attention heads (BH = batch x heads)
TRAIN_ARCH = "smollm-135m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 2048, 5  # SmolLM-135M's context
TRAIN_CLI_STEPS, TRAIN_PREEMPT_AT = 6, 4
TRAIN_F32_LOSS_TOL, TRAIN_F32_GRAD_TOL = 1e-5, 1e-3
BLOCK = 128  # the streaming scan's block size on the main path
INGEST_BATCH = 16_384
PREFIX = 2048
TIE_RTOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, *, warmup: int = 3, reps: int = 20) -> float:
    """Median of CUDA-event timings of ``fn`` after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float,
             peak: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and read the card's kernel
    events: their summed time, the span from the first kernel's start to
    the last one's end, the host wall time of the window (the profiler
    adds host overhead to it), the busy share of the span, and the
    kernels with the most time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return dict(wall_ms=wall * 1e3, device_ms=None,
                    note="the profiler showed no device events")
    by_name: dict[str, list] = {}
    for e in kernels:
        entry = by_name.setdefault(e.name, [0.0, 0])
        entry[0] += e.time_range.elapsed_us() / 1e3
        entry[1] += 1
    busy = sum(v[0] for v in by_name.values())
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return dict(wall_ms=wall * 1e3, device_ms=busy, span_ms=span,
                busy_share_of_span=busy / span if span else None,
                busy_share_of_wall=busy / (wall * 1e3),
                kernels=len(kernels),
                top=[dict(name=n[:80], ms=v[0], count=v[1]) for n, v in top])


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = dict(
        phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
    )
    emit(info)
    return info


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from repro_torch.kernels import _build, ops

    def build(name: str) -> float:
        t0 = time.perf_counter()
        _build.library(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        nvcc_s = dict(zip(CUDA_SOURCES, pool.map(build, CUDA_SOURCES)))
    nvcc_wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = torch.randn(100, 25, device="cuda")
    ops.gmm_update(x, x[0], torch.full((100,), torch.inf, device="cuda"),
                   torch.ones(100, dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln or "C75" in ln]
             for name, log in _build.BUILD_LOG.items()}
    sass = {name: _tensor_core_sass(_build.library(name)._name)
            for name in TENSOR_CORE_SASS}
    for name, ops_ in TENSOR_CORE_SASS.items():
        check(sum(sass[name][op] for op in ops_) > 0,
              f"{name}: no {' or '.join(ops_)} in its SASS: {sass[name]}")
    emit(dict(phase="build", nvcc_s=nvcc_s, nvcc_wall_s=nvcc_wall_s,
              triton_first_compile_s=triton_s, tensor_core_sass=sass,
              ptxas=ptxas))


def _tensor_core_sass(lib_path: str) -> dict:
    """Counts of tensor-core instructions in a built library's SASS
    (``cuobjdump -sass``): HGMMA (wgmma) and HMMA (mma.sync)."""
    import re
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "HMMA")}


def phase_data(seed: int):
    import torch
    from repro_torch.core import geometry
    from repro_torch.data import songs_sim

    t0 = time.perf_counter()
    points, cats, caps, spec = songs_sim(seed=seed, device="cuda")
    torch.cuda.synchronize()
    emit(dict(phase="data", n=points.shape[0], dim=points.shape[1],
              genres=int(caps.size), caps=caps.tolist(),
              rank=int(caps.sum()), seconds=time.perf_counter() - t0))
    x_norm = geometry.normalize_for_metric(points, "cosine")
    return points, x_norm, cats, caps, spec


def _first_max_is_tie(md_plain, i: int, j: int) -> bool:
    a, b = float(md_plain[i]), float(md_plain[j])
    return abs(a - b) <= TIE_RTOL * max(abs(a), abs(b))


def _check_precheck(x, c, cv, what: str, *, exact_ties: bool = False) -> dict:
    """K3 against its plain version (``force="ref"``) and its exact oracle
    (``force="exact"``): distances within 1e-4 (1e30 and above compared
    as float32 max), ``z`` equal wherever second - dmin > 2 margin, the
    pair {z, z2} equal wherever third - dmin > 2 margin, and every index
    below T. Where the exact distance is 0 (a stream point that is itself
    a center), the plain matmul form keeps ~sqrt(1e-7 |x|^2) of
    cancellation noise, more than 1e-4: there the kernel is held to the
    plain version within 2 margins instead. ``exact_ties``: the indices
    must equal the exact oracle's on every row (duplicated centers)."""
    import torch
    from repro_torch.kernels import ops

    got = ops.center_precheck(x, c, cv)
    plain = ops.center_precheck(x, c, cv, force="ref")
    exact = ops.center_precheck(x, c, cv, force="exact")
    torch.cuda.synchronize()
    margin = got[5]
    err_plain = err_exact = over_margin = 0.0
    for i in (0, 2, 4):
        zero = exact[i] == 0
        check(bool(torch.all((got[i] - plain[i]).abs()[zero]
                             <= 2 * margin[zero])),
              f"precheck {what}: output {i} at distance 0 off by > 2 margin")
        for want, name in ((plain[i], "plain"), (exact[i], "exact")):
            check(bool(torch.equal(got[i] < 1e30, want < 1e30)),
                  f"precheck {what}: output {i} masks differently from "
                  f"the {name} version")
            fin = (want < 1e30) & ~zero if name == "plain" else want < 1e30
            err = float((got[i] - want)[fin].abs().max()) if fin.any() else 0.0
            check(bool(torch.allclose(got[i][fin], want[fin], rtol=1e-4,
                                      atol=1e-4)),
                  f"precheck {what}: output {i} max abs err {err} vs {name}")
            if name == "plain":
                err_plain = max(err_plain, err)
            else:
                err_exact = max(err_exact, err)
                if fin.any():
                    over_margin = max(over_margin, float(
                        ((got[i] - want).abs() / margin)[fin].max()))
    T = c.shape[0]
    for z in (got[1], got[3]):
        check(bool(torch.all((z >= 0) & (z < T))),
              f"precheck {what}: index outside [0, T)")
    dmin_r, z_r, sec_r, z2_r, third_r, _ = exact
    safe_z = (sec_r - dmin_r) > 2 * margin
    check(bool(torch.equal(got[1][safe_z], z_r[safe_z])),
          f"precheck {what}: z differs where the gap clears the margin")
    safe_pair = (third_r - dmin_r) > 2 * margin
    pair = torch.sort(torch.stack([got[1], got[3]]), dim=0).values
    pair_r = torch.sort(torch.stack([z_r, z2_r]), dim=0).values
    check(bool(torch.equal(pair[:, safe_pair], pair_r[:, safe_pair])),
          f"precheck {what}: {{z, z2}} differs where the gap clears the "
          f"margin")
    if exact_ties:
        check(bool(torch.equal(got[1], z_r) and torch.equal(got[3], z2_r)),
              f"precheck {what}: first-index ties differ from the oracle")
    return dict(kernel="center_precheck", shape=[x.shape[0], T, x.shape[1]],
                what=what, max_abs_err=err_plain,
                max_abs_err_vs_exact=err_exact,
                max_err_over_margin=over_margin,
                z_checked=int(safe_z.sum()), pair_checked=int(safe_pair.sum()),
                tol=1e-4, ok=True)


def _precheck_cases(g):
    """K3's test shapes, all-invalid centers, and duplicated centers."""
    import torch

    for B, T, d in PRECHECK_SHAPES:
        x = torch.randn(B, d, generator=g, device="cuda") * 3
        c = torch.randn(T, d, generator=g, device="cuda") * 3
        cv = torch.rand(T, generator=g, device="cuda") > 0.2
        yield x, c, cv, "random", False
    x = torch.ones(8, 4, device="cuda")
    yield x, torch.zeros(5, 4, device="cuda"), torch.zeros(
        5, dtype=torch.bool, device="cuda"), "all invalid", False
    base = torch.randn(3, 64, generator=g, device="cuda")
    c = base[torch.tensor([2, 0, 1, 0, 2, 1, 0] * 10, device="cuda")]
    cv = torch.ones(70, dtype=torch.bool, device="cuda")
    cv[1] = False
    # points near (not on) a base vector: the plain matmul form leaves
    # ~1e-3 of cancellation noise on a zero distance
    x = base[torch.tensor([0, 1, 2] * 40, device="cuda")] + 0.5 * torch.randn(
        120, 64, generator=g, device="cuda")
    yield x, c.contiguous(), cv, "duplicated centers", True


def phase_kernels(x_norm, m_slice: int, seed: int) -> float:
    """Each kernel against its plain version; returns K2's max abs error at
    the main path's shape."""
    import torch
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    lines, k2_err = [], None
    for x, c, cv, what, ties in _precheck_cases(g):
        lines.append(_check_precheck(x, c, cv, what, exact_ties=ties))
    rows = x_norm[:m_slice].contiguous()
    cases = [(n, m, d, None) for n, m, d in PDIST_SHAPES]
    cases.append((m_slice, m_slice, x_norm.shape[1], rows))
    for n, m, d, data in cases:
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            if data is None:
                x = torch.randn(n, d, generator=g, device="cuda").to(dtype)
                y = torch.randn(m, d, generator=g, device="cuda").to(dtype)
            else:
                x = y = data.to(dtype)
            got = ops.pairwise_sqdist(x, y)
            want = ops.pairwise_sqdist(x, y, force="ref")
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.allclose(got, want, rtol=tol, atol=tol))
            lines.append(dict(kernel="pdist", shape=[n, m, d],
                              dtype=str(dtype), max_abs_err=err, tol=tol,
                              ok=ok))
            check(ok, f"pdist {n}x{m}x{d} {dtype}: max abs err {err}")

    n_full = x_norm.shape[0]
    for n, d in GMM_SHAPES + [(n_full, x_norm.shape[1])]:
        if n == n_full:
            x = x_norm
            valid = torch.ones(n, dtype=torch.bool, device="cuda")
            md0 = torch.full((n,), torch.inf, device="cuda")
            md, far, _ = ops.gmm_update(x, x[0], md0, valid, force="ref")
            z = x[int(far)]
        else:
            x = torch.randn(n, d, generator=g, device="cuda")
            z = torch.randn(d, generator=g, device="cuda")
            md = torch.rand(n, generator=g, device="cuda") * 2.5 + 0.5
            valid = torch.rand(n, generator=g, device="cuda") > 0.1
        nm, fi, fv = ops.gmm_update(x, z, md, valid)
        nm_r, fi_r, fv_r = ops.gmm_update(x, z, md, valid, force="ref")
        torch.cuda.synchronize()
        err = float((nm - nm_r).abs().max())
        check(bool(torch.allclose(nm, nm_r, rtol=1e-5, atol=1e-5)),
              f"gmm_step {n}x{d}: new_min max abs err {err}")
        i, j = int(fi), int(fi_r)
        tie = i != j and _first_max_is_tie(nm_r, i, j)
        check(i == j or tie, f"gmm_step {n}x{d}: far_idx {i} != {j}")
        lines.append(dict(kernel="gmm_step", shape=[n, d], max_abs_err=err,
                          tol=1e-5, far_idx=i, far_idx_plain=j, tie=tie,
                          far_val=float(fv), far_val_plain=float(fv_r),
                          ok=True))
        if n == n_full:
            k2_err = err
    emit(dict(phase="kernels", checks=lines))
    return k2_err


def _solve(points, cats, caps, spec, k, tau, force=None):
    from repro_torch.core import solve_dmmc

    return solve_dmmc(points, k, spec, cats=cats, caps=caps, tau=tau,
                      metric="cosine", variant="sum", engine="host",
                      force=force, device="cuda")


def _first_divergence_is_tie(x_norm, centers, centers_ref) -> tuple[int, bool]:
    """At the first position where the two center sequences differ, whether
    the plain min-distances of the two picks are equal within TIE_RTOL."""
    import torch
    from repro_torch.kernels import ops

    t = int(next(i for i, (a, b) in enumerate(zip(centers, centers_ref))
                 if a != b))
    n, dev = x_norm.shape[0], x_norm.device
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    md = torch.full((n,), torch.inf, device=dev)
    for c in centers_ref[:t]:
        md, _, _ = ops.gmm_update(x_norm, x_norm[int(c)], md, valid,
                                  force="ref", device=dev)
    return t, _first_max_is_tie(md, int(centers[t]), int(centers_ref[t]))


def _value_without_diagonal(x_norm, coreset_indices, indices, force) -> float:
    """The sum diversity of ``indices`` over the coreset matrix (K1 or
    plain) with the diagonal taken out. The plain matmul form leaves
    cancellation noise of up to ~1e-3 on the diagonal, and the host
    solver's sum value includes it (in the reference too); the kernel's
    diagonal is exact."""
    import numpy as np
    import torch
    from repro_torch.core import coreset_distance_matrix, selection_value

    rows = x_norm.index_select(
        0, torch.as_tensor(coreset_indices, device="cuda"))
    D = coreset_distance_matrix(rows, force=force)
    np.fill_diagonal(D, 0.0)
    local = np.searchsorted(coreset_indices, indices)
    return selection_value(D, local, "sum")


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _check_pdist_at(rows, what: str) -> float:
    """K1 against its plain version on ``rows`` against themselves, as
    ``coreset_distance_matrix`` calls it; returns the max abs error."""
    import torch
    from repro_torch.kernels import ops

    got = ops.pairwise_sqdist(rows, rows)
    want = ops.pairwise_sqdist(rows, rows, force="ref")
    err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4)),
          f"pdist at {what} {list(rows.shape)}: max abs err {err}")
    return err


def phase_solve(points, x_norm, cats, caps, spec, k: int, tau: int):
    import numpy as np
    import torch
    from repro_torch.core import PartitionMatroid
    from repro_torch.core.solve import _final_solve
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launches()
    sol = _solve(points, cats, caps, spec, k, tau)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    process_peak = torch.cuda.max_memory_allocated()
    # the solve's own footprint: its input points plus what it allocated
    # above the level before it (the script's x_norm is not the solve's)
    solve_peak = points.numel() * points.element_size() + process_peak - before

    check(launches["gmm_update"] == tau,
          f"K2 launched {launches['gmm_update']} times, expected tau={tau}")
    check(launches["pairwise_sqdist"] >= 1, "K1 was not launched")
    check(len(sol.indices) == k, f"{len(sol.indices)} points selected, k={k}")
    check(PartitionMatroid(cats[:, 0], caps).is_independent(
        list(sol.indices)), "solution violates the partition matroid")
    check(np.isfinite(sol.diversity) and sol.diversity > 0,
          f"diversity {sol.diversity}")
    check(0 < sol.coreset_size <= k * tau,
          f"coreset size {sol.coreset_size} outside (0, k*tau]")

    # K1 at the input the main path gave it (the solve's coreset rows,
    # a partial tile at m = 327), and the final stage on the solve's own
    # coreset with the plain pdist: the same selection, whatever GMM did
    sel = np.sort(sol.indices)
    rows = x_norm.index_select(
        0, torch.as_tensor(sol.coreset_indices, device="cuda"))
    k1_err = _check_pdist_at(rows, "the solve's coreset")
    fs_idx, _ = _final_solve(x_norm, cats, spec, caps, k,
                             sol.coreset_indices, "sum", force="ref")
    check(np.array_equal(np.sort(fs_idx), sel),
          "final stage on the plain pdist selects other indices")

    ref = _solve(points, cats, caps, spec, k, tau, force="ref")
    same_centers = np.array_equal(sol.info["centers"], ref.info["centers"])
    tie_at = rel = rel_with_diag = None
    if not same_centers:
        tie_at, tie = _first_divergence_is_tie(
            x_norm, sol.info["centers"], ref.info["centers"])
        check(tie, f"GMM centers diverge at {tie_at} without a tie")
    else:
        check(np.array_equal(sol.coreset_indices, ref.coreset_indices),
              "coreset differs from the plain path")
        check(np.array_equal(sel, np.sort(ref.indices)),
              "selected indices differ from the plain path")
        mine = _value_without_diagonal(x_norm, sol.coreset_indices,
                                       sol.indices, None)
        plain = _value_without_diagonal(x_norm, ref.coreset_indices,
                                        ref.indices, "ref")
        rel = _rel(mine, plain)
        rel_with_diag = _rel(sol.diversity, ref.diversity)
        check(rel <= 1e-5, f"diversity differs by {rel} relative")
    out = dict(
        phase="solve", n=points.shape[0], dim=points.shape[1], k=k, tau=tau,
        coreset_s=sol.timings["coreset_s"], solver_s=sol.timings["solver_s"],
        total_s=sol.timings["total_s"], gmm_s=sol.info["gmm_s"],
        extract_s=sol.info["extract_s"], coreset_size=sol.coreset_size,
        diversity=sol.diversity, solve_peak_device_bytes=solve_peak,
        process_peak_device_bytes=process_peak, launches=launches,
        pdist_max_abs_err_at_coreset=k1_err,
        plain=dict(coreset_s=ref.timings["coreset_s"],
                   gmm_s=ref.info["gmm_s"], extract_s=ref.info["extract_s"],
                   solver_s=ref.timings["solver_s"],
                   total_s=ref.timings["total_s"], diversity=ref.diversity,
                   coreset_size=ref.coreset_size),
        same_centers=same_centers, center_tie_at=tie_at,
        same_coreset=bool(np.array_equal(sol.coreset_indices,
                                         ref.coreset_indices)),
        same_indices=bool(np.array_equal(sol.indices, ref.indices)),
        diversity_rel_diff_without_diagonal=rel,
        diversity_rel_diff_with_diagonal=rel_with_diag,
    )
    emit(out)
    return sol, launches


def _assert_states_equal(a, b, what: str) -> None:
    import torch
    from repro_torch.core import StreamState

    for f in StreamState._fields:
        check(bool(torch.equal(getattr(a, f), getattr(b, f))),
              f"{what}: field {f} differs")


def phase_stream(points, x_norm, cats, caps, spec, k: int, tau: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import (
        PartitionMatroid,
        epoch_fingerprint,
        ingest_batch,
        init_stream_state,
        snapshot_coreset,
        solve_dmmc,
        stream_coreset,
    )
    from repro_torch.core import streaming
    from repro_torch.core.solve import _final_solve
    from repro_torch.kernels import ops

    n, d = x_norm.shape
    valid = np.ones(n, bool)
    blocks = -(-n // BLOCK)

    # A: one pass on the kernel path
    torch.cuda.synchronize()
    ops.reset_launches()
    streaming.reset_scan_counts()
    t0 = time.perf_counter()
    cs_a, st_a = stream_coreset(x_norm, cats, valid, spec, caps, k, tau,
                                block_size=BLOCK, device="cuda")
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    launches_a = ops.launch_counts()
    counts_a = streaming.scan_counts()
    check(launches_a["center_precheck"] >= blocks,
          f"K3 launched {launches_a['center_precheck']} < {blocks} times")
    check(launches_a["gmm_update"] == 0, "K2 launched on the streaming path")
    fp_a = epoch_fingerprint(st_a)

    # B: the plain path, resumed batch by batch as the serving runtime does
    t0 = time.perf_counter()
    st_b = init_stream_state(d, cats.shape[1], spec, k, tau, device="cuda")
    for off in range(0, n, INGEST_BATCH):
        end = min(n, off + INGEST_BATCH)
        st_b = ingest_batch(st_b, x_norm[off:end], cats[off:end],
                            valid[off:end], spec, caps, k, tau,
                            base_index=off, block_size=BLOCK, force="ref")
        fp_b = epoch_fingerprint(st_b)
    torch.cuda.synchronize()
    plain_stream_s = time.perf_counter() - t0
    _assert_states_equal(st_a, st_b, "kernel pass vs plain batched resume")
    check(fp_a == fp_b, "epoch fingerprints differ")

    # blocked == per-point on a prefix (a per-point pass syncs per point)
    t0 = time.perf_counter()
    _, st_pp = stream_coreset(x_norm[:PREFIX], cats[:PREFIX], valid[:PREFIX],
                              spec, caps, k, tau, block_size=1,
                              device="cuda")
    torch.cuda.synchronize()
    per_point_s = time.perf_counter() - t0
    _, st_bl = stream_coreset(x_norm[:PREFIX], cats[:PREFIX], valid[:PREFIX],
                              spec, caps, k, tau, block_size=BLOCK,
                              device="cuda")
    _assert_states_equal(st_pp, st_bl, f"blocked vs per-point, {PREFIX} pts")

    # a steady-state window on the card: 64 blocks resumed into a copy of
    # the final state, under the profiler
    off = (n // 2) // BLOCK * BLOCK
    window = device_profile(lambda: ingest_batch(
        st_a, x_norm[off:off + 64 * BLOCK], cats[off:off + 64 * BLOCK],
        valid[off:off + 64 * BLOCK], spec, caps, k, tau, base_index=off,
        block_size=BLOCK))

    # K3 at the main path's shape: stream blocks against the final centers
    k3_lines = [
        _check_precheck(x_norm[b * BLOCK:(b + 1) * BLOCK], st_a.centers,
                        st_a.cvalid, f"songs-sim block {b}, final centers")
        for b in np.linspace(0, blocks - 2, 8).astype(int)
    ]

    # the streaming solve, with launch counts read around it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ops.reset_launches()
    sol = solve_dmmc(points, k, spec, cats=cats, caps=caps, tau=tau,
                     setting="streaming", metric="cosine", variant="sum",
                     engine="host", device="cuda")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    solve_peak = (points.numel() * points.element_size()
                  + torch.cuda.max_memory_allocated() - before)
    snap = snapshot_coreset(st_a)
    check(np.array_equal(sol.coreset_indices,
                         snap.src_idx[snap.valid].cpu().numpy()),
          "streaming solve's coreset is not the scan's snapshot")
    check(launches["center_precheck"] >= blocks,
          f"K3 launched {launches['center_precheck']} < {blocks} times")
    check(launches["pairwise_sqdist"] >= 1, "K1 was not launched")
    check(launches["gmm_update"] == 0, "K2 launched on the streaming path")
    check(len(sol.indices) == k, f"{len(sol.indices)} points selected, k={k}")
    check(PartitionMatroid(cats[:, 0], caps).is_independent(
        list(sol.indices)), "solution violates the partition matroid")
    check(np.isfinite(sol.diversity) and sol.diversity > 0,
          f"diversity {sol.diversity}")
    rows = x_norm.index_select(
        0, torch.as_tensor(sol.coreset_indices, device="cuda"))
    k1_err = _check_pdist_at(rows, "the streaming coreset")
    fs_idx, _ = _final_solve(x_norm, cats, spec, caps, k,
                             sol.coreset_indices, "sum", force="ref")
    check(np.array_equal(np.sort(fs_idx), np.sort(sol.indices)),
          "final stage on the plain pdist selects other indices")
    emit(dict(
        phase="stream", n=n, dim=d, k=k, tau=tau, block_size=BLOCK,
        variant="radius", stream_s=stream_s, points_per_s=n / stream_s,
        plain_batched_stream_s=plain_stream_s,
        per_point_prefix_s=per_point_s, prefix=PREFIX,
        scan_counts=counts_a, pass_launches=launches_a,
        centers=int(st_a.cvalid.sum()), R=float(st_a.R),
        coreset_s=sol.timings["coreset_s"], solver_s=sol.timings["solver_s"],
        total_s=sol.timings["total_s"], coreset_size=sol.coreset_size,
        diversity=sol.diversity, solve_peak_device_bytes=solve_peak,
        launches=launches, pdist_max_abs_err_at_coreset=k1_err,
        profiled_window_64_blocks=window, k3_main_path=k3_lines,
    ))
    return dict(st=st_a, launches=launches,
                k3_err=max(line["max_abs_err"] for line in k3_lines))


def _time_precheck(x_norm, st) -> dict:
    """K3 and its plain version on a block of the stream against the scan's
    final center buffer, (128, 65, 5000) on the main path."""
    from repro_torch.kernels import ops, precheck, ref

    xb = x_norm[:BLOCK]
    c, cv = st.centers, st.cvalid
    B, d = xb.shape
    T = c.shape[0]
    b, by = bound_ms((B * d + T * d) * 4 + T + 5 * B * 4,
                     2 * B * T * d + 2 * (B + T) * d + 6 * B * T)
    def kernel():
        return precheck.center_precheck_stats(xb, c, cv)

    def launches20():
        for _ in range(20):
            kernel()

    prof = device_profile(launches20)
    return dict(
        kernel_ms=time_ms(kernel),
        plain_ms=time_ms(lambda: ref.center_precheck_matmul(xb, c, cv)),
        op_with_margin_ms=time_ms(lambda: ops.center_precheck(xb, c, cv)),
        device_ms_per_launch=(None if prof["device_ms"] is None
                              else prof["device_ms"] / 20),
        profile_20_launches=prof,
        library_ms=None, bound_ms=b, bound_by=by, shape=[B, T, d],
    )


def _time_pdist(rows, what: str) -> dict:
    """K1, its plain version and the library call on (m, d) rows against
    themselves, as ``coreset_distance_matrix`` calls it."""
    import torch
    from repro_torch.kernels import ops, ref

    m, d = rows.shape

    def library():
        xn = torch.sum(rows * rows, dim=1)
        return torch.addmm(xn[:, None] + xn[None, :], rows, rows.T,
                           alpha=-2.0)

    err = _check_pdist_at(rows, what)
    b, by = bound_ms(2 * m * d * 4 + m * m * 4,
                     2 * m * m * d + 4 * m * d + 4 * m * m)
    return dict(
        max_abs_err=err,
        kernel_ms=time_ms(lambda: ops.pairwise_sqdist(rows, rows)),
        plain_ms=time_ms(lambda: ref.pairwise_sqdist(rows, rows)),
        library_ms=time_ms(library), bound_ms=b, bound_by=by,
        shape=[m, m, d],
    )


def phase_timing(x_norm, sol, m_slice: int, st) -> dict:
    import torch
    from repro_torch.core import geometry
    from repro_torch.core.gmm import gmm
    from repro_torch.kernels import ops, ref

    # K1 on the main path's own input, the coreset rows of the solve, and
    # at the largest coreset a partition EXTRACT can keep (k * tau rows)
    k1 = _time_pdist(x_norm.index_select(
        0, torch.as_tensor(sol.coreset_indices, device="cuda")),
        "the solve's coreset")
    k1_k_tau = _time_pdist(x_norm[:m_slice].contiguous(), "k*tau rows")
    # K2 on the main path's input: all points, a center, running minima
    n, d = x_norm.shape
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    z = x_norm[int(sol.info["centers"][1])]
    md = ops.gmm_update(x_norm, x_norm[0],
                        torch.full((n,), torch.inf, device="cuda"), valid)[0]
    k2_b, k2_by = bound_ms(n * d * 4 + d * 4 + n * 4 + n + n * 4,
                           3 * n * d + 3 * n)
    k2 = dict(
        kernel_ms=time_ms(lambda: ops.gmm_update(x_norm, z, md, valid)),
        plain_ms=time_ms(lambda: ref.gmm_update(x_norm, z, md, valid)),
        library_ms=None, bound_ms=k2_b, bound_by=k2_by, shape=[n, d],
    )
    # the solve's GMM stage alone (tau launches of K2 and the loop's small
    # ops), and its set-up (the cosine normalisation of the points)
    tau = len(sol.info["centers"])
    loop = dict(
        gmm_loop_ms=time_ms(lambda: gmm(x_norm, valid, tau), warmup=1,
                            reps=5),
        normalize_ms=time_ms(
            lambda: geometry.normalize_for_metric(x_norm, "cosine"),
            warmup=1, reps=5),
        tau=tau,
    )
    # K3 on a block of the stream against the scan's final centers
    k3 = _time_precheck(x_norm, st)
    emit(dict(phase="timing", pdist=k1, pdist_k_tau=k1_k_tau, gmm_step=k2,
              gmm=loop, center_precheck=k3))
    return dict(pdist=k1, gmm_step=k2, center_precheck=k3)


def _check_flash(q, k, v, causal: bool, what: str) -> dict:
    """K4 against its plain version: o within 1e-4 for f32 inputs and 1e-2
    of the largest |o| for bf16 (a bf16 rounding or two), lse within
    1e-4 (both compute in f32)."""
    import torch
    from repro_torch.kernels import ops

    o, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    o_r, lse_r = ops.flash_attention_fwd(q, k, v, causal=causal,
                                         force="ref")
    torch.cuda.synchronize()
    err = float((o.float() - o_r.float()).abs().max())
    lse_err = float((lse - lse_r).abs().max())
    if q.dtype == torch.float32:
        tol = 1e-4
        ok = bool(torch.allclose(o, o_r, rtol=tol, atol=tol))
    else:
        tol = 1e-2 * float(o_r.float().abs().max())
        ok = bool(torch.allclose(o.float(), o_r.float(), rtol=1e-2,
                                 atol=tol))
    ok = ok and bool(torch.allclose(lse, lse_r, rtol=1e-4, atol=1e-4))
    line = dict(kernel="flash_attention_fwd", what=what,
                shape=[q.shape[0], q.shape[1], k.shape[1], q.shape[2]],
                causal=causal, dtype=str(q.dtype), max_abs_err=err,
                lse_max_abs_err=lse_err, tol=tol, ok=ok)
    check(ok, f"flash {what} {line['shape']} {q.dtype}: max abs err {err}, "
              f"lse {lse_err}")
    return line


def _check_ssd(xbar, loga, B, C, what: str) -> dict:
    """K6 against its plain version: y and state within 2e-4 of the
    largest |y| (|state|), the tolerance of the reference's SSD tests."""
    import torch
    from repro_torch.kernels import ops

    y, s, _, _ = ops.ssd_intra_chunk(xbar, loga, B, C)
    y_r, s_r, _, _ = ops.ssd_intra_chunk(xbar, loga, B, C, force="ref")
    torch.cuda.synchronize()
    errs, oks = [], []
    for got, want in ((y, y_r), (s, s_r)):
        scale = max(1.0, float(want.abs().max()))
        errs.append(float((got - want).abs().max()))
        oks.append(bool(torch.allclose(got, want, rtol=2e-4,
                                       atol=2e-4 * scale)))
    line = dict(kernel="ssd_intra_chunk", what=what,
                shape=[*xbar.shape[:-2], *xbar.shape[-2:], B.shape[-1]],
                b_c_shape=list(B.shape),
                max_abs_err=errs[0], state_max_abs_err=errs[1],
                tol_rel_to_max=2e-4, ok=all(oks))
    check(all(oks), f"ssd {what} {line['shape']}: max abs err y {errs[0]}, "
                    f"state {errs[1]}")
    return line


class _Capture:
    """Keeps a copy of the inputs of the first call of each named ``ops``
    function while it is entered (the model looks the op up on ``ops`` at
    every call); the calls themselves go on as usual."""

    NAMES = ("flash_attention_fwd", "flash_attention_bwd", "ssd_intra_chunk")

    def __enter__(self):
        from repro_torch.kernels import ops

        self.ops, self.orig, self.args = ops, {}, {}
        for name in self.NAMES:
            self.orig[name] = fn = getattr(ops, name)
            setattr(ops, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def call(*args, **kw):
            if name not in self.args:
                self.args[name] = ([a.clone() for a in args], kw)
            return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


def _first_divergence(tok, tok_r, lg, lg_r, d0: float) -> tuple:
    """Per request: the first step whose greedy token differs between the
    kernel and plain paths. Each must be a near-tie: the plain path's
    top-2 gap at most twice the larger of the prefill's logit difference
    d0 and that step's own. Returns (first step or None, rows equal)."""
    import torch

    first, equal = None, 0
    for b in range(tok.shape[0]):
        diff = (tok[b] != tok_r[b]).nonzero()
        if diff.numel() == 0:
            equal += 1
            continue
        t = int(diff[0])
        top2 = torch.topk(lg_r[b, t].float(), 2).values
        gap = float(top2[0] - top2[1])
        d = max(d0, float((lg[b, t].float() - lg_r[b, t].float()).abs().max()))
        check(gap <= 2 * d, f"request {b}: greedy token differs at step {t} "
                            f"with top-2 gap {gap} > 2 x {d}")
        first = t if first is None else min(first, t)
    return first, equal


def _time_flash(q, k, v, heads: int = LM_HEADS) -> dict:
    """K4, its plain version and SDPA at the captured (BH, S, hd) inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash, ref

    bh, s, hd = q.shape
    q4, k4, v4 = (t.view(bh // heads, heads, s, hd) for t in (q, k, v))
    esz = q.element_size()
    nbytes = 4 * bh * s * hd * esz + bh * s * 4
    flops = 4 * hd * bh * s * (s + 1) // 2  # causal: q.k and p.v, k <= q
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    b, by = bound_ms(nbytes, flops, peak)
    res = dict(
        kernel_ms=time_ms(lambda: flash.flash_attention_fwd(q, k, v, True)),
        route=flash.last_route["fwd"],
        plain_ms=time_ms(lambda: ref.flash_attention_fwd(q, k, v, True),
                         warmup=1, reps=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)),
        bound_ms=b, bound_by=by, bytes=nbytes, flops=flops,
        shape=[bh, s, hd], dtype=str(q.dtype))
    return _rates(res)


def _rates(res: dict) -> dict:
    """Adds achieved TFLOP/s (the function's FLOP over the kernel's time)
    and the kernel's time over the library call's."""
    res["tflop_per_s"] = res["flops"] / res["kernel_ms"] / 1e9
    res["kernel_over_library"] = res["kernel_ms"] / res["library_ms"]
    return res


def _time_ssd(xbar, loga, B, C) -> dict:
    """K6 and its plain version at the captured inputs (one layer's cells:
    batch * chunk by head, B and C shared by the heads)."""
    from repro_torch.kernels import ref, ssd

    *lead, q, p = xbar.shape
    n = B.shape[-1]
    cells = lead[0] * lead[1]
    tri = q * (q + 1) // 2
    # causal C B^T and (C B^T * L) xbar, the decay mask, the state product
    flops = cells * (tri * (2 * n + 2 * p + 1) + 2 * q * n * p)
    nbytes = 4 * (2 * cells * q * p + cells * q + cells * n * p
                  + 2 * lead[0] * q * n)  # B, C: one copy per (b, chunk)
    b, by = bound_ms(nbytes, flops, FP32_FLOPS_PER_S)
    return dict(
        kernel_ms=time_ms(lambda: ssd.ssd_intra_chunk(xbar, loga, B, C)),
        plain_ms=time_ms(lambda: ref.ssd_intra_chunk(xbar, loga, B, C),
                         warmup=1, reps=5),
        library_ms=None,
        library_note="no single PyTorch call computes the decay-masked "
                     "C B^T product and the chunk state",
        bound_ms=b, bound_by=by, bytes=nbytes, flops=flops,
        shape=[lead[0], lead[1], q, p, n])


def _blockwise_prefill(lm, params, prompts, g) -> dict:
    """The prefill of ``prompts`` block by block on the plain path. Each
    block also runs on the kernel path from the same input: its output
    must agree within LM_LOGIT_TOL of the largest |x|, and the logits
    from the last block's kernel output within LM_LOGIT_TOL of the largest
    |logit|. Beside it, the plain path from an embedding nudged by one
    bf16 step on 1e-4 of its entries: the difference that the model's own
    bf16 sensitivity makes, the noise floor of an end-to-end comparison.
    Returns the last position's plain and nudged logits and the errors."""
    import torch
    from repro_torch.models.model import block_apply_full

    B, S = prompts.shape
    x = params["embed"][prompts]
    hit = torch.rand(x.shape, generator=g, device=x.device) < 1e-4
    xn = torch.where(hit, (x.float() * (1 + 2**-7)).to(x.dtype), x)
    ctx_k = lm.context(params, B, S)
    ctx_r = lm.context(params, B, S, force="ref")
    worst, worst_at = 0.0, None
    for si, i, kind, p in lm.blocks(params):
        yk, _ = block_apply_full(kind, p, x, ctx_k, want_cache=False)
        x, _ = block_apply_full(kind, p, x, ctx_r, want_cache=False)
        xn, _ = block_apply_full(kind, p, xn, ctx_r, want_cache=False)
        err = float((yk.float() - x.float()).abs().max()
                    / x.float().abs().max())
        if err > worst:
            worst, worst_at = err, f"seg{si}[{i}] {kind}"
    lg_k, lg_r, lg_n = (lm.head(params, h[:, -1:])[:, 0].float()
                        for h in (yk, x, xn))
    scale = float(lg_r.abs().max())
    lg_err = float((lg_k - lg_r).abs().max()) / scale
    check(worst <= LM_LOGIT_TOL, f"a block's kernel path is off by {worst} "
                                 f"of max|x| at {worst_at}")
    check(lg_err <= LM_LOGIT_TOL, f"logits from the last block's kernel "
                                  f"output off by {lg_err} of max|logit|")
    return dict(plain=lg_r, nudged=lg_n, block_max_rel_err=worst,
                block_max_rel_err_at=worst_at,
                last_block_logit_max_rel_err=lg_err)


def _f32_prefill(lm, params, prompts) -> dict:
    """The same prefill with the weights upcast to f32 (no bf16 rounding
    between the layers), on the kernel path and on the plain path: the
    last position's logits must agree within LM_LOGIT_TOL of the largest
    |logit|."""
    import dataclasses

    import torch
    from repro_torch.models import LM
    from repro_torch.models.model import tree_map

    lm32 = LM(dataclasses.replace(lm.cfg, dtype="float32"))
    p32 = tree_map(lambda t: t.float(), params)
    t0 = time.perf_counter()
    lg = lm32.prefill(p32, prompts)[0]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    lg_r = lm32.prefill(p32, prompts, force="ref")[0]
    del p32
    torch.cuda.empty_cache()
    d = float((lg - lg_r).abs().max())
    scale = float(lg_r.abs().max())
    check(d <= LM_LOGIT_TOL * scale, f"f32 prefill logits differ by {d} > "
                                     f"{LM_LOGIT_TOL} x {scale}")
    return dict(logit_max_abs_diff=d, logit_max_abs=scale,
                logit_max_rel_diff=d / scale, prefill_s=prefill_s)


def phase_lm(seed: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import MatroidSpec, solve_dmmc
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves
    from repro_torch.serve.engine import Engine

    cfg = get_config(LM_ARCH)
    lm = LM(cfg)
    max_len = LM_PROMPT + LM_STEPS
    t0 = time.perf_counter()
    params = lm.init(seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=g,
                            device="cuda")

    # (a) kernel checks: test shapes, then one layer's own inputs
    lines = []
    for bh, sq, skv, hd, causal in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(bh, s, hd, generator=g, device="cuda")
                       .to(dtype) for s in (sq, skv, skv))
            lines.append(_check_flash(q, k, v, causal, "test shape"))
    for gg, q, p, n in SSD_SHAPES:
        xb = torch.randn(gg, q, p, generator=g, device="cuda")
        la = -(torch.rand(gg, q, generator=g, device="cuda") * 0.39 + 0.01)
        Bm, Cm = (torch.randn(gg, q, n, generator=g, device="cuda")
                  for _ in range(2))
        lines.append(_check_ssd(xb, la, Bm, Cm, "test shape"))
    with _Capture() as cap:  # also the warm-up of the serving run
        lm.prefill(params, prompts, cache_len=max_len)
    torch.cuda.synchronize()
    fa, fkw = cap.args["flash_attention_fwd"]
    sa, _ = cap.args["ssd_intra_chunk"]
    lines.append(_check_flash(*fa, fkw["causal"], "first attention layer"))
    lines.append(_check_ssd(*sa, "first Mamba2 layer"))
    emit(dict(phase="lm_kernels", checks=lines))

    # (b) serving: the kernel path, then the plain path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    eng = Engine(lm, params, max_len)
    tok, lg = eng.generate(prompts, LM_STEPS, return_logits=True)
    torch.cuda.synchronize()
    serve_launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    timings = dict(eng.timings)
    supers = lm.plan[0][1]
    check(serve_launches["flash_attention_fwd"] == supers,
          f"K4 launched {serve_launches['flash_attention_fwd']} times in "
          f"generate, expected {supers}")
    check(serve_launches["ssd_intra_chunk"] == cfg.n_layers,
          f"K6 launched {serve_launches['ssd_intra_chunk']} times in "
          f"generate, expected {cfg.n_layers}")
    check(tok.shape == (LM_BATCH, LM_STEPS) and bool(torch.isfinite(lg).all()),
          "generate gave tokens of another shape or non-finite logits")
    eng_r = Engine(lm, params, max_len, force="ref")
    tok_r, lg_r = eng_r.generate(prompts, LM_STEPS, return_logits=True)
    torch.cuda.synchronize()
    check(ops.launch_counts() == serve_launches,
          "the plain path launched a kernel")
    d0 = float((lg[:, 0].float() - lg_r[:, 0].float()).abs().max())
    scale = float(lg_r[:, 0].float().abs().max())
    bw = _blockwise_prefill(lm, params, prompts, g)
    d_loop = float((bw["plain"] - lg_r[:, 0].float()).abs().max())
    d_nudge = float((bw["nudged"] - bw["plain"]).abs().max())
    # end to end: within the tolerance, or within twice the difference
    # that one bf16 step on 1e-4 of the embedding makes on the plain path
    check(d0 <= max(LM_LOGIT_TOL * scale, 2 * d_nudge),
          f"prefill logits differ by {d0}: over {LM_LOGIT_TOL} x {scale} "
          f"and over twice the plain path's noise floor {d_nudge}")
    first, rows_equal = _first_divergence(tok, tok_r, lg, lg_r, d0)
    f32 = _f32_prefill(lm, params, prompts)
    dec_steps = timings["decode_steps"]
    emit(dict(
        phase="lm_serve", arch=LM_ARCH, batch=LM_BATCH, prompt=LM_PROMPT,
        new_tokens=LM_STEPS, max_len=max_len, dtype=cfg.dtype,
        params=lm.param_count(), param_bytes=param_bytes, init_s=init_s,
        prefill_s=timings["prefill_s"],
        prompt_tokens_per_s=LM_BATCH * LM_PROMPT / timings["prefill_s"],
        decode_ms_per_token=timings["decode_s"] / dec_steps * 1e3,
        decode_tokens_per_s=LM_BATCH * dec_steps / timings["decode_s"],
        peak_device_bytes=peak, launches=serve_launches,
        plain=dict(prefill_s=eng_r.timings["prefill_s"],
                   decode_ms_per_token=eng_r.timings["decode_s"]
                   / dec_steps * 1e3),
        prefill_logit_max_abs_diff=d0, prefill_logit_max_abs=scale,
        prefill_logit_max_rel_diff=d0 / scale,
        nudged_plain_logit_max_abs_diff=d_nudge,
        blockwise_plain_vs_engine_plain_max_abs_diff=d_loop,
        blockwise=dict((k, v) for k, v in bw.items()
                       if k not in ("plain", "nudged")),
        f32_prefill=f32,
        requests_with_equal_tokens=rows_equal,
        first_divergent_step=first,
    ))
    del lg, lg_r, eng, eng_r

    # (c) the diverse selection of examples/serving_diverse.py
    torch.cuda.synchronize()
    ops.reset_launches()
    seqs = torch.cat([prompts, tok.long()], dim=1)
    t0 = time.perf_counter()
    hidden, _, _ = lm.forward(params, seqs)
    emb = hidden.mean(dim=1, dtype=torch.float32)
    del hidden
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    intents = (np.arange(LM_BATCH) % LM_INTENTS).astype(np.int32)[:, None]
    caps = np.full(LM_INTENTS, LM_CAP, np.int32)
    spec = MatroidSpec("partition", num_categories=LM_INTENTS, gamma=1)
    sol = solve_dmmc(emb, LM_K, spec, cats=intents, caps=caps, tau=LM_TAU,
                     setting="sequential", metric="cosine", device="cuda")
    torch.cuda.synchronize()
    select_launches = ops.launch_counts()
    check(bool(torch.isfinite(emb).all()) and emb.shape == (
        LM_BATCH, cfg.vocab_padded), "embeddings of another shape or "
                                     "non-finite")
    check(select_launches["flash_attention_fwd"] == supers
          and select_launches["ssd_intra_chunk"] == cfg.n_layers,
          f"embedding forward launched {select_launches}")
    check(select_launches["gmm_update"] == LM_TAU
          and select_launches["pairwise_sqdist"] >= 1,
          f"selection launched {select_launches}")
    counts = np.bincount(intents[sol.indices, 0], minlength=LM_INTENTS)
    check(len(sol.indices) == LM_K and counts.max() <= LM_CAP,
          f"selection {sol.indices} breaks the caps ({counts})")
    check(np.isfinite(sol.diversity) and sol.diversity > 0,
          f"diversity {sol.diversity}")
    ref_sol = solve_dmmc(emb, LM_K, spec, cats=intents, caps=caps,
                         tau=LM_TAU, setting="sequential", metric="cosine",
                         force="ref", device="cuda")
    emit(dict(phase="lm_select", embed_forward_s=embed_s,
              seq_len=seqs.shape[1], selected=sorted(sol.indices.tolist()),
              intent_counts=counts.tolist(), diversity=sol.diversity,
              solve_s=sol.timings["total_s"], launches=select_launches,
              plain_selected=sorted(ref_sol.indices.tolist()),
              same_selection_as_plain=bool(np.array_equal(
                  np.sort(sol.indices), np.sort(ref_sol.indices)))))

    # (d) where a prefill's and a decode step's time goes (profiled), and
    # K4 and K6 at the slice's inputs
    del emb, seqs
    _, caches = lm.prefill(params, prompts, cache_len=max_len)
    prof_prefill = device_profile(
        lambda: lm.prefill(params, prompts, cache_len=max_len))
    prof_decode = device_profile(
        lambda: lm.decode_step(params, tok[:, :1], caches, LM_PROMPT))
    del caches
    k4 = _time_flash(*fa)
    k6 = _time_ssd(*sa)
    emit(dict(phase="lm_timing", profiled_prefill=prof_prefill,
              profiled_decode_step=prof_decode, flash_attention_fwd=k4,
              ssd_intra_chunk=k6))
    lm_launches = {name: serve_launches[name] + select_launches[name]
                   for name in serve_launches}
    return dict(launches=lm_launches, k4=k4, k6=k6,
                k4_err=lines[-2]["max_abs_err"], k6_err=lines[-1]["max_abs_err"])


def _check_flash_bwd(q, k, v, o, lse, do, causal: bool, what: str) -> dict:
    """K5 against its plain version: dq, dk and dv within 1e-4 (f32) or
    1e-2 (bf16: a rounding or two of the output) of each gradient's
    largest |value| (a model's gradients are ~1e-7 and smaller)."""
    import torch
    from repro_torch.kernels import ops

    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   force="ref")
    torch.cuda.synchronize()
    tol = 1e-4 if q.dtype == torch.float32 else 1e-2
    errs, rels, ok = [], [], True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        scale = float(w.abs().max())
        errs.append(float((g - w).abs().max()))
        rels.append(errs[-1] / scale if scale else errs[-1])
        ok = ok and rels[-1] <= tol
    line = dict(kernel="flash_attention_bwd", what=what,
                shape=[q.shape[0], q.shape[1], k.shape[1], q.shape[2]],
                causal=causal, dtype=str(q.dtype), max_abs_err=max(errs),
                dq_dk_dv_max_abs_err=errs, dq_dk_dv_err_rel_to_max=rels,
                tol_rel_to_max=tol, ok=ok)
    check(ok, f"flash bwd {what} {line['shape']} {q.dtype}: errors {rels} "
              f"of the largest |gradient|")
    return line


def _fresh_state(params, opt_cfg):
    import torch
    from repro_torch.models.model import tree_map
    from repro_torch.train import adamw_init

    p = tree_map(lambda t: t.detach().clone(), params)
    return {"params": p, "opt": adamw_init(p, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device="cuda")}


def _clone_state(state):
    from repro_torch.models.model import tree_map

    return tree_map(lambda t: t.clone(), state)


def _run_steps(lm, params, batches, opt_cfg, force=None) -> list:
    """The slice's steps from a copy of ``params`` on ``batches``; the
    per-step losses."""
    from repro_torch.train import make_train_step

    state = _fresh_state(params, opt_cfg)
    step = make_train_step(lm, opt_cfg, force=force)
    losses = []
    for b in batches:
        state, m = step(state, {"tokens": b})
        losses.append(m["loss"])
    return [float(x) for x in losses]


def _state_diff(a, b) -> tuple[float, list]:
    """Largest |a - b| over the leaves of two states, and the paths of the
    leaves that differ."""
    from repro_torch.train.checkpoint import _paths

    worst, paths = 0.0, []
    for (key, x), (_, y) in zip(_paths(a), _paths(b)):
        if not bool((x == y).all()):
            paths.append(key)
            worst = max(worst, float((x.float() - y.float()).abs().max()))
    return worst, paths


def _train_f32_check(lm, params, tokens) -> dict:
    """The config in f32 (weights upcast): the loss and every gradient leaf
    of one step on the kernel path against the plain path."""
    import dataclasses

    import torch
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves, tree_map

    lm32 = LM(dataclasses.replace(lm.cfg, dtype="float32"))
    out = {}
    for force in (None, "ref"):
        p32 = tree_map(lambda t: t.detach().float().requires_grad_(True),
                       params)
        loss, _ = lm32.loss(p32, tokens, force=force)
        grads = torch.autograd.grad(loss, tree_leaves(p32))
        out[force] = (float(loss.detach()), grads)
        del p32, loss
    (lk, gk), (lr, gr) = out[None], out["ref"]
    loss_rel = abs(lk - lr) / abs(lr)
    grad_rel = max(float((a - b).norm() / (b.norm() + 1e-30))
                   for a, b in zip(gk, gr))
    del out, gk, gr
    torch.cuda.empty_cache()
    check(loss_rel <= TRAIN_F32_LOSS_TOL,
          f"f32 step-0 loss differs by {loss_rel} relative")
    check(grad_rel <= TRAIN_F32_GRAD_TOL,
          f"an f32 gradient leaf differs by {grad_rel} relative L2")
    return dict(loss=lk, loss_plain=lr, loss_rel_diff=loss_rel,
                grad_max_rel_l2_diff=grad_rel)


def _train_cli(seed: int, exact: bool, spread: float) -> dict:
    """``launch.train.main`` in process: an uninterrupted run of
    TRAIN_CLI_STEPS steps; the same run sent SIGTERM after step
    TRAIN_PREEMPT_AT (it must checkpoint and return); the same command
    again, which must resume there. Its losses and final checkpoint must
    equal the uninterrupted run's bit for bit (or within ``spread`` where
    a repeated step was not bit-identical)."""
    import os
    import shutil
    import signal

    import numpy as np
    from repro_torch.launch import train as launch_train
    from repro_torch.train import CheckpointManager

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_CLI_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--ckpt-every", "100", "--log-every", "1", "--seed", str(seed)]

    def preempt(step: int) -> None:
        if step == TRAIN_PREEMPT_AT:
            os.kill(os.getpid(), signal.SIGTERM)

    t0 = time.perf_counter()
    full = launch_train.main(argv + ["--ckpt-dir", str(root / "a")])
    full_s = time.perf_counter() - t0
    first = launch_train.main(argv + ["--ckpt-dir", str(root / "b")],
                              after_step=preempt)
    saved = CheckpointManager(str(root / "b")).all_steps()
    check(saved == [TRAIN_PREEMPT_AT] and len(first) == TRAIN_PREEMPT_AT,
          f"preempted run: checkpoints {saved}, {len(first)} steps")
    rest = launch_train.main(argv + ["--ckpt-dir", str(root / "b")])
    check(len(rest) == TRAIN_CLI_STEPS - TRAIN_PREEMPT_AT,
          f"resumed run took {len(rest)} steps")
    loss_diff = max(abs(a - b) for a, b in zip(first + rest, full))
    arr_diff = 0.0
    final = f"step_{TRAIN_CLI_STEPS:010d}/arrays.npz"
    with np.load(root / "a" / final) as za, np.load(root / "b" / final) as zb:
        check(sorted(za.files) == sorted(zb.files), "checkpoint keys differ")
        for key in za.files:
            a, b = za[key], zb[key]
            if a.dtype == np.uint16:  # bf16 bits
                a, b = (x.astype(np.uint32) << 16 for x in (a, b))
                a, b = a.view(np.float32), b.view(np.float32)
            arr_diff = max(arr_diff, float(np.max(np.abs(
                a.astype(np.float64) - b.astype(np.float64)), initial=0.0)))
    shutil.rmtree(root, ignore_errors=True)
    if exact:
        check(loss_diff == 0.0 and arr_diff == 0.0,
              f"resumed run differs from the uninterrupted one: losses by "
              f"{loss_diff}, checkpoint by {arr_diff}")
    else:
        check(arr_diff <= spread, f"resumed run's checkpoint differs by "
                                  f"{arr_diff} > the repeat spread {spread}")
    check(all(np.isfinite(full)), f"non-finite CLI losses {full}")
    return dict(steps=TRAIN_CLI_STEPS, preempted_at=TRAIN_PREEMPT_AT,
                losses=full, resumed_losses=rest,
                loss_max_abs_diff=loss_diff,
                checkpoint_max_abs_diff=arr_diff,
                uninterrupted_run_s=full_s)


def _time_flash_bwd(q, k, v, o, lse, do, heads: int) -> dict:
    """K5, its plain version and the backward alone of SDPA at one layer's
    captured (BH, S, hd) inputs, causal."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash, ref

    bh, s, hd = q.shape
    esz = q.element_size()
    # q, k, v, o, do read and dq, dk, dv written once, lse read
    nbytes = 8 * bh * s * hd * esz + bh * s * 4
    # S, dP, dv, dq, dk: five products over the causal pairs
    flops = 5 * 2 * hd * bh * s * (s + 1) // 2
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    b, by = bound_ms(nbytes, flops, peak)
    q4, k4, v4 = (t.view(bh // heads, heads, s, hd).detach()
                  .requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.view(bh // heads, heads, s, hd)
    res = dict(
        kernel_ms=time_ms(lambda: flash.flash_attention_bwd(
            q, k, v, o, lse, do, True)),
        route=flash.last_route["bwd"],
        plain_ms=time_ms(lambda: ref.flash_attention_bwd(
            q, k, v, o, lse, do, True), warmup=1, reps=5),
        library_ms=time_ms(lambda: torch.autograd.grad(
            out, (q4, k4, v4), do4, retain_graph=True)),
        library_note="the backward alone of scaled_dot_product_attention("
                     "is_causal=True): autograd.grad after one forward",
        bound_ms=b, bound_by=by, bytes=nbytes, flops=flops,
        shape=[bh, s, hd], dtype=str(q.dtype))
    del out
    return _rates(res)


def phase_train(seed: int) -> dict:
    import statistics as st

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.models.model import tree_leaves, tree_map
    from repro_torch.train import AdamWConfig, make_train_step

    cfg = get_config(TRAIN_ARCH)
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init(seed, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the driver's optimizer rule (launch/train.py) for a run of this length
    opt_cfg = AdamWConfig(total_steps=TRAIN_STEPS,
                          warmup_steps=min(100, TRAIN_STEPS // 10 + 1))
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 2)

    # (a) K5 at test shapes, then at one layer's own inputs, captured from a
    # backward of the slice (the last layer's, the first in the backward)
    lines = []
    for bh, sq, skv, hd, causal in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(bh, n, hd, generator=g, device="cuda")
                       .to(dtype) for n in (sq, skv, skv))
            o, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                             force="ref")
            do = torch.randn(bh, sq, hd, generator=g, device="cuda").to(dtype)
            lines.append(_check_flash_bwd(q, k, v, o, lse, do, causal,
                                          "test shape"))
    pipe = Pipeline(data_cfg)
    warm = pipe.batch_at(0)["tokens"]
    with _Capture() as cap:  # also the warm-up of the training run
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = lm.loss(live, warm)
        torch.autograd.grad(loss, tree_leaves(live))
        del live, loss
    torch.cuda.synchronize()
    fa, fkw = cap.args["flash_attention_fwd"]
    ba, bkw = cap.args["flash_attention_bwd"]
    lines.append(_check_flash_bwd(*ba, bkw["causal"],
                                  "a layer's backward (the last layer)"))
    k5_err = lines[-1]["max_abs_err"]
    lines.append(_check_flash(*fa, fkw["causal"],
                              "a training layer's forward (the first)"))
    emit(dict(phase="train_kernels", checks=lines))

    # (b) five steps on the kernel path, launch counts read around them
    # (the data selection included), then the same batches on the plain path
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    state = _fresh_state(params, opt_cfg)
    step = make_train_step(lm, opt_cfg)
    picked, losses = [], []
    for i in range(TRAIN_STEPS):
        picked.append(pipe.batch_at(i))
        state, m = step(state, {"tokens": picked[-1]["tokens"]})
        losses.append(m["loss"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    run_peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    tau = data_cfg.selector_tau
    want = dict(gmm_update=TRAIN_STEPS * tau,
                flash_attention_fwd=TRAIN_STEPS * 2 * cfg.n_layers,
                flash_attention_bwd=TRAIN_STEPS * cfg.n_layers,
                pairwise_sqdist=0, center_precheck=0, ssd_intra_chunk=0)
    check(launches == want, f"train launches {launches}, expected {want}")
    check(all(map(math.isfinite, losses)), f"non-finite losses {losses}")
    # the selection on plain GMM picks the same sequences (K2 at the
    # pipeline's own shape)
    pipe_r = Pipeline(data_cfg, force="ref")
    for i, b in enumerate(picked):
        b_r = pipe_r.batch_at(i)
        check(torch.equal(b["tokens"], b_r["tokens"])
              and torch.equal(b["domains"], b_r["domains"]),
              f"step {i}: the batch differs from the plain selection's")
    batches = [b["tokens"] for b in picked]
    losses_r = _run_steps(lm, params, batches, opt_cfg, force="ref")
    check(ops.launch_counts() == launches, "the plain path launched a kernel")
    hit = torch.rand(params["embed"].shape, generator=g, device="cuda") < 1e-4
    nudged = dict(params, embed=torch.where(
        hit, (params["embed"].float() * (1 + 2**-7)).to(torch.bfloat16),
        params["embed"]))
    losses_n = _run_steps(lm, nudged, batches, opt_cfg, force="ref")
    del nudged, hit
    # bf16: step 0 differs only by the forward's roundings, and within
    # twice what the nudge moves; each later step adds one step's rounding
    # differences (Adam's normalised update turns them into lr-sized
    # moves), so step i may differ by 2 (i + 1) times the largest nudge
    # difference so far
    diffs = [abs(a - b) for a, b in zip(losses, losses_r)]
    floors = [abs(a - b) for a, b in zip(losses_n, losses_r)]
    limits = [2 * (i + 1) * max(floors[:i + 1]) for i in range(len(diffs))]
    for i, (d, lim) in enumerate(zip(diffs, limits)):
        check(d <= lim, f"step {i}: kernel and plain losses differ by {d}, "
                        f"over 2 x {i + 1} x the nudge's {lim / 2 / (i + 1)}")
    # a repeated step from one state: is the step deterministic?
    s1, s2 = _clone_state(state), _clone_state(state)
    s1, m1 = step(s1, {"tokens": batches[0]})
    s2, m2 = step(s2, {"tokens": batches[0]})
    spread, differing = _state_diff(s1, s2)
    exact = not differing and float(m1["loss"]) == float(m2["loss"])
    del s1, s2
    f32 = _train_f32_check(lm, params, batches[0])
    emit(dict(phase="train_steps", arch=TRAIN_ARCH, batch=TRAIN_BATCH,
              seq=TRAIN_SEQ, steps=TRAIN_STEPS, params=lm.param_count(),
              init_s=init_s, run_s=run_s, launches=launches,
              run_peak_device_bytes=run_peak, losses=losses,
              plain_losses=losses_r, nudged_plain_losses=losses_n,
              loss_abs_diffs=diffs, nudge_abs_diffs=floors,
              loss_abs_diff_limits=limits, same_batches_as_plain=True,
              repeat_step_bit_identical=exact,
              repeat_step_max_abs_diff=spread,
              repeat_step_differing_leaves=differing, f32=f32))

    # (c) the CLI: preempted, resumed, equal to the uninterrupted run
    cli = _train_cli(seed, exact, spread)
    emit(dict(phase="train_cli", **cli))

    # (d) where a step's time goes: step time (selection included), peak
    # memory, one step under the profiler, K5 (and K4) at the slice's inputs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_times, data_times = [], []
    for i in range(TRAIN_STEPS, TRAIN_STEPS + 3):
        t0 = time.perf_counter()
        tok = pipe.batch_at(i)["tokens"]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, {"tokens": tok})
        float(m["loss"])
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        data_times.append(t1 - t0)
    peak = torch.cuda.max_memory_allocated()
    step_s = st.median(step_times)
    prof = device_profile(lambda: step(state, {"tokens": pipe.batch_at(
        TRAIN_STEPS + 3)["tokens"]}))
    heads = cfg.n_heads
    k5 = _time_flash_bwd(*ba, heads)
    k4 = _time_flash(*fa, heads=heads)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit(dict(phase="train_timing", step_s=step_s, step_times_s=step_times,
              data_select_s=st.median(data_times),
              tokens_per_s=tokens / step_s, peak_device_bytes=peak,
              profiled_step=prof, flash_attention_bwd=k5,
              flash_attention_fwd_train_shape=k4))
    del state, params
    torch.cuda.empty_cache()
    return dict(launches=launches, k5=k5, k5_err=k5_err)



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=22, help="rank/4, as in Fig. 1")
    ap.add_argument("--tau", type=int, default=64)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # fails without the repository beside it
    from repro_torch.device import disable_tf32

    disable_tf32()
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    points, x_norm, cats, caps, spec = phase_data(args.seed)
    k2_err = phase_kernels(x_norm, args.k * args.tau, args.seed)
    sol, launches = phase_solve(points, x_norm, cats, caps, spec, args.k,
                                args.tau)
    stream = phase_stream(points, x_norm, cats, caps, spec, args.k, args.tau)
    times = phase_timing(x_norm, sol, args.k * args.tau, stream["st"])
    del points, x_norm, cats, stream["st"]
    torch.cuda.empty_cache()
    lm = phase_lm(args.seed)
    torch.cuda.empty_cache()  # the zamba2 weights went with phase_lm
    train = phase_train(args.seed)

    # launches: the sum over the three main paths, each read around its own
    # run (per path beside it)
    per_path = {name: dict(sequential=launches[name],
                           streaming=stream["launches"][name],
                           lm=lm["launches"][name],
                           train=train["launches"][name])
                for name in launches}
    total = {name: sum(v.values()) for name, v in per_path.items()}
    for name, n in total.items():
        check(n >= 1, f"{name} was launched on no main path")
    csrc = "src/repro_torch/kernels"
    k3 = times["center_precheck"]
    table = [
        dict(name="pairwise_sqdist", route="cuda",
             source=f"{csrc}/csrc/pdist.cu",
             replaces="src/repro/kernels/pdist.py:50",
             launches=total["pairwise_sqdist"],
             launches_per_path=per_path["pairwise_sqdist"],
             max_abs_err=times["pdist"]["max_abs_err"],
             ms=times["pdist"]["kernel_ms"],
             plain_ms=times["pdist"]["plain_ms"],
             bound_ms=times["pdist"]["bound_ms"],
             bound_by=times["pdist"]["bound_by"],
             library_ms=times["pdist"]["library_ms"]),
        dict(name="gmm_update", route="triton", source=f"{csrc}/gmm_step.py",
             replaces="src/repro/kernels/gmm_step.py:44",
             launches=total["gmm_update"],
             launches_per_path=per_path["gmm_update"],
             max_abs_err=k2_err,
             ms=times["gmm_step"]["kernel_ms"],
             plain_ms=times["gmm_step"]["plain_ms"],
             bound_ms=times["gmm_step"]["bound_ms"],
             bound_by=times["gmm_step"]["bound_by"], library_ms=None),
        dict(name="center_precheck", route="cuda",
             source=f"{csrc}/csrc/precheck.cu",
             replaces="src/repro/kernels/precheck.py:92",
             launches=total["center_precheck"],
             launches_per_path=per_path["center_precheck"],
             max_abs_err=stream["k3_err"], ms=k3["kernel_ms"],
             plain_ms=k3["plain_ms"], bound_ms=k3["bound_ms"],
             bound_by=k3["bound_by"], library_ms=None),
        dict(name="flash_attention_fwd", route="cuda",
             source=f"{csrc}/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash.py:75",
             launches=total["flash_attention_fwd"],
             launches_per_path=per_path["flash_attention_fwd"],
             max_abs_err=lm["k4_err"], ms=lm["k4"]["kernel_ms"],
             plain_ms=lm["k4"]["plain_ms"], bound_ms=lm["k4"]["bound_ms"],
             bound_by=lm["k4"]["bound_by"],
             library_ms=lm["k4"]["library_ms"]),
        dict(name="flash_attention_bwd", route="cuda",
             source=f"{csrc}/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash.py:219",
             launches=total["flash_attention_bwd"],
             launches_per_path=per_path["flash_attention_bwd"],
             max_abs_err=train["k5_err"], ms=train["k5"]["kernel_ms"],
             plain_ms=train["k5"]["plain_ms"],
             bound_ms=train["k5"]["bound_ms"],
             bound_by=train["k5"]["bound_by"],
             library_ms=train["k5"]["library_ms"]),
        dict(name="ssd_intra_chunk", route="cuda",
             source=f"{csrc}/csrc/ssd.cu",
             replaces="src/repro/kernels/ssd.py:53",
             launches=total["ssd_intra_chunk"],
             launches_per_path=per_path["ssd_intra_chunk"],
             max_abs_err=lm["k6_err"], ms=lm["k6"]["kernel_ms"],
             plain_ms=lm["k6"]["plain_ms"], bound_ms=lm["k6"]["bound_ms"],
             bound_by=lm["k6"]["bound_by"], library_ms=None),
    ]
    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
