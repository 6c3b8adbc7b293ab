#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--k 22] [--tau 64]

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. ``device``  the card's name and power limit (``nvidia-smi``).
2. ``build``   nvcc builds the CUDA kernels from ``src/repro_torch/kernels/
               csrc`` and Triton compiles the GMM step, with their seconds.
3. ``data``    songs-sim at the paper's Songs widths (n = 237,698,
               dim = 5000, 16 genres, rank ~89), generated on the card.
4. ``kernels`` every kernel against its plain PyTorch version on the card,
               at test shapes and at the main path's shapes.
5. ``solve``   the main path: ``solve_dmmc(setting="sequential",
               metric="cosine", variant="sum", engine="host")`` with launch
               counts set to 0 before and read after. K1 is held to its
               plain version at the solve's coreset rows, and the final
               stage on the plain pdist must select the same points. Then
               the same solve on the plain versions (``force="ref"``) must
               give the same centres, coreset and selection (or a GMM tie,
               printed), and the same value with the diagonal out.
6. ``timing``  each kernel, its plain version and (K1) a library call, at
               the inputs the main path gave it, with the least time the
               card could take for the same work; the GMM loop alone.

The last two lines are the kernel table and ``{"ok": true, "device": ...}``.
Without a CUDA device, or without the repository beside it, it fails.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

PDIST_SHAPES = [(8, 8, 4), (33, 17, 7), (128, 64, 32), (200, 300, 25),
                (5, 1000, 3)]
GMM_SHAPES = [(16, 4), (100, 25), (1025, 7), (64, 128)]
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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    import torch
    from repro_torch.kernels import _build, ops

    t0 = time.perf_counter()
    _build.library("pdist")
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = torch.randn(100, 25, device="cuda")
    ops.gmm_update(x, x[0], torch.full((100,), torch.inf, device="cuda"),
                   torch.ones(100, dtype=torch.bool, device="cuda"))
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.BUILD_LOG.values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", nvcc_s=nvcc_s, triton_first_compile_s=triton_s,
              ptxas=ptxas))


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


def phase_kernels(x_norm, m_slice: int, seed: int) -> float:
    """Each kernel against its plain version; returns K2's max abs error at
    the main path's shape."""
    import torch
    from repro_torch.kernels import ops

    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    lines, k2_err = [], None
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


def phase_timing(x_norm, sol, m_slice: int) -> dict:
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
    emit(dict(phase="timing", pdist=k1, pdist_k_tau=k1_k_tau, gmm_step=k2,
              gmm=loop))
    return dict(pdist=k1, gmm_step=k2)


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
    times = phase_timing(x_norm, sol, args.k * args.tau)

    csrc = "src/repro_torch/kernels"
    table = [
        dict(name="pairwise_sqdist", route="cuda",
             source=f"{csrc}/csrc/pdist.cu",
             replaces="src/repro/kernels/pdist.py:50",
             launches=launches["pairwise_sqdist"],
             max_abs_err=times["pdist"]["max_abs_err"],
             ms=times["pdist"]["kernel_ms"],
             plain_ms=times["pdist"]["plain_ms"],
             bound_ms=times["pdist"]["bound_ms"],
             bound_by=times["pdist"]["bound_by"],
             library_ms=times["pdist"]["library_ms"]),
        dict(name="gmm_update", route="triton", source=f"{csrc}/gmm_step.py",
             replaces="src/repro/kernels/gmm_step.py:44",
             launches=launches["gmm_update"],
             max_abs_err=k2_err,
             ms=times["gmm_step"]["kernel_ms"],
             plain_ms=times["gmm_step"]["plain_ms"],
             bound_ms=times["gmm_step"]["bound_ms"],
             bound_by=times["gmm_step"]["bound_by"], library_ms=None),
    ]
    emit(dict(phase="done", seconds=time.perf_counter() - t_start))
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
