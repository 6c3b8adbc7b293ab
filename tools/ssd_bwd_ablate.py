#!/usr/bin/env python3
"""Split K6b's time (``csrc/ssd_bwd.cu``) between the parts of its cell
kernel, on one NVIDIA GPU.

    python3 tools/ssd_bwd_ablate.py [--shape 64,80,256,128] [--seed 0]

Builds copies of ``csrc/ssd_bwd.cu``, each with one part of the cell
kernel (``ssd_bwd_cells``) taken out, and times each beside the unedited
source at one layer's shape in the model's layout (batch * chunks, heads,
q, n; p = 64; B and C shared by the heads; inputs from ``--seed``): the
products (no ``wgmma`` issued), the hi / lo splits of a tile, the decays
(the ``exp`` of L), the L2 operand reads (the G^T tile, B's columns and
the slice sum read back), and those reads with the slice-sum stores. A
copy that leaves out a part computes wrong gradients: only its time
means anything. After two seconds of the unedited source (the card's
clocks settle), the copies run in the order listed, then in reverse, three
rounds, in one process on one card; each time is the median of 20
CUDA-event timings after 3 warm-ups. Prints one JSON line: the card
(``nvidia-smi`` name and power limit), the shape, the cell kernel's
registers, and per copy its times and the median of the unedited source's
less its own.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke  # noqa: E402

CELLS = "ssd_bwd_cells(Args a)"
# (name, [(text in the cell kernel, its replacement), ...])
PARTS = [
    ("products", [("if (k < nk) mma3", "if (k < 0) mma3")]),
    ("splits", [("split_k(yraw, XLD, PMAX, khi, klo, tid);\n"
                 "        split_t(yraw, XLD, thi, tlo, tid);", "")]),
    ("decays", [("ok ? expf(ct[e & 1] - cum_s[h]) : 0.f",
                 "ok ? (ct[e & 1] - cum_s[h]) : 0.f")]),
    ("l2_reads", [("load_acc(g, gtiles + tri(i, j) * TILE_FLOATS, tid);",
                   "for (int e = 0; e < 32; ++e) g[e] = 0.5f;"),
                  ("if (c > 0) load_acc(old, sum_tile, tid);",
                   "for (int e = 0; e < 32; ++e) old[e] = 0.25f;")]),
    ("l2_reads_and_sums", [
        ("load_acc(g, gtiles + tri(i, j) * TILE_FLOATS, tid);",
         "for (int e = 0; e < 32; ++e) g[e] = 0.5f;"),
        ("if (c > 0) load_acc(old, sum_tile, tid);",
         "for (int e = 0; e < 32; ++e) old[e] = 0.25f;"),
        ("store_acc(sum_tile, acc, tid);",
         "if (acc[0] == 1234.5f) store_acc(sum_tile, acc, tid);")]),
]


def edited(src: str, edits) -> str:
    """``src`` with each edit made once, inside the cell kernel (or, for
    the products, in the shared issue helper)."""
    for old, new in edits:
        start = 0 if "mma3" in old else src.index(CELLS)
        i = src.index(old, start)
        src = src[:i] + new + src[i + len(old):]
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="64,80,256,128",
                    help="batch * chunks, heads, q, n (p = 64)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_ablate: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.device import disable_tf32
    from repro_torch.kernels import _build, ssd_bwd

    disable_tf32()
    bc, heads, q, n = map(int, args.shape.split(","))
    out_dir = ROOT / "build" / "ssd_bwd_ablate"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    for header in csrc.glob("*.cuh"):
        (out_dir / header.name).write_bytes(header.read_bytes())
    src = (csrc / "ssd_bwd.cu").read_text()
    sources = {"unedited": src}
    sources.update((name, edited(src, edits)) for name, edits in PARTS)
    procs = {}
    for name, text in sources.items():
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(out_dir / f"lib{name}.so"), str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, registers = {}, None
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        if name == "unedited":
            lines = log.splitlines()
            at = next(i for i, ln in enumerate(lines)
                      if "Compiling entry" in ln and "ssd_bwd_cells" in ln)
            registers = next(ln.strip() for ln in lines[at:]
                             if "registers" in ln)

    g = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    p = 64
    decays = -(torch.rand(bc, q, heads, generator=g, device="cuda") * 0.39
               + 0.01)
    inputs = (randn(bc, q, heads, p).permute(0, 2, 1, 3),
              decays.permute(0, 2, 1), randn(bc, 1, q, n),
              randn(bc, 1, q, n), randn(bc, q, heads, p).permute(0, 2, 1, 3),
              randn(bc, heads, n, p))
    _build._libs["ssd_bwd"] = libs["unedited"]
    t_end = time.perf_counter() + 2.0
    while time.perf_counter() < t_end:
        ssd_bwd.ssd_intra_chunk_bwd(*inputs)
        torch.cuda.synchronize()
    times = {name: [] for name in libs}
    order = list(libs)
    for names in (order, order[::-1], order):
        for name in names:
            _build._libs["ssd_bwd"] = libs[name]
            times[name].append(chip_smoke.time_ms(
                lambda: ssd_bwd.ssd_intra_chunk_bwd(*inputs)))
    base = statistics.median(times["unedited"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps(dict(
        card=card.strip(), shape=[bc, heads, q, p, n],
        cell_kernel_ptxas=registers,
        ms={name: t for name, t in times.items()},
        ms_saved={name: base - statistics.median(t)
                  for name, t in times.items() if name != "unedited"})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
