"""Build and load the CUDA C++ kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch_kernels/`` at the checkout's root, and is loaded with
``ctypes``. A library's file name carries a hash of its source, of the
headers in ``csrc/`` (``*.cuh``, which a source may include) and of the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. A failed build raises; nothing falls back to another path. There
is no Pallas-compat layer to port: ``repro/kernels/compat.py`` only papers
over Pallas API drift.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # source name -> nvcc/ptxas output


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
            "the CUDA kernels are built from source at first use"
        )
    return nvcc


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (builds on first use)."""
    if name in _libs:
        return _libs[name]
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise RuntimeError(f"no CUDA source csrc/{name}.cu")
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        BUILD_LOG[src.name] = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(
                f"CUDA kernel build failed: {src.name}: nvcc exited "
                f"{proc.returncode}\n{proc.stdout}"
            )
        os.replace(tmp, out)
    _libs[name] = ctypes.CDLL(str(out))
    return _libs[name]
