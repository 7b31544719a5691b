"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use with `nvcc -shared` for sm_90a into `<repo>/build/`, named by a hash of
its source (and the shared header) so an edited source is rebuilt. All
missing libraries are compiled in parallel, one nvcc process per source.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("quant_matmul", "fused_decode_attention", "flash_attention", "paged_attention",
           "moe_matmul")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": float, "ptxas": str} for the libraries this process built.
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> dict[str, dict]:
    """Compile every library in `names` that is not built yet, in parallel.

    Returns BUILD_LOG. Raises with nvcc's output if any compile fails."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return BUILD_LOG
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {p.returncode}) ---\n{out}")
            continue
        os.replace(tmp, _target(n))
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "ptxas": out}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building all missing ones first."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        lib.tlt_errstr.restype = ctypes.c_char_p
        lib.tlt_errstr.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.tlt_errstr(err).decode()})")
