"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use with `nvcc -shared` for sm_90a into `<repo>/build/`, named by a hash of
its source (and the shared header) so an edited source is rebuilt. All
missing libraries are compiled in parallel, one nvcc process per source.
Nothing here runs at import time: the CPU tests import every module.

    python -m tiny_llm_tpu_torch.kernels.build [CSRC_DIR]

compiles every source of CSRC_DIR (default: the package's) with the same
flags into a scratch directory and prints each kernel's registers, spill
bytes, a digest of its SASS (`cuobjdump -sass`) and its count of
tensor-core instructions as JSON, so two trees' kernels can be compared:
equal digests, the same machine code.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("quant_matmul", "fused_decode_attention", "flash_attention", "paged_attention",
           "moe_matmul", "quant_matmul_sg", "moe_matmul_sg", "flash_attention_masked", "axpby")
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


def ptxas_registers(ptxas: str) -> dict[str, dict[str, int]]:
    """Each kernel's registers and spill-store bytes from nvcc's
    `-Xptxas -v` output, keyed by its mangled name without the per-file
    hash of the anonymous namespace (so two builds of a kernel compare)."""
    out: dict[str, dict[str, int]] = {}
    fn = None
    for ln in ptxas.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = _kernel_name(m.group(1))
            out[fn] = {"registers": -1, "spill_bytes": 0}
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and fn:
            out[fn]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def _kernel_name(mangled: str) -> str:
    return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", mangled)


def sass_report(so: Path) -> dict[str, dict]:
    """Each kernel's SASS in a shared library, keyed as `ptxas_registers`
    keys it: `sass`, its text hashed (sha256, 16 hex digits);
    `tensor_core_ops`, its count of tensor-core instructions (HMMA, from
    bf16 mma.sync; HGMMA, from wgmma; IMMA, from int8 mma.sync), which
    shows from the machine code where a product runs on the tensor cores;
    `hgmma` and `imma`, the HGMMA and IMMA among them. Runs of whitespace
    count as one space in the hash: cuobjdump pads its columns to the
    widest instruction in the whole library, so a kernel added to a source
    would otherwise change the digests of the others."""
    r = subprocess.run([str(Path(_nvcc()).with_name("cuobjdump")), "-sass", str(so)],
                       capture_output=True, text=True, check=True)
    bodies: dict[str, list[str]] = {}
    body = None
    for ln in r.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            body = bodies.setdefault(_kernel_name(m.group(1)), [])
        elif body is not None:
            body.append(" ".join(ln.split()))
    return {fn: {"sass": hashlib.sha256("\n".join(b).encode()).hexdigest()[:16],
                 "tensor_core_ops": sum(bool(re.search(r"\b(HG?MMA|IMMA)\.", ln)) for ln in b),
                 "hgmma": sum(bool(re.search(r"\bHGMMA\.", ln)) for ln in b),
                 "imma": sum(bool(re.search(r"\bIMMA\.", ln)) for ln in b)}
            for fn, b in bodies.items()}


def main(argv: list[str]) -> int:
    csrc = Path(argv[0]) if argv else CSRC
    nvcc = _nvcc()
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {src: subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(csrc), "-o",
                                        str(Path(tmp) / f"{src.stem}.so"), str(src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
                 for src in sorted(csrc.glob("*.cu"))}  # one nvcc per source, in parallel
        for src, p in procs.items():
            out, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
            report[src.stem] = ptxas_registers(out)
            for fn, info in sass_report(Path(tmp) / f"{src.stem}.so").items():
                report[src.stem].setdefault(fn, {}).update(info)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
