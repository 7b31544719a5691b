"""Build and load the port's C++ runtime libraries (g++ -> shared library
-> ctypes): counterpart of tiny_llm_tpu/native/build.py.

`csrc/<name>.cpp` is compiled on first use with `g++ -O2 -std=c++17
-shared -fPIC` into the port's build directory (kernels/build.py
BUILD_DIR, which .gitignore lists), named by a hash of its source, so an
edited source is rebuilt. A failed build raises: a caller that wants the
Python bookkeeping asks for it (PagePool(native=False)); nothing falls
back on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

from ..kernels.build import BUILD_DIR, CSRC

_loaded: dict[str, ctypes.CDLL] = {}


def _target(name: str):
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def load_library(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cpp if needed and load it; raises RuntimeError
    with the compiler's output when the build fails."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cpp"
    if not src.exists():
        raise RuntimeError(f"no native source {src}")
    so = _target(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(src), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"building {src.name} failed: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {src.name} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    _loaded[name] = ctypes.CDLL(str(so))
    return _loaded[name]


def native_available(name: str = "page_allocator") -> bool:
    """Whether csrc/<name>.cpp builds and loads here."""
    try:
        load_library(name)
    except (RuntimeError, OSError):
        return False
    return True
