"""Native (C++) runtime components, loaded with ctypes — counterpart of
tiny_llm_tpu/native.

`load_library(name)` builds tiny_llm_tpu_torch/csrc/<name>.cpp with g++
into the port's build directory at first use (a flat C ABI and ctypes, no
pybind11) and raises if it cannot; `native_available` says whether that
works here. `NativePageIndex` is the page pool's bookkeeping in C++
(kv/paged.py PagePool uses it by default)."""

from .build import load_library, native_available
from .page_allocator import NativePageIndex

__all__ = ["load_library", "native_available", "NativePageIndex"]
