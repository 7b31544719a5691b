"""axpby, the port's tutorial kernel: out = alpha * x + beta * y.

Counterpart of tiny_llm_tpu/kernels/axpby.py, the JAX package's "hello,
Pallas" op; the CUDA kernel, csrc/axpby.cu, replaces its `_axpby_kernel`.
Every kernel of this package has the shape this file and that source show,
so read them first:

  1. csrc/axpby.cu holds the kernel, its launcher and a plain C entry point
     (`tlt_axpby`); its header says what each is for.
  2. kernels/build.py compiles each csrc/<name>.cu with `nvcc -shared` for
     sm_90a into build/ on first use (nothing is built at import time) and
     loads it with ctypes (`build.load("axpby")`).
  3. This module holds the three Python pieces beside it: the plain PyTorch
     version (`axpby_plain`: the same function, the CPU path and the oracle
     the kernel is held against), the CUDA launcher (`axpby_cuda`: checks
     device, dtype, shape and layout, allocates the output, passes
     data_ptr()s and the current stream, raises on a non-zero error code,
     counts the launch in LAUNCHES), and the wrapper (`axpby`).
  4. The wrapper picks by the tensor (kernels/dispatch.py): a CUDA tensor
     launches the kernel, a CPU tensor runs the plain version, impl="torch"
     asks for the plain version on either device, and impl="cuda" on a CPU
     tensor raises. Nothing falls back.

Rounding points are the JAX expression's, `alpha * x + beta * y` in x's
dtype: alpha and beta round to it, each product rounds to it, then the sum.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .dispatch import resolve

TPU_KERNEL = "tiny_llm_tpu/kernels/axpby.py:38 _axpby_kernel"
SOURCE = "tiny_llm_tpu_torch/csrc/axpby.cu"
DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the C entry point's dtype codes

LAUNCHES = 0  # kernel launches since the last reset (see kernels.reset_launches)


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.ndim != 2 or x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError(f"axpby takes two 2-D tensors of one shape and dtype, got "
                         f"{tuple(x.shape)} {x.dtype} and {tuple(y.shape)} {y.dtype}")


def axpby_plain(x: torch.Tensor, y: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """alpha * x + beta * y, each step rounded to x's dtype."""
    _check(x, y)
    a = torch.tensor(alpha, dtype=x.dtype).item()  # the scalars in x's dtype
    b = torch.tensor(beta, dtype=x.dtype).item()
    f = torch.float32
    return ((a * x.to(f)).to(x.dtype).to(f) + (b * y.to(f)).to(x.dtype).to(f)).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("axpby")
    fn = lib.tlt_axpby
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int] + [ctypes.c_float] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous at a 16-byte aligned address (the kernel's 16-byte loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def axpby_cuda(x: torch.Tensor, y: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    global LAUNCHES
    _check(x, y)
    if not (x.is_cuda and y.device == x.device) or x.dtype not in DTYPES:
        raise ValueError(f"axpby_cuda takes bf16 or f32 tensors on one CUDA device, got "
                         f"{x.dtype} on {x.device}, {y.device}")
    x, y = _aligned(x), _aligned(y)
    out = torch.empty_like(x)
    a = torch.tensor(alpha, dtype=x.dtype).item()
    b = torch.tensor(beta, dtype=x.dtype).item()
    lib = _lib()
    err = lib.tlt_axpby(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), DTYPES[x.dtype],
                        a, b, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "axpby")
    LAUNCHES += 1
    return out


def axpby(
    x: torch.Tensor,
    y: torch.Tensor,
    alpha: float = 1.0,
    beta: float = 1.0,
    impl: str | None = None,
) -> torch.Tensor:
    """out = alpha * x + beta * y for 2-D x and y of one shape and dtype."""
    fn = axpby_cuda if resolve(impl, x) == "cuda" else axpby_plain
    return fn(x, y, float(alpha), float(beta))
