"""K1: W4A16 group-128 dequant-fused matmul (+ fused residual).

Replaces tiny_llm_tpu/kernels/quant_matmul.py::_magic_kernel (wrapper
`_qmm_magic_pallas`, reached through `quantized_matmul`). The CUDA kernel
is csrc/quant_matmul.cu; its header notes what bounds it on the H100 and
how its two schedules (a warp-per-row GEMV for M <= 32, a tensor-core
tiled kernel above) deal with that.

`quant_matmul` launches the kernel for CUDA tensors and runs the plain
version, `quant_matmul_plain`, for CPU tensors (or when impl="torch").
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.quantize import QuantizedTensor, dequantize
from . import build
from .dispatch import resolve

TPU_KERNEL = "tiny_llm_tpu/kernels/quant_matmul.py:154 _magic_kernel"
SOURCE = "tiny_llm_tpu_torch/csrc/quant_matmul.cu"

LAUNCHES = 0  # kernel launches since the last reset (see kernels.reset_launches)


def quant_matmul_plain(
    x: torch.Tensor, qt: QuantizedTensor, residual: torch.Tensor | None = None
) -> torch.Tensor:
    """f32 dequant (q*s + b) matmul, + residual in f32, rounded to bf16."""
    out = torch.matmul(x.to(torch.float32), dequantize(qt, torch.float32).T)
    if residual is not None:
        out = out + residual.to(torch.float32)
    return out.to(torch.bfloat16)


def _lib() -> ctypes.CDLL:
    lib = build.load("quant_matmul")
    fn = lib.tlt_quant_matmul
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def quant_matmul_cuda(
    x: torch.Tensor, qt: QuantizedTensor, residual: torch.Tensor | None = None
) -> torch.Tensor:
    """Launch the CUDA kernel. x [M, K] bf16 CUDA; returns [M, N] bf16."""
    global LAUNCHES
    M, K = x.shape
    N = qt.out_features
    if x.dtype != torch.bfloat16 or not x.is_cuda or qt.packed.device != x.device:
        raise ValueError("quant_matmul_cuda needs bf16 x and weights on one CUDA device")
    if qt.group_size != 128 or qt.bits != 4:
        raise ValueError("quant_matmul_cuda is W4 g128 only")
    if K != qt.k_padded:
        x = torch.nn.functional.pad(x, (0, qt.k_padded - K))
    x = x.contiguous()
    for t in (qt.packed, qt.scales, qt.biases):
        if not t.is_contiguous():
            raise ValueError("quantized weight tensors must be contiguous")
    if residual is not None:
        residual = residual.to(torch.bfloat16).contiguous()
        if residual.shape != (M, N) or residual.device != x.device:
            raise ValueError(f"residual {tuple(residual.shape)} != ({M}, {N})")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.tlt_quant_matmul(
        x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.biases.data_ptr(),
        residual.data_ptr() if residual is not None else None, out.data_ptr(),
        M, N, qt.k_padded, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, "quant_matmul")
    LAUNCHES += 1
    return out


def quant_matmul(
    x: torch.Tensor,
    qt: QuantizedTensor,
    residual: torch.Tensor | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """y = x @ dequant(qt).T (+ residual). x [..., in_features] -> [..., N] bf16."""
    if x.shape[-1] != qt.in_features:
        raise ValueError(f"x K={x.shape[-1]} vs weight K={qt.in_features}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, qt.in_features)
    r2 = None if residual is None else residual.reshape(-1, qt.out_features)
    if resolve(impl, x) == "cuda":
        out = quant_matmul_cuda(x2.to(torch.bfloat16), qt, r2)
    else:
        out = quant_matmul_plain(x2, qt, r2)
    return out.reshape(*lead, qt.out_features)
