"""Grouped W4A16 group-128 expert matmul (the MoE layers' expert projections).

Replaces tiny_llm_tpu/kernels/moe_matmul.py::_gqmm_magic_kernel (wrapper
`_gqmm_magic_pallas`, reached through `grouped_quantized_matmul`). The
CUDA kernel is csrc/moe_matmul.cu; its header notes what bounds it on the
H100 and how its two schedules (K1's GEMV per expert for T <= 64 rows, a
walk over tensor-core tiles of 64 rows of one expert above) deal with that.

`grouped_quant_matmul` launches the kernel for CUDA tensors and runs the
plain version, `grouped_quant_matmul_plain`, for CPU tensors (or when
impl="torch"). The kernel never reads `group_sizes` on the host; the plain
version does.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.quantize import QuantizedTensor
from . import build
from .dispatch import resolve
from .quant_matmul import quant_matmul_plain

TPU_KERNEL = "tiny_llm_tpu/kernels/moe_matmul.py:120 _gqmm_magic_kernel"
SOURCE = "tiny_llm_tpu_torch/csrc/moe_matmul.cu"

LAUNCHES = 0  # kernel launches since the last reset (see kernels.reset_launches)


def grouped_quant_matmul_plain(
    x: torch.Tensor, qt: QuantizedTensor, group_sizes: torch.Tensor
) -> torch.Tensor:
    """Per non-empty expert segment, K1's plain version (f32 dequant matmul,
    bf16 out) on that expert's weight."""
    ends = torch.cumsum(group_sizes, 0).tolist()
    if ends[-1] != x.shape[0]:
        raise ValueError(f"group sizes sum to {ends[-1]}, x has {x.shape[0]} rows")
    out = torch.empty((x.shape[0], qt.out_features), dtype=torch.bfloat16, device=x.device)
    start = 0
    for e, end in enumerate(ends):
        if end > start:
            out[start:end] = quant_matmul_plain(x[start:end], qt.expert(e))
        start = end
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("moe_matmul")
    fn = lib.tlt_grouped_quant_matmul
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def grouped_quant_matmul_cuda(
    x: torch.Tensor, qt: QuantizedTensor, group_sizes: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel. x [T, K] bf16 CUDA, rows sorted by expert;
    group_sizes int32 [E] on the same device, summing to T. Returns
    [T, N] bf16."""
    global LAUNCHES
    T, K = x.shape
    E, N = qt.num_experts, qt.out_features
    if x.dtype != torch.bfloat16 or not x.is_cuda or qt.packed.device != x.device:
        raise ValueError("grouped_quant_matmul_cuda needs bf16 x and weights on one CUDA device")
    if qt.group_size != 128 or qt.bits != 4:
        raise ValueError("grouped_quant_matmul_cuda is W4 g128 only")
    if group_sizes.dtype != torch.int32 or group_sizes.shape != (E,) \
            or group_sizes.device != x.device:
        raise ValueError(f"group_sizes must be int32 [{E}] on {x.device}")
    if K != qt.k_padded:
        x = torch.nn.functional.pad(x, (0, qt.k_padded - K))
    x = x.contiguous()
    for t in (qt.packed, qt.scales, qt.biases, group_sizes):
        if not t.is_contiguous():
            raise ValueError("weight tensors and group_sizes must be contiguous")
    out = torch.empty((T, N), dtype=torch.bfloat16, device=x.device)
    lib = _lib()
    err = lib.tlt_grouped_quant_matmul(
        x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.biases.data_ptr(),
        group_sizes.data_ptr(), out.data_ptr(), T, N, qt.k_padded, E,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, "grouped_quant_matmul")
    LAUNCHES += 1
    return out


def grouped_quant_matmul(
    x: torch.Tensor,
    qt: QuantizedTensor,
    group_sizes: torch.Tensor,
    impl: str | None = None,
) -> torch.Tensor:
    """out[t] = x[t] @ dequant(qt[e(t)]).T for rows x [T, in_features] sorted
    by expert, expert e owning group_sizes[e] consecutive rows. -> [T, N] bf16."""
    if qt.num_experts is None:
        raise ValueError("grouped_quant_matmul needs stacked expert weights [E, N, K]")
    if x.ndim != 2 or x.shape[-1] != qt.in_features:
        raise ValueError(f"x {tuple(x.shape)} vs expert weight K={qt.in_features}")
    if resolve(impl, x) == "cuda":
        return grouped_quant_matmul_cuda(x.to(torch.bfloat16), qt, group_sizes)
    return grouped_quant_matmul_plain(x, qt, group_sizes)
