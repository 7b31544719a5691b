"""Grouped (MoE expert) quantized matmuls: W4A16 group 128, W4A8, and any
width.

  * The W4A16 kernel replaces tiny_llm_tpu/kernels/moe_matmul.py::
    _gqmm_magic_kernel (wrapper `_gqmm_magic_pallas`); CUDA in
    csrc/moe_matmul.cu, whose header notes what bounds it on the H100 and
    how its two routes deal with that: K1's GEMV per expert below
    B16_MIN_T rows (a decode step), above them a walk of K1's bf16
    tensor-core tile over (expert, row-block) tiles. Both compute the plain
    version's f32 fold, so one plain version serves both.
  * The W4A8 kernel replaces `_gqmm_pair_kernel` (wrapper
    `_gqmm_pair_pallas`): act="int8" experts (W4 g128) at T <= 128 grouped
    rows, per-row int8 activations and integer dots; csrc/moe_matmul.cu
    (`tlt_grouped_quant_matmul_a8`): a GEMV per expert at few rows, above
    them a quantize kernel and a walk of int8 tensor-core tiles, which read
    a workspace this wrapper allocates at the size the entry asks for. Above
    128 rows the JAX package runs W4A16-exact dots, and so does the port:
    the W4A16 kernel.
  * The any-width kernel replaces `_gqmm_kernel` (wrapper `_gqmm_pallas`):
    experts other than W4 g128; csrc/moe_matmul_sg.cu
    (`tlt_grouped_quant_matmul_sg`): below SG_B16_MIN_T rows a GEMV walk of
    its own over (expert, column block) units, above them the W4A16
    kernel's bf16 tile walk at the experts' width. Both compute the plain
    version's f32 fold.
  * `_gqmm_gather_kernel` (wrapper `_gqmm_gather_pallas`), the JAX
    package's expert-gather schedule of the W4A16 function for T <= 256
    rows (TLT_MOE_DECODE=gather), is covered by the W4A16 kernel: the same
    function, which the W4A16 kernel's tile walk runs at those rows. The
    port reads no TLT_MOE_DECODE: on the card it would pick the same
    kernel.

`grouped_quant_matmul` dispatches as the JAX package's
`grouped_quantized_matmul` does and launches the chosen kernel for CUDA
tensors; for CPU tensors (or when impl="torch") it runs the plain version:
per non-empty expert segment, the dense kernels' plain versions
(kernels/quant_matmul.py). The kernels never read `group_sizes` on the
host; the plain versions do.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.quantize import QuantizedTensor
from . import build
from .dispatch import resolve
from .quant_matmul import (a8_workspace, a8_workspace_args, quant_matmul_a8_plain,
                           quant_matmul_plain)

TPU_KERNEL = "tiny_llm_tpu/kernels/moe_matmul.py:120 _gqmm_magic_kernel"
TPU_KERNEL_A8 = "tiny_llm_tpu/kernels/moe_matmul.py:173 _gqmm_pair_kernel"
TPU_KERNEL_SG = "tiny_llm_tpu/kernels/moe_matmul.py:74 _gqmm_kernel"
TPU_KERNEL_GATHER = "tiny_llm_tpu/kernels/moe_matmul.py:533 _gqmm_gather_kernel"
COVERED_GATHER = "covered by tlt_grouped_quant_matmul (the W4A16 kernel, the same function)"
SOURCE = "tiny_llm_tpu_torch/csrc/moe_matmul.cu"  # the W4A16 and W4A8 kernels
SOURCE_SG = "tiny_llm_tpu_torch/csrc/moe_matmul_sg.cu"
A8_MAX_ROWS = 128  # the JAX pair walk's a8 gate (T <= 128)

# Kernel launches since the last reset (see kernels.reset_launches).
LAUNCHES = 0  # W4A16
A8_LAUNCHES = 0
SG_LAUNCHES = 0


def _per_expert(plain, x, qt, group_sizes, partial=False):
    """`partial`: the groups may cover fewer rows than x has; the rows past
    them belong to no expert and give 0 here (the kernels leave them
    unspecified; ops/moe.py's expert shards zero them)."""
    ends = torch.cumsum(group_sizes, 0).tolist()
    if ends[-1] > x.shape[0] or (not partial and ends[-1] != x.shape[0]):
        raise ValueError(f"group sizes sum to {ends[-1]}, x has {x.shape[0]} rows")
    out = torch.zeros((x.shape[0], qt.out_features), dtype=torch.bfloat16, device=x.device)
    start = 0
    for e, end in enumerate(ends):
        if end > start:
            out[start:end] = plain(x[start:end], qt.expert(e))
        start = end
    return out


def grouped_quant_matmul_plain(
    x: torch.Tensor, qt: QuantizedTensor, group_sizes: torch.Tensor, partial: bool = False
) -> torch.Tensor:
    """Per non-empty expert segment, K1's plain version (f32 dequant matmul
    at the weight's own width, bf16 out) on that expert's weight: the
    W4A16 and any-width kernels' plain version."""
    return _per_expert(quant_matmul_plain, x, qt, group_sizes, partial)


def grouped_quant_matmul_a8_plain(
    x: torch.Tensor, qt: QuantizedTensor, group_sizes: torch.Tensor, partial: bool = False
) -> torch.Tensor:
    """Per non-empty expert segment, the W4A8 plain version (per-row int8
    activations, so segment by segment is the same as all rows at once)."""
    return _per_expert(quant_matmul_a8_plain, x, qt, group_sizes, partial)


def w4a16_route(rows: int) -> str:
    """The route the W4A16 kernel's C entry takes for `rows` grouped rows
    ("gemv" or "b16"), as B16_MIN_T in csrc/moe_matmul.cu sets it (CUDA
    only: it loads the library)."""
    fn = build.load("moe_matmul").tlt_grouped_quant_matmul_route
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return ("gemv", "b16")[fn(rows)]


def sg_route(rows: int) -> str:
    """The route the any-width kernel's C entry takes for `rows` grouped
    rows ("gemv" or "b16"), as SG_B16_MIN_T in csrc/moe_matmul_sg.cu sets
    it (CUDA only: it loads the library)."""
    fn = build.load("moe_matmul_sg").tlt_grouped_quant_matmul_sg_route
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return ("gemv", "b16")[fn(rows)]


def _launch(fn_name, x, qt, group_sizes, extra=()):
    """Check the operands and launch `fn_name`: x [T, K] bf16 CUDA, rows
    sorted by expert; group_sizes int32 [E] on the same device, summing to
    T, or to at most T (the rows past them are left unwritten); `extra`: (ctypes type, value) pairs after T, N, Kp, E (the W4A8
    entry: its workspace, a8_workspace). Returns [T, N] bf16."""
    T, K = x.shape
    E, N = qt.num_experts, qt.out_features
    if x.dtype != torch.bfloat16 or not x.is_cuda or qt.packed.device != x.device:
        raise ValueError(f"{fn_name} needs bf16 x and weights on one CUDA device")
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
    lib_name = "moe_matmul_sg" if fn_name.endswith("_sg") else "moe_matmul"
    lib = build.load(lib_name)
    if fn_name.endswith("_a8"):  # ws lives until the launch is queued
        ws = a8_workspace(lib_name, fn_name, T, qt.k_padded, x.device)
        extra = a8_workspace_args(ws)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [t for t, _ in extra] \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.biases.data_ptr(),
             group_sizes.data_ptr(), out.data_ptr(), T, N, qt.k_padded, E,
             *(v for _, v in extra), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, fn_name)
    return out


def grouped_quant_matmul_cuda(
    x: torch.Tensor, qt: QuantizedTensor, group_sizes: torch.Tensor
) -> torch.Tensor:
    """Launch the W4A16 kernel (W4 g128 experts)."""
    global LAUNCHES
    if not qt.is_w4g128:
        raise ValueError("grouped_quant_matmul_cuda is W4 g128 only")
    out = _launch("tlt_grouped_quant_matmul", x, qt, group_sizes)
    LAUNCHES += 1
    return out


def grouped_quant_matmul_a8_cuda(
    x: torch.Tensor, qt: QuantizedTensor, group_sizes: torch.Tensor
) -> torch.Tensor:
    """Launch the W4A8 kernel (W4 g128 experts, T <= 128 rows): the GEMV
    walk at few rows, above them the quantize kernel and the int8 tile walk
    (the entry chooses by T), one count for the call."""
    global A8_LAUNCHES
    if not qt.is_w4g128:
        raise ValueError("grouped_quant_matmul_a8_cuda is W4 g128 only")
    if x.shape[0] > A8_MAX_ROWS:
        raise ValueError(f"grouped_quant_matmul_a8_cuda takes at most {A8_MAX_ROWS} rows")
    out = _launch("tlt_grouped_quant_matmul_a8", x, qt, group_sizes)
    A8_LAUNCHES += 1
    return out


def grouped_quant_matmul_sg_cuda(
    x: torch.Tensor, qt: QuantizedTensor, group_sizes: torch.Tensor
) -> torch.Tensor:
    """Launch the any-width kernel (experts other than W4 g128)."""
    global SG_LAUNCHES
    if qt.is_w4g128:
        raise ValueError("W4 g128 experts run grouped_quant_matmul_cuda")
    out = _launch("tlt_grouped_quant_matmul_sg", x, qt, group_sizes,
                  ((ctypes.c_int, qt.bits), (ctypes.c_int, qt.group_size)))
    SG_LAUNCHES += 1
    return out


def grouped_quant_matmul(
    x: torch.Tensor,
    qt: QuantizedTensor,
    group_sizes: torch.Tensor,
    impl: str | None = None,
    partial: bool = False,
) -> torch.Tensor:
    """out[t] = x[t] @ dequant(qt[e(t)]).T for rows x [T, in_features] sorted
    by expert, expert e owning group_sizes[e] consecutive rows. -> [T, N] bf16.
    `partial`: the groups may cover fewer than T rows (an expert shard's
    fixed-size segment); the rows past them give 0 on the CPU and are
    unspecified on the card (the kernels never read the sizes on the host).

    act="int8" experts at T <= A8_MAX_ROWS run W4A8; other widths than
    W4 g128 the any-width kernel; the rest the W4A16 kernel."""
    if qt.num_experts is None:
        raise ValueError("grouped_quant_matmul needs stacked expert weights [E, N, K]")
    if x.ndim != 2 or x.shape[-1] != qt.in_features:
        raise ValueError(f"x {tuple(x.shape)} vs expert weight K={qt.in_features}")
    cuda = resolve(impl, x) == "cuda"
    if qt.act == "int8" and x.shape[0] <= A8_MAX_ROWS:
        fn = grouped_quant_matmul_a8_cuda if cuda else grouped_quant_matmul_a8_plain
    elif not qt.is_w4g128:
        fn = grouped_quant_matmul_sg_cuda if cuda else grouped_quant_matmul_plain
    else:
        fn = grouped_quant_matmul_cuda if cuda else grouped_quant_matmul_plain
    if cuda:
        return fn(x.to(torch.bfloat16), qt, group_sizes)
    return fn(x, qt, group_sizes, partial)
