"""Dequant-fused quantized matmuls (+ fused residual): K1 (W4A16 group 128),
the W4A8 kernel and the any-width kernel.

  * K1 replaces tiny_llm_tpu/kernels/quant_matmul.py::_magic_kernel
    (wrapper `_qmm_magic_pallas`); CUDA in csrc/quant_matmul.cu, whose
    header notes what bounds it on the H100 and how its three routes (a
    warp-per-row GEMV at M <= 2, a weight-streaming bf16 tensor-core tile
    for decode and serving rows, the TPU's staged schedule on warpgroup
    MMAs for prefill rows; the gates are constants of the .cu file, which
    `k1_route` asks) deal with that.
  * The W4A8 kernel replaces `_pair_kernel` (wrapper `_qmm_pair_pallas`):
    act="int8" weights (W4 g128) at M <= 32 rows, per-row absmax int8
    activations and integer dots; csrc/quant_matmul.cu
    (`tlt_quant_matmul_a8`): a GEMV at decode rows, above them a quantize
    kernel and an int8 tensor-core tile, which read a workspace this
    wrapper allocates at the size the entry asks for. Above 32 rows the
    JAX package runs W4A16-exact dots on such weights, and so does the
    port: K1.
  * The any-width kernel replaces `_qmm_kernel` (wrapper `_qmm_pallas`):
    weights other than W4 g128 (bits 2, 4, 8; groups 32, 64, 128) at any
    M; csrc/quant_matmul_sg.cu (`tlt_quant_matmul_sg`), K1's three routes
    with their bodies made generic over the width, gated by constants of
    that source, which `sg_route` asks. A group size outside those
    instances (any other that divides K, which the JAX package's
    `quantize` takes and its any-width Pallas kernel runs as a static
    argument) runs `tlt_quant_matmul_sg_rt` in the same source at every
    M: a SIMT walk that takes the group size at run time
    (csrc/qmm_rt.cuh), whose plain version is `quant_matmul_plain`.

`quant_matmul` dispatches as the JAX package's `quantized_matmul` does and
launches the chosen kernel for CUDA tensors; for CPU tensors (or when
impl="torch") it runs the plain version of the route the card takes for
those rows: for K1 and the any-width kernel `quant_matmul_plain` (f32
dequant) below their staged tiles' gates (STAGED_MIN_ROWS,
SG_STAGED_MIN_ROWS) and `quant_matmul_staged_plain` (the dequantized
weight bf16(q * s + b), as the staged tiles stage it) from there;
`quant_matmul_a8_plain` for the W4A8 kernel. On a CUDA tensor nothing
falls back: a width no kernel takes raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import torch

from ..ops.quantize import QuantizedTensor, dequantize, quantize_activations
from . import build
from .dispatch import resolve

TPU_KERNEL = "tiny_llm_tpu/kernels/quant_matmul.py:154 _magic_kernel"
TPU_KERNEL_A8 = "tiny_llm_tpu/kernels/quant_matmul.py:278 _pair_kernel"
TPU_KERNEL_SG = "tiny_llm_tpu/kernels/quant_matmul.py:79 _qmm_kernel"
SOURCE = "tiny_llm_tpu_torch/csrc/quant_matmul.cu"  # K1 and the W4A8 kernel
SOURCE_SG = "tiny_llm_tpu_torch/csrc/quant_matmul_sg.cu"
A8_MAX_ROWS = 32  # the JAX pair dispatch's decode gate (rows <= 32)
K1_ROUTES = ("gemv", "b16", "staged")  # tlt_quant_matmul_route's (and _sg_route's) codes
STAGED_MIN_ROWS = 33  # csrc/quant_matmul.cu's gate of K1's staged tile
SG_STAGED_MIN_ROWS = 33  # csrc/quant_matmul_sg.cu's gate of the any-width staged tile

# The activation tier of act="int8" weights when a call names none:
# TLT_PAIR_ACT, read once at import as the JAX package reads it ("int8";
# "bf16" gives W4A16-exact products on the same weights).
PAIR_ACT_DEFAULT = os.environ.get("TLT_PAIR_ACT", "int8")

# Kernel launches since the last reset (see kernels.reset_launches).
LAUNCHES = 0  # K1
A8_LAUNCHES = 0
SG_LAUNCHES = 0
RT_LAUNCHES = 0  # the any-width kernel's run-time-width walk


def quant_matmul_plain(
    x: torch.Tensor, qt: QuantizedTensor, residual: torch.Tensor | None = None
) -> torch.Tensor:
    """f32 dequant (q*s + b) matmul, + residual in f32, rounded to bf16 (K1's
    and the any-width kernel's plain version)."""
    out = torch.matmul(x.to(torch.float32), dequantize(qt, torch.float32).T)
    if residual is not None:
        out = out + residual.to(torch.float32)
    return out.to(torch.bfloat16)


def quant_matmul_staged_plain(
    x: torch.Tensor, qt: QuantizedTensor, residual: torch.Tensor | None = None
) -> torch.Tensor:
    """The staged tiles' arithmetic: the dequantized weight bf16(q * s + b)
    (ops/quantize.py dequantize), x @ that in f32, + residual in f32,
    rounded to bf16 once — the JAX package's XLA route (dequantize, then an
    f32-accumulated dot). Any width."""
    w = dequantize(qt, torch.bfloat16).to(torch.float32)
    out = torch.matmul(x.to(torch.float32), w.T)
    if residual is not None:
        out = out + residual.to(torch.float32)
    return out.to(torch.bfloat16)


def k1_route(rows: int) -> str:
    """The route K1's C entry takes for `rows` rows ("gemv", "b16" or
    "staged"), as its gates in csrc/quant_matmul.cu set it (CUDA only: it
    loads the library)."""
    fn = build.load("quant_matmul").tlt_quant_matmul_route
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return K1_ROUTES[fn(rows)]


def sg_route(rows: int) -> str:
    """The route the any-width kernel's C entry takes for `rows` rows, as
    its gates in csrc/quant_matmul_sg.cu set it (CUDA only)."""
    fn = build.load("quant_matmul_sg").tlt_quant_matmul_sg_route
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return K1_ROUTES[fn(rows)]


def quant_matmul_a8_plain(
    x: torch.Tensor, qt: QuantizedTensor, residual: torch.Tensor | None = None
) -> torch.Tensor:
    """W4A8: (sx * xq) @ dequant_f32(W).T with per-row absmax int8 xq (the
    JAX XLA twin's arithmetic, `_quantized_matmul_xla(a8=True)`), + residual
    in f32, rounded to bf16."""
    xq, sx = quantize_activations(x)
    out = torch.matmul(sx * xq.to(torch.float32), dequantize(qt, torch.float32).T)
    if residual is not None:
        out = out + residual.to(torch.float32)
    return out.to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _a8_workspace_bytes(lib_name: str, fn_name: str, rows: int, k_padded: int) -> int:
    """The bytes of workspace the W4A8 entry `fn_name` of `lib_name` takes
    for `rows` rows of k_padded, as its `<fn_name>_workspace` query gives
    them: 0 where the entry runs its GEMV, which takes none."""
    fn = getattr(build.load(lib_name), fn_name + "_workspace")
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_size_t
    return fn(rows, k_padded)


def a8_workspace(lib_name: str, fn_name: str, rows: int, k_padded: int, device):
    """The workspace of a W4A8 entry, allocated at the size the entry asks
    for (uint8), or None on its GEMV route, which takes none."""
    nbytes = _a8_workspace_bytes(lib_name, fn_name, rows, k_padded)
    return torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None


def a8_workspace_args(ws) -> tuple:
    """A W4A8 entry's workspace arguments (pointer, bytes) as `extra` pairs."""
    return ((ctypes.c_void_p, None if ws is None else ws.data_ptr()),
            (ctypes.c_size_t, 0 if ws is None else ws.numel()))


def _launch(fn_name, x, qt, residual, extra=()):
    """Check the operands and launch `fn_name`: x [M, K] bf16 CUDA (zero-
    padded to k_padded here), the weight on the same device, the residual
    [M, N] or None; `extra`: (ctypes type, value) pairs after M, N, Kp (the
    W4A8 entry: its workspace, a8_workspace). Returns [M, N] bf16."""
    M, K = x.shape
    N = qt.out_features
    if x.dtype != torch.bfloat16 or not x.is_cuda or qt.packed.device != x.device:
        raise ValueError(f"{fn_name} needs bf16 x and weights on one CUDA device")
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
    lib_name = "quant_matmul_sg" if "_sg" in fn_name else "quant_matmul"
    lib = build.load(lib_name)
    if fn_name.endswith("_a8"):  # ws lives until the launch is queued
        ws = a8_workspace(lib_name, fn_name, M, qt.k_padded, x.device)
        extra = a8_workspace_args(ws)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [t for t, _ in extra] \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), qt.packed.data_ptr(), qt.scales.data_ptr(), qt.biases.data_ptr(),
             residual.data_ptr() if residual is not None else None, out.data_ptr(), M, N,
             qt.k_padded, *(v for _, v in extra), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, fn_name)
    return out


def quant_matmul_cuda(
    x: torch.Tensor, qt: QuantizedTensor, residual: torch.Tensor | None = None
) -> torch.Tensor:
    """Launch K1. x [M, K] bf16 CUDA, W4 g128 weight; returns [M, N] bf16."""
    global LAUNCHES
    if not qt.is_w4g128:
        raise ValueError("quant_matmul_cuda (K1) is W4 g128 only")
    out = _launch("tlt_quant_matmul", x, qt, residual)
    LAUNCHES += 1
    return out


def quant_matmul_a8_cuda(
    x: torch.Tensor, qt: QuantizedTensor, residual: torch.Tensor | None = None
) -> torch.Tensor:
    """Launch the W4A8 kernel: the GEMV (activation quantization fused) at
    decode rows, above them the quantize kernel and the int8 tile (the
    entry chooses by M), one count for the call. x [M <= 32, K] bf16 CUDA,
    W4 g128 weight; returns [M, N] bf16."""
    global A8_LAUNCHES
    if not qt.is_w4g128:
        raise ValueError("quant_matmul_a8_cuda is W4 g128 only")
    if x.shape[0] > A8_MAX_ROWS:
        raise ValueError(f"quant_matmul_a8_cuda takes at most {A8_MAX_ROWS} rows")
    out = _launch("tlt_quant_matmul_a8", x, qt, residual)
    A8_LAUNCHES += 1
    return out


def quant_matmul_sg_cuda(
    x: torch.Tensor, qt: QuantizedTensor, residual: torch.Tensor | None = None
) -> torch.Tensor:
    """Launch the any-width kernel. x [M, K] bf16 CUDA, a weight of bits 2,
    4 or 8 and groups of 32, 64 or 128 other than W4 g128 (K1's); returns
    [M, N] bf16."""
    global SG_LAUNCHES
    if qt.is_w4g128:
        raise ValueError("W4 g128 weights run K1 (quant_matmul_cuda)")
    out = _launch("tlt_quant_matmul_sg", x, qt, residual,
                  ((ctypes.c_int, qt.bits), (ctypes.c_int, qt.group_size)))
    SG_LAUNCHES += 1
    return out


def quant_matmul_rt_cuda(
    x: torch.Tensor, qt: QuantizedTensor, residual: torch.Tensor | None = None
) -> torch.Tensor:
    """Launch the any-width kernel's run-time-width walk. x [M, K] bf16
    CUDA, a weight of bits 2, 4 or 8 in groups of any size the templated
    instances do not cover; returns [M, N] bf16."""
    global RT_LAUNCHES
    if qt.is_templated:
        raise ValueError(f"group size {qt.group_size} has a templated instance "
                         "(quant_matmul_cuda, quant_matmul_sg_cuda)")
    out = _launch("tlt_quant_matmul_sg_rt", x, qt, residual,
                  ((ctypes.c_int, qt.bits), (ctypes.c_int, qt.group_size)))
    RT_LAUNCHES += 1
    return out


def quant_matmul(
    x: torch.Tensor,
    qt: QuantizedTensor,
    residual: torch.Tensor | None = None,
    impl: str | None = None,
    act: str | None = None,
) -> torch.Tensor:
    """y = x @ dequant(qt).T (+ residual). x [..., in_features] -> [..., N] bf16.

    act="int8" weights at <= A8_MAX_ROWS rows run W4A8 when their tier,
    `act` or else PAIR_ACT_DEFAULT (TLT_PAIR_ACT), is "int8", K1 when it
    is "bf16"; other widths than W4 g128 the any-width kernel (its
    run-time-width walk outside the templated group sizes); the rest K1.
    The plain versions round as the card's route for those rows does
    (STAGED_MIN_ROWS, SG_STAGED_MIN_ROWS; the walk at every M as
    quant_matmul_plain)."""
    if x.shape[-1] != qt.in_features:
        raise ValueError(f"x K={x.shape[-1]} vs weight K={qt.in_features}")
    if act not in (None, "bf16", "int8"):
        raise ValueError(f"act {act!r}: expected None, 'bf16' or 'int8'")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, qt.in_features)
    r2 = None if residual is None else residual.reshape(-1, qt.out_features)
    cuda = resolve(impl, x) == "cuda"
    a8 = qt.act == "int8" and (act or PAIR_ACT_DEFAULT) == "int8"
    if a8 and x2.shape[0] <= A8_MAX_ROWS:
        fn = quant_matmul_a8_cuda if cuda else quant_matmul_a8_plain
    elif not qt.is_templated:
        fn = quant_matmul_rt_cuda if cuda else quant_matmul_plain
    elif cuda:
        fn = quant_matmul_cuda if qt.is_w4g128 else quant_matmul_sg_cuda
    else:
        gate = STAGED_MIN_ROWS if qt.is_w4g128 else SG_STAGED_MIN_ROWS
        fn = quant_matmul_staged_plain if x2.shape[0] >= gate else quant_matmul_plain
    out = fn(x2.to(torch.bfloat16) if cuda else x2, qt, r2)
    return out.reshape(*lead, qt.out_features)


def quantized_matmul(
    x: torch.Tensor,
    qt: QuantizedTensor,
    bias: torch.Tensor | None = None,
    impl: str | None = None,
    norm_weight: torch.Tensor | None = None,
    eps: float = 1e-6,
    residual: torch.Tensor | None = None,
    act: str | None = None,
    interpret: bool = False,
) -> torch.Tensor:
    """The JAX package's entry under its name and argument order:
    y = x @ dequant(qt).T (+ bias) (+ residual) in x's dtype, through
    quant_matmul (K1 on the card for W4 g128).

    `norm_weight` RMS-normalizes x first (ops.norm.rms_norm, unfused);
    `residual` folds into the kernel's epilogue unless there is a bias,
    which adds to the kernel's bf16 output in f32 first, as on the JAX
    package's Pallas route. `act` ("bf16" or "int8") overrides the
    weight's activation tier. `interpret`: the Pallas interpret mode has no
    CUDA counterpart; True asks for the plain versions (impl="torch")."""
    from ..ops.norm import rms_norm

    if interpret:
        impl = "torch"
    if act is not None and act != qt.act:
        qt = dataclasses.replace(qt, act=act)
    if norm_weight is not None:
        x = rms_norm(x, norm_weight, eps)
    out = quant_matmul(x, qt, residual if bias is None else None, impl=impl, act=act)
    if bias is not None:
        out = (out.to(torch.float32) + bias.to(torch.float32)).to(out.dtype)
        if residual is not None:
            out = out + residual.to(out.dtype)
    return out.to(x.dtype)
