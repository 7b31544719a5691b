"""Basic numerics: softmax / linear / silu / swiglu.

Counterpart of tiny_llm_tpu/ops/basics.py: reductions in f32, outputs in
the input dtype, each elementwise op rounding to that dtype as XLA does.
"""

from __future__ import annotations

import torch


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Numerically stable softmax computed in f32, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    x32 = x32 - x32.amax(dim=dim, keepdim=True)
    e = torch.exp(x32)
    return (e / e.sum(dim=dim, keepdim=True)).to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x @ w.T (+ bias) with f32 accumulation; w is [out, in]."""
    out = torch.matmul(x.to(torch.float32), w.to(torch.float32).T)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def dense_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T for a dense model weight w [N, K] of x's dtype, accumulated
    in f32 and rounded to x's dtype once (the JAX package's dot_general
    with preferred_element_type=f32, then astype). On the card a bf16 or
    f16 product asks cuBLAS for f32 output: with x's dtype as output,
    PyTorch lets cuBLAS reduce split-K partials in that dtype."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        out = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[0]).to(x.dtype)
    return torch.matmul(x, w.t()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up — the MLP activation."""
    return silu(gate) * up
