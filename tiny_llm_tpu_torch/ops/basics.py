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


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up — the MLP activation."""
    return silu(gate) * up
