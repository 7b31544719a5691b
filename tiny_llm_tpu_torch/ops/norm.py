"""RMSNorm — counterpart of tiny_llm_tpu/ops/norm.py."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x / rms(x) * weight with f32 statistics.

    The normalized value rounds to x's dtype BEFORE the weight multiply,
    which then happens in x's dtype — the JAX package's rounding points."""
    x32 = x.to(torch.float32)
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    normed = (x32 * torch.rsqrt(ms + eps)).to(x.dtype)
    return normed * weight.to(x.dtype)


class RMSNorm:
    """Thin weight-holding wrapper (the JAX package's op object)."""

    def __init__(self, dim: int, weight: torch.Tensor, eps: float = 1e-5):
        if tuple(weight.shape) != (dim,):
            raise ValueError(f"weight shape {tuple(weight.shape)} != ({dim},)")
        self.dim = dim
        self.weight = weight
        self.eps = eps

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)
