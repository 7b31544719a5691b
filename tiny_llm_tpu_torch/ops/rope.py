"""Rotary position embeddings — counterpart of tiny_llm_tpu/ops/rope.py."""

from __future__ import annotations

import torch


def rope_tables(
    dims: int, max_seq_len: int, base: float = 10000.0, *, device: str | torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [max_seq_len, dims // 2] in f32.

    Built as in JAX (f32 base ** -(i / half), outer product with f32
    positions) on the CPU and then moved, so the card and the CPU share one
    table."""
    half = dims // 2
    inv_freq = torch.pow(
        torch.tensor(base, dtype=torch.float32),
        -(torch.arange(0, half, dtype=torch.float32) / half),
    )
    freqs = torch.outer(torch.arange(max_seq_len, dtype=torch.float32), inv_freq)
    return torch.cos(freqs).to(device), torch.sin(freqs).to(device)


def apply_rope(
    x: torch.Tensor,  # [B, L, H, D]
    cos_table: torch.Tensor,
    sin_table: torch.Tensor,
    positions: torch.Tensor,  # [B, L] int
    dims: int,
) -> torch.Tensor:
    """Rotate the first `dims` features (non-traditional halves) in f32,
    then round to x's dtype once."""
    half = dims // 2
    cos = cos_table[positions][:, :, None, :]
    sin = sin_table[positions][:, :, None, :]
    x32 = x.to(torch.float32)
    x1 = x32[..., :half]
    x2 = x32[..., half:dims]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if dims < x.shape[-1]:
        rotated = torch.cat([rotated, x32[..., dims:]], dim=-1)
    return rotated.to(x.dtype)
