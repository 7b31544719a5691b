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
    traditional: bool = False,
) -> torch.Tensor:
    """Rotate the first `dims` features in f32, then round to x's dtype
    once: the halves (x[:dims/2], x[dims/2:dims]) as pairs, or with
    `traditional` the interleaved pairs (x[2i], x[2i + 1])."""
    B, L, H, _ = x.shape
    half = dims // 2
    cos = cos_table[positions][:, :, None, :]
    sin = sin_table[positions][:, :, None, :]
    x32 = x.to(torch.float32)
    if traditional:
        xr = x32[..., :dims].reshape(B, L, H, half, 2)
        x1, x2 = xr[..., 0], xr[..., 1]
    else:
        x1 = x32[..., :half]
        x2 = x32[..., half:dims]
    real, imag = x1 * cos - x2 * sin, x2 * cos + x1 * sin
    if traditional:
        rotated = torch.stack([real, imag], dim=-1).reshape(B, L, H, dims)
    else:
        rotated = torch.cat([real, imag], dim=-1)
    if dims < x.shape[-1]:
        rotated = torch.cat([rotated, x32[..., dims:]], dim=-1)
    return rotated.to(x.dtype)


def _positions(batch: int, seq_len: int, offset, device) -> torch.Tensor:
    """The [B, L] positions of the JAX package's offset contract: None
    (0..L-1), an int or a slice spanning L (its start), a list of ints or
    slices (per-row starts), a tensor [B] (per-row starts) or [B, L]."""
    base = torch.arange(seq_len, device=device)[None, :]
    if offset is None:
        return base.expand(batch, seq_len)
    if isinstance(offset, slice):
        if offset.stop - offset.start != seq_len:
            raise ValueError(f"offset slice must span exactly {seq_len} positions")
        offset = offset.start
    if isinstance(offset, int):
        return (base + offset).expand(batch, seq_len)
    if isinstance(offset, list):
        starts = []
        for o in offset:
            if isinstance(o, slice):
                if o.stop - o.start != seq_len:
                    raise ValueError(f"offset slice must span exactly {seq_len} positions")
                o = o.start
            starts.append(int(o))
        if len(starts) != batch:
            raise ValueError(f"need {batch} per-row offsets, got {len(starts)}")
        return torch.tensor(starts, device=device)[:, None] + base
    offset = torch.as_tensor(offset, device=device).long()
    if offset.ndim == 0:
        return (base + offset).expand(batch, seq_len)
    if offset.ndim == 1:
        return offset[:, None] + base
    if offset.ndim != 2:
        raise ValueError(f"positions must be [B] or [B, L], got {tuple(offset.shape)}")
    return offset


class RoPE:
    """Precomputed-table RoPE over [B, L, H, D] activations (the JAX
    package's op object). The f32 tables are built once on the CPU and
    copied to each device the object is called on."""

    def __init__(self, dims: int, max_seq_len: int, base: float = 10000.0,
                 traditional: bool = False):
        if dims % 2:
            raise ValueError("dims must be even")
        self.dims = dims
        self.half_dims = dims // 2
        self.max_seq_len = max_seq_len
        self.base = base
        self.traditional = traditional
        self.cos_table, self.sin_table = rope_tables(dims, max_seq_len, base, device="cpu")
        self._on: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def __call__(self, x: torch.Tensor, offset=None) -> torch.Tensor:
        if x.device not in self._on:
            self._on[x.device] = (self.cos_table.to(x.device), self.sin_table.to(x.device))
        cos, sin = self._on[x.device]
        B, L = x.shape[:2]
        return apply_rope(x, cos, sin, _positions(B, L, offset, x.device), self.dims,
                          self.traditional)
