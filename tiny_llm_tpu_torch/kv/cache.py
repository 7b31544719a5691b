"""Dense KV cache — counterpart of tiny_llm_tpu/kv/cache.py (DenseKVCache).

A preallocated bf16 slab [num_layers, B, H_kv, max_seq, D] per tensor, the
JAX package's layout, plus a host-side offset. The model writes each new
k/v row into the slab IN PLACE (JAX's functional update needs donated
buffers for the same effect); no step reallocates or copies the slab.
Rewind is an O(1) offset decrement: stale rows past the offset are never
read (the kernels clamp at each row's length) and get overwritten.
"""

from __future__ import annotations

import torch

from ..kernels.dispatch import check_device


def bucket_for(n: int, minimum: int = 128, maximum: int | None = None) -> int:
    """Smallest power of two >= n, at least `minimum`, clamped to `maximum`."""
    b = minimum
    while b < n:
        b *= 2
    if maximum is not None:
        b = min(b, maximum)
    return b


class DenseKVCache:
    """Preallocated dense cache for one request or one fixed batch."""

    def __init__(
        self,
        num_layers: int,
        batch_size: int,
        num_kv_heads: int,
        max_seq_len: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
    ):
        self.device = check_device(device)
        self.num_layers = num_layers
        self.batch_size = batch_size
        self.num_kv_heads = num_kv_heads
        self.max_seq_len = max_seq_len
        self.head_dim = head_dim
        shape = (num_layers, batch_size, num_kv_heads, max_seq_len, head_dim)
        self.keys = torch.zeros(shape, dtype=dtype, device=self.device)
        self.values = torch.zeros(shape, dtype=dtype, device=self.device)
        self._offset = 0

    @property
    def offset(self) -> int:
        return self._offset

    def advance(self, n: int) -> None:
        """Record that the model wrote n more positions into the slab."""
        if self._offset + n > self.max_seq_len:
            raise ValueError(f"offset {self._offset} + {n} exceeds {self.max_seq_len}")
        self._offset += n

    def rewind(self, n: int) -> None:
        """Drop the newest n positions."""
        if n > self._offset:
            raise ValueError(f"rewind {n} past offset {self._offset}")
        self._offset -= n

    def release(self) -> None:
        self.keys = None
        self.values = None
