"""Dense KV caches — counterpart of tiny_llm_tpu/kv/cache.py (DenseKVCache,
BatchingKVCache).

A preallocated bf16 slab [num_layers, B, H_kv, max_seq, D] per tensor, the
JAX package's layout, plus a host-side offset (per slot for batching). The model writes each new
k/v row into the slab IN PLACE (JAX's functional update needs donated
buffers for the same effect); no step reallocates or copies the slab.
Rewind is an O(1) offset decrement: stale rows past the offset are never
read (the kernels clamp at each row's length) and get overwritten.

`KVCache` is the JAX package's cache contract (offset, rewind, release,
materialize). The port writes in place, so `update_tensors` only installs
the tensors and offsets it is given (the JAX package's way of handing back
a jitted step's donated buffers), and `materialize` waits for the work
queued on the cache's device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
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


def wait_for(device: torch.device) -> None:
    """Block until the work queued on `device` has finished (its current
    stream); nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class KVCache(ABC):
    """Per-request cache handle: the JAX package's contract (reference
    TinyKvCache parity)."""

    @property
    @abstractmethod
    def offset(self) -> int: ...

    @abstractmethod
    def rewind(self, n: int) -> None:
        """Drop the newest n logical tokens (speculative decoding, prefix reuse)."""

    def release(self) -> None:
        """Release resources owned by this cache."""

    def materialize(self) -> None:
        """Block until pending device work on the cache has finished."""


class DenseKVCache(KVCache):
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

    def update_tensors(self, keys: torch.Tensor, values: torch.Tensor, new_offset: int) -> None:
        """Install `keys` / `values` as the slab and `new_offset` as the offset."""
        self.keys = keys
        self.values = values
        self._offset = int(new_offset)

    def release(self) -> None:
        self.keys = None
        self.values = None

    def materialize(self) -> None:
        wait_for(self.device)


class BatchingKVCache(KVCache):
    """Slot-multiplexed dense cache for continuous batching: one slab
    [layers, max_active, Hkv, max_seq, D] allocated once. Adding a request
    copies its prefilled rows into the slot; removing it zeroes the slot's
    offset. Idle slots decode discarded rows at offset 0."""

    def __init__(
        self,
        num_layers: int,
        max_active_requests: int,
        num_kv_heads: int,
        max_seq_len: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
    ):
        self.device = check_device(device)
        self.max_active_requests = max_active_requests
        self.max_seq_len = max_seq_len
        shape = (num_layers, max_active_requests, num_kv_heads, max_seq_len, head_dim)
        self.keys = torch.zeros(shape, dtype=dtype, device=self.device)
        self.values = torch.zeros(shape, dtype=dtype, device=self.device)
        self.offsets = np.zeros((max_active_requests,), np.int32)
        self.active = np.zeros((max_active_requests,), bool)

    def add_request(self, prefilled: DenseKVCache, slot: int) -> None:
        if not 0 <= slot < self.max_active_requests:
            raise ValueError(f"slot {slot} out of range")
        if prefilled.batch_size != 1:
            raise ValueError("only a single-request cache can be installed in a slot")
        n = prefilled.offset
        if n > self.max_seq_len:
            raise ValueError(f"prefilled {n} positions exceed the slot's {self.max_seq_len}")
        self.keys[:, slot, :, :n] = prefilled.keys[:, 0, :, :n]
        self.values[:, slot, :, :n] = prefilled.values[:, 0, :, :n]
        self.offsets[slot] = n
        self.active[slot] = True

    def remove_request(self, slot: int) -> None:
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.offsets[slot] = 0
        self.active[slot] = False

    @property
    def offset(self) -> int:
        """The longest active slot's offset (0 with none active)."""
        return int(self.offsets.max()) if self.active.any() else 0

    def update_tensors(self, keys: torch.Tensor, values: torch.Tensor, new_offsets) -> None:
        """Install `keys` / `values` as the slab and `new_offsets` as the
        slots' offsets."""
        self.keys = keys
        self.values = values
        self.offsets = np.asarray(new_offsets, dtype=np.int32)

    def rewind(self, n: int) -> None:
        """Drop the newest n positions of every active slot. Idle slots keep
        offset 0: the JAX package subtracts n from them too, leaving them
        negative until a request is installed (which sets the offset), so
        the two agree on every slot a step reads."""
        if n > int(self.offsets[self.active].min(initial=n)):
            raise ValueError(f"rewind {n} past an active slot's offset {self.offsets}")
        self.offsets = np.where(self.active, self.offsets - n, self.offsets).astype(np.int32)

    def release(self) -> None:
        self.keys = None
        self.values = None

    def materialize(self) -> None:
        wait_for(self.device)
