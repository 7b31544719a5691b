"""Paged KV cache — counterpart of tiny_llm_tpu/kv/paged.py: the page pool,
per-request handles and the slot-multiplexed batch cache.

* One free list and one block table serve every layer: appends touch all
  layers alike, so a request's page ids are layer-invariant.
* The pool's K and V are each ONE stacked tensor [layers, P, Hkv, ps, D];
  `key_pages[i]` is layer i's contiguous [P, Hkv, ps, D] view at no cost,
  which is what the attention kernels take. (The JAX package keeps a tuple
  of per-layer buffers instead, because XLA cannot pass a slice of one
  buffer to a custom call without copying it.)
* Capacity is fixed at construction; exhaustion raises PoolExhausted,
  which the scheduler's admission backpressure catches.
* Page 0 is the trash page: -1 block-table entries read and write it, so
  idle batch rows never touch a live page. It is never allocated.
* The model writes pages in place; these objects keep only the host-side
  bookkeeping (page ids, offsets) and the ledger counters the serving
  metrics read: free pages pop from the end of [P-1, ..., 1], so pages 1,
  2, 3, ... come out first and freed pages are reused last-in first-out.
  An unstriped pool keeps it in C++ by default (`native=None`), as the JAX
  package does: the native page index (native/page_allocator.py over
  csrc/page_allocator.cpp) holds the free list, each request's pages and
  offset, and assembles block tables; `native=False` keeps it in Python,
  with the same page ids, tables and counters. A native index that cannot
  be built raises (naming native=False); nothing falls back on its own.
* `stripe_shards` (a pool whose page axis the sequence-parallel attention
  splits over that many shards, parallel/sp_attention.py): one such free
  list per shard's page range, and each allocation takes from the shard
  with the most free pages (the lowest on a tie), so every request's
  context spreads evenly over the shards. Pure Python, as in the JAX
  package.
* `dp_shards` (a pool whose page axis data parallelism splits into one
  stripe per replica, parallel/dp.py): the opposite of SP striping.
  Allocation is pinned: every page of a request comes from one stripe
  (PagedKVCache.shard, by default the stripe with the most free pages), so
  a replica never reads another's page. Page s * P_loc is replica s's own
  trash page and is never allocated; a full stripe raises PoolExhausted
  even while another has room. Pure Python, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.dispatch import check_device
from .cache import KVCache, wait_for


class PoolExhausted(RuntimeError):
    """No free page: the scheduler defers admission on this type."""


class PagePool:
    """Physical page storage shared by every request and layer."""

    def __init__(
        self,
        num_layers: int,
        num_pages: int,
        num_kv_heads: int,
        page_size: int,
        head_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
        stripe_shards: int | None = None,
        dp_shards: int | None = None,
        native: bool | None = None,
    ):
        if num_pages < 2:
            raise ValueError("a pool needs the trash page and at least one more")
        if stripe_shards and dp_shards:
            raise ValueError("dp_shards and stripe_shards are exclusive")
        for n in (stripe_shards, dp_shards):
            if n and num_pages % n:
                raise ValueError(f"num_pages {num_pages} must divide over {n} shards")
        if dp_shards and num_pages // dp_shards < 2:
            raise ValueError("each dp stripe needs its trash page and at least one more")
        self.device = check_device(device)
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.num_kv_heads = num_kv_heads
        self.page_size = page_size
        self.head_dim = head_dim
        self.dtype = dtype
        shape = (num_layers, num_pages, num_kv_heads, page_size, head_dim)
        self.key_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.value_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.stripe_shards = stripe_shards
        self.dp_shards = dp_shards
        if native and (stripe_shards or dp_shards):
            raise ValueError("striped and pinned pools keep their bookkeeping in Python")
        self.native_index = None
        if native is not False and not (stripe_shards or dp_shards):
            from ..native import NativePageIndex

            try:
                self.native_index = NativePageIndex(num_pages)
            except (RuntimeError, OSError) as e:
                raise RuntimeError(f"the native page index did not build ({e}); pass "
                                   "native=False for the Python bookkeeping") from e
        self.reset()
        self._reused = 0
        self._ever_allocated: set[int] = set()

    def reset(self) -> None:
        """Every page but the trash pages free again (the ledger stays)."""
        if self.native_index is not None:
            self.native_index.reset()
            return
        n, P = self.stripe_shards or self.dp_shards or 1, self.num_pages
        p_loc = P // n
        trash = {s * p_loc for s in range(n)} if self.dp_shards else {0}
        # One list per shard, each popping its lowest page first.
        self._free_by_shard = [
            [p for p in range((s + 1) * p_loc - 1, s * p_loc - 1, -1) if p not in trash]
            for s in range(n)
        ]

    @property
    def free_pages(self) -> int:
        if self.native_index is not None:
            return self.native_index.free_pages
        return sum(len(f) for f in self._free_by_shard)

    def update_tensors(self, key_pages, value_pages) -> None:
        """Install the pools: each a [layers, P, Hkv, ps, D] tensor, or a
        sequence of per-layer [P, Hkv, ps, D] tensors (the JAX package's
        tuple), stacked."""
        self.key_pages = key_pages if torch.is_tensor(key_pages) else torch.stack(tuple(key_pages))
        self.value_pages = (value_pages if torch.is_tensor(value_pages)
                            else torch.stack(tuple(value_pages)))

    def materialize(self) -> None:
        wait_for(self.device)

    @property
    def reserved_pages(self) -> int:
        """Trash pages: one per dp replica, else one."""
        return self.dp_shards or 1

    @property
    def live_pages(self) -> int:
        return self.num_pages - self.reserved_pages - self.free_pages

    @property
    def reused_page_allocations(self) -> int:
        if self.native_index is not None:
            return self.native_index.reused_page_allocations
        return self._reused

    def least_loaded_shard(self) -> int:
        """The dp replica whose stripe has the most free pages (the first on
        a tie): new requests pin their pages there."""
        if not self.dp_shards:
            raise ValueError("not a dp-striped pool")
        return max(range(self.dp_shards), key=lambda s: len(self._free_by_shard[s]))

    def allocate_page(self, shard: int | None = None) -> int:
        """A free page: of stripe `shard` in a dp-striped pool (required
        there), else of the fullest shard."""
        if self.native_index is not None:
            return self.native_index.allocate_page()
        if self.dp_shards:
            if shard is None:
                raise ValueError("a dp-striped pool allocates in a pinned shard")
            free = self._free_by_shard[shard]
            if not free:
                raise PoolExhausted(
                    f"dp stripe {shard} exhausted ({self.num_pages // self.dp_shards} pages); "
                    "size the pool for max_seq_len * max_active_requests")
        else:
            free = max(self._free_by_shard, key=len)  # the first of the fullest shards
        if not free:
            raise PoolExhausted(
                f"page pool exhausted ({self.num_pages} pages); size the pool for "
                "max_seq_len * max_active_requests"
            )
        page = free.pop()
        if page in self._ever_allocated:
            self._reused += 1
        self._ever_allocated.add(page)
        return page

    def free_page(self, page: int) -> None:
        if self.native_index is not None:
            self.native_index.free_page(page)
            return
        self._free_by_shard[page // (self.num_pages // len(self._free_by_shard))].append(page)


class PagedKVCache(KVCache):
    """Per-request logical view: page ids + token offset, in the pool's
    native index or here. In a dp-striped pool every page comes from
    stripe `shard` (default: the pool's least loaded)."""

    def __init__(self, pool: PagePool, shard: int | None = None):
        self.pool = pool
        self._native = pool.native_index
        if pool.dp_shards and shard is None:
            shard = pool.least_loaded_shard()
        self.shard = shard
        if self._native is not None:
            self._req = self._native.request_create()
        else:
            self._page_ids: list[int] = []
            self._offset = 0
        self._released = False

    @property
    def offset(self) -> int:
        if self._native is not None:
            return self._native.request_offset(self._req)
        return self._offset

    @property
    def num_pages(self) -> int:
        if self._native is not None:
            return self._native.request_num_pages(self._req)
        return len(self._page_ids)

    @property
    def page_ids(self) -> list[int]:
        """The request's pages, in order (a copy)."""
        if self._native is not None:
            return self._native.block_table([self._req], self.num_pages)[0].tolist()
        return list(self._page_ids)

    def ensure_capacity(self, new_offset: int) -> None:
        """Allocate pages so positions [0, new_offset) are backed."""
        ps = self.pool.page_size
        if self._native is not None:
            self._native.request_ensure(self._req, new_offset, ps)
            return
        needed = (new_offset + ps - 1) // ps
        while len(self._page_ids) < needed:
            self._page_ids.append(self.pool.allocate_page(self.shard))

    def advance(self, n: int) -> None:
        """Record n appended tokens (pages must already be ensured)."""
        if self._native is not None:
            ok = self._native.request_advance(self._req, n, self.pool.page_size)
        else:
            ok = self._offset + n <= len(self._page_ids) * self.pool.page_size
            self._offset += n if ok else 0
        if not ok:
            raise ValueError(f"advance past the {self.num_pages} ensured pages")

    def rewind(self, n: int) -> None:
        """Drop the newest n tokens and free whole trailing pages."""
        ps = self.pool.page_size
        if self._native is not None:
            if not self._native.request_rewind(self._req, n, ps):
                raise ValueError(f"rewind {n} past offset {self.offset}")
            return
        if n > self._offset:
            raise ValueError(f"rewind {n} past offset {self._offset}")
        self._offset -= n
        needed = (self._offset + ps - 1) // ps
        while len(self._page_ids) > needed:
            self.pool.free_page(self._page_ids.pop())

    def release(self) -> None:
        if self._released:
            return
        if self._native is not None:
            # The index recycles the handle: keep the offset here, as the
            # Python bookkeeping does, and read nothing from it again.
            self._offset, self._page_ids = self.offset, []
            self._native.request_release(self._req)
            self._native = None
        else:
            for p in self._page_ids:
                self.pool.free_page(p)
            self._page_ids = []
        self._released = True

    def materialize(self) -> None:
        self.pool.materialize()

    def block_table_row(self, width: int) -> list[int]:
        """The first `width` page ids, -1 padded. A request can hold more
        pages than the width only in decode-burst steps past the model's
        max_seq_len, whose tokens the scheduler discards; the native index
        truncates the same way."""
        if self._native is not None:
            return self._native.block_table([self._req], width)[0].tolist()
        return (self._page_ids + [-1] * width)[:width]


class PagedBatchingKVCache(KVCache):
    """Slot-multiplexed paged cache for continuous batching. Installing and
    removing a request is O(1) metadata: its pages already live in the pool."""

    owns_added_requests = True  # installation is by reference, not copy

    def __init__(self, pool: PagePool, max_active_requests: int):
        self.pool = pool
        self.max_active_requests = max_active_requests
        self.slots: list[PagedKVCache | None] = [None] * max_active_requests

    @property
    def offset(self) -> int:
        """The longest active request's offset (0 with none active)."""
        return max((c.offset for c in self.slots if c is not None), default=0)

    @property
    def offsets(self) -> np.ndarray:
        if self._native_slots():
            return self.pool.native_index.offsets([-1 if c is None else c._req
                                                   for c in self.slots])
        return np.asarray([(c.offset if c is not None else 0) for c in self.slots], np.int32)

    def _native_slots(self) -> bool:
        """Whether every installed slot lives in the pool's native index."""
        return self.pool.native_index is not None and all(
            c is None or c._native is not None for c in self.slots)

    @property
    def active(self) -> np.ndarray:
        return np.asarray([c is not None for c in self.slots], bool)

    def add_request(self, prefilled: PagedKVCache, slot: int) -> None:
        if not 0 <= slot < self.max_active_requests:
            raise ValueError(f"slot {slot} out of range")
        if prefilled.pool is not self.pool:
            raise ValueError("paged batch caches must share one page pool")
        self.slots[slot] = prefilled

    def remove_request(self, slot: int) -> None:
        if self.slots[slot] is None:
            raise ValueError(f"slot {slot} is not active")
        self.slots[slot].release()
        self.slots[slot] = None

    def rewind(self, n: int) -> None:
        """Drop the newest n tokens of every active request (freeing whole
        trailing pages)."""
        for c in self.slots:
            if c is not None:
                c.rewind(n)

    def release(self) -> None:
        for i, c in enumerate(self.slots):
            if c is not None:
                c.release()
                self.slots[i] = None

    def materialize(self) -> None:
        self.pool.materialize()

    def block_table(self, width: int | None = None) -> np.ndarray:
        """The slots' -1-padded block table [slots, width] (an idle slot's
        row all -1), assembled by the native index where the pool has one."""
        w = width or max((c.num_pages for c in self.slots if c is not None), default=1)
        if self._native_slots():
            return self.pool.native_index.block_table(
                [-1 if c is None else c._req for c in self.slots], w)
        return np.asarray(
            [c.block_table_row(w) if c is not None else [-1] * w for c in self.slots], np.int32
        )
