"""Data-parallel serving — counterpart of tiny_llm_tpu/parallel/dp.py.

DP replicates the weights across the `dp` mesh axis and splits the decode
batch (the scheduler's slots) into contiguous per-replica blocks: slot i
is served by replica i // (slots / dp). Batched decode has no cross-slot
math, so the scheduler's slot semantics stay exactly as they are. The
replicas are the params' (sharding.py shard_params over a mesh with a dp
axis): each matmul runs replica r's block of rows on replica r's copy,
on its device (ops/sharded.py replica_rows), at M = B / dp.

Dense path: the batching slab's batch axis is marked as split over dp
(sharding.kv_cache_spec); every row's step is its own, so the model runs
as it does unsharded.

Paged path: the pool's page axis is split over dp into stripes, and page
allocation is pinned (kv/paged.py `dp_shards`): every page of a request
comes from the stripe of the replica that will serve its slot, and page
s * P_loc is replica s's own trash page. `DPPagedAttention` keeps the
page writes and reads stripe-local: a replica's rows run the port's paged
kernels over its stripe with block tables rebased to the stripe; a write
to a position another replica owns, or to an idle slot's -1, lands in the
replica's trash page. The scheduler's one extra rule: a request installs
into a slot of its pinned replica (DPPagedBatchingKVCache.choose_slot).

The scheduler's single pending prefill (B = 1) cannot split over dp: its
matmuls run on replica 0's copy, and each replica's stripe is read for
the row and the results merge, as in the JAX package (only the pinned
replica owns any of the row's pages). The port runs a replica's KV heads
in one launch (heads are independent), and the replicas' attention one
after another in one process on the pool's device: the pool is one
tensor, on one device.

The model writes a step's k/v through the global block table: pinning
puts every page a row owns in its replica's stripe, so that writes what
`paged_update` writes, except that an idle row's write lands in page 0
rather than in its replica's trash page, and no one reads either.
`paged_update` is the JAX package's stripe-local write, for a caller
that writes one stripe by itself.
"""

from __future__ import annotations

from typing import Any

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import DECODE_MAX_L, paged_attention, paged_decode_state
from ..kv.paged import PagedBatchingKVCache, PagePool
from .sharding import ShardingConfig, kv_cache_spec
from .sp_attention import _combine

__all__ = ["DPPagedAttention", "DPPagedBatchingKVCache", "DPServing", "dp_paged_pool_spec"]


def dp_paged_pool_spec(scfg: ShardingConfig) -> tuple:
    """Per-layer [Pg, H_kv, page_size, D] buffer: pages on dp, KV heads on
    tp."""
    return (scfg.dp_axis, scfg.tp_axis, None, None)


class DPPagedAttention:
    """Attention and page-write strategy for a dp-striped page pool; pass
    it as the model's `attn_impl`. Two batch regimes: B divisible by dp
    (batched decode): each replica's rows over its stripe only; otherwise
    (the pending prefill, B = 1): every replica's stripe for every row,
    merged. `impl`: None runs the kernels on CUDA tensors and their plain
    versions on CPU tensors; "torch" the plain versions on either."""

    def __init__(self, scfg: ShardingConfig, impl: str | None = None):
        if impl not in (None, "torch"):
            raise ValueError(f"impl {impl!r}: expected None or 'torch'")
        self.scfg = scfg
        self.impl = impl

    @property
    def _dp(self) -> int:
        return self.scfg.mesh.shape[self.scfg.dp_axis]

    def _dp_ok(self, B: int) -> bool:
        return B >= self._dp and B % self._dp == 0

    def _replica_rows(self, B: int):
        """(replica, its rows) of the batch; every row where B does not split."""
        dp = self._dp
        if not self._dp_ok(B):
            return [(r, slice(0, B)) for r in range(dp)]
        rb = B // dp
        return [(r, slice(r * rb, (r + 1) * rb)) for r in range(dp)]

    def _stripe(self, pages: torch.Tensor) -> int:
        if pages.shape[0] % self._dp:
            raise ValueError(f"num_pages {pages.shape[0]} must divide over dp = {self._dp}")
        return pages.shape[0] // self._dp

    def flash(self, q, k, v, lens=None, scale=None):
        """Chunk-local causal attention (the first chunk of a request over
        its own k/v): each replica's rows where B splits, else one call."""
        B = q.shape[0]
        if not self._dp_ok(B):
            return flash_attention(q, k, v, lens, scale=scale, impl=self.impl)
        if lens is None:
            lens = torch.full((B,), k.shape[2], dtype=torch.int32, device=q.device)
        return torch.cat([flash_attention(q[rows], k[rows], v[rows], lens[rows], scale=scale,
                                          impl=self.impl)
                          for _, rows in self._replica_rows(B)])

    def paged(self, q, key_pages, value_pages, block_table, context_lens, scale=None):
        """Causal attention of q [B, Hq, L, D] over a dp-striped pool
        [P, Hkv, ps, D] whose rows obey the pinning (every page of a row in
        its replica's stripe)."""
        B, L = q.shape[0], q.shape[2]
        P_loc = self._stripe(key_pages)
        if self._dp_ok(B):
            outs = []
            for r, rows in self._replica_rows(B):
                lo, bt = r * P_loc, block_table[rows]
                bt_local = torch.where(bt >= 0, bt - lo, -1)  # rebased to the stripe
                outs.append(paged_attention(q[rows], key_pages[lo : lo + P_loc],
                                            value_pages[lo : lo + P_loc], bt_local,
                                            context_lens[rows], scale=scale, impl=self.impl))
            return torch.cat(outs)
        if L > DECODE_MAX_L:
            # Every page of the row lies in one stripe: the pool's paged
            # prefill over the global table reads exactly the pinned
            # replica's pages (the JAX package merges the replicas' states).
            return paged_attention(q, key_pages, value_pages, block_table, context_lens,
                                   scale=scale, impl=self.impl)
        return _combine([
            paged_decode_state(q, key_pages[r * P_loc : (r + 1) * P_loc],
                               value_pages[r * P_loc : (r + 1) * P_loc], block_table,
                               context_lens, r * P_loc, scale, self.impl)
            for r in range(self._dp)
        ])

    def paged_update(self, kp_i, vp_i, k, v, page_idx_raw, slot):
        """Write this step's k/v [B, Hkv, L, D] into one layer's dp-striped
        pool [P, Hkv, ps, D] IN PLACE, replica by replica: a position in
        the replica's stripe lands there, one owned by another replica (or
        an idle slot's -1) in the replica's trash page (its first page)."""
        P_loc = self._stripe(kp_i)
        for r, rows in self._replica_rows(k.shape[0]):
            lo, idx = r * P_loc, page_idx_raw[rows]
            target = torch.where((idx >= lo) & (idx < lo + P_loc), idx, lo)
            kp_i[target, :, slot[rows], :] = k[rows].transpose(1, 2)
            vp_i[target, :, slot[rows], :] = v[rows].transpose(1, 2)
        return kp_i, vp_i


class DPServing:
    """A model wrapped so serving state comes back dp-split: drop-in for
    serving.batch_generate(model=...). Delegates everything to the model;
    batching caches are marked split over dp (dense) or are
    DPPagedBatchingKVCache over a dp-striped pool (paged).

    Paged use: build the model with attn_impl=DPPagedAttention(scfg) and
    call enable_paged_attention() before wrapping; DPServing re-stripes the
    pool for dp pinning (before any page is allocated)."""

    def __init__(self, model: Any, scfg: ShardingConfig):
        self._model = model
        self.scfg = scfg
        if model.page_pool is not None:
            dp = scfg.mesh.shape[scfg.dp_axis]
            if not hasattr(model.attn_impl, "paged_update"):
                raise ValueError("paged DP needs the model built with "
                                 "attn_impl=DPPagedAttention(scfg) so that each replica's rows "
                                 "read its own stripe")
            old = model.page_pool
            if old.num_pages % dp:
                raise ValueError(f"num_pages ({old.num_pages}) must be divisible by dp ({dp}); "
                                 "pass enable_paged_attention(num_pages=...)")
            if old.dp_shards != dp:
                if old.live_pages:
                    raise ValueError("wrap with DPServing before allocating any pages")
                model.page_pool = PagePool(
                    num_layers=old.num_layers, num_pages=old.num_pages,
                    num_kv_heads=old.num_kv_heads, page_size=old.page_size,
                    head_dim=old.head_dim, dtype=old.dtype, device=old.device, dp_shards=dp)

    def __getattr__(self, name: str):
        return getattr(self._model, name)

    def __call__(self, *args, **kwargs):
        return self._model(*args, **kwargs)

    def create_batching_kv_cache(self, max_active_requests: int,
                                 max_seq_len: int | None = None):
        dp = self.scfg.mesh.shape[self.scfg.dp_axis]
        if max_active_requests % dp:
            raise ValueError(f"batch_size ({max_active_requests}) must be divisible by the dp "
                             f"axis ({dp}) so slots partition evenly")
        if self._model.page_pool is not None:
            return DPPagedBatchingKVCache(self._model.page_pool, max_active_requests, dp)
        cache = self._model.create_batching_kv_cache(max_active_requests, max_seq_len)
        cache.spec = kv_cache_spec(self.scfg)
        return cache

    def slot_replica(self, slot: int, num_slots: int) -> int:
        """Which dp replica serves a slot (contiguous block placement)."""
        return slot // (num_slots // self.scfg.mesh.shape[self.scfg.dp_axis])


class DPPagedBatchingKVCache(PagedBatchingKVCache):
    """Slot-multiplexed paged cache whose slots split into dp replica
    blocks; a request may only install into a slot of the replica its
    pages are pinned to."""

    def __init__(self, pool: PagePool, max_active_requests: int, dp: int):
        if pool.dp_shards != dp or max_active_requests % dp:
            raise ValueError("the pool must be dp-striped (DPServing) and the slots divide over dp")
        super().__init__(pool, max_active_requests)
        self.dp = dp
        self.slots_per_replica = max_active_requests // dp

    def slot_shard(self, slot: int) -> int:
        return slot // self.slots_per_replica

    def choose_slot(self, request_cache, free_slots):
        """The first free slot on the request's pinned replica; None stalls
        admission until one frees (the scheduler retries)."""
        for i in free_slots:
            if self.slot_shard(i) == request_cache.shard:
                return i
        return None

    def add_request(self, prefilled, slot: int) -> None:
        if prefilled.shard != self.slot_shard(slot):
            raise ValueError(f"request pinned to replica {prefilled.shard} cannot occupy slot "
                             f"{slot} (replica {self.slot_shard(slot)})")
        super().add_request(prefilled, slot)
