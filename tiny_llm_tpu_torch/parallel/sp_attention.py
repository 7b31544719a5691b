"""Sequence-parallel (sharded-KV) attention — counterpart of
tiny_llm_tpu/parallel/sp_attention.py.

The KV cache is split along the sequence over one mesh axis: shard s holds
the dense slab's positions [s * S_loc, (s + 1) * S_loc), or the page pool's
global pages [s * P_loc, (s + 1) * P_loc) (block tables keep global ids, so
ownership is arithmetic). Each shard attends over its own keys and emits
its softmax state (o, m, l); the states combine exactly:

    m = max_s m_s,   w_s = l_s * exp(m_s - m),   out = sum_s w_s o_s / sum_s w_s

Decode steps run the shard decode-state kernels (flash_decode_state over a
strided view of the slab, paged_decode_state over a slice of the pool);
prefill chunks over the slab run the chunk-state kernel (flash_prefill_state)
per shard at a VIRTUAL length, lens - shard start, unclipped: a shard wholly
before a query row is fully visible to it, a shard wholly after gives the
identity state (0, NEG_INF, 0). Paged chunks of more than 16 tokens run
paged attention over the whole pool (the JAX package all-gathers the pages
there).

In the JAX package the shards are devices under shard_map and the combine
is pmax / psum over the axis. The port runs every shard of the axis in one
process, one after another, each a view of one slab or pool on one device
(the counterpart of the JAX tests' virtual devices), and the combine
reduces states stacked on a leading shard axis. Shards on several cards need
torch.distributed ranks, with all_reduce(MAX) and all_reduce(SUM) in place of
the stacked max and sums; the port has no such ranks yet.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention, flash_decode_state
from ..kernels.flash_attention import flash_decode_state_plain as decode_state_plain
from ..kernels.flash_attention import flash_prefill_state
from ..kernels.paged_attention import (
    DECODE_MAX_L,
    paged_attention,
    paged_decode_state,
    paged_decode_state_plain,
)
from .sharding import ShardingConfig

__all__ = ["SPAttention", "combine_softmax_states", "decode_state_plain",
           "paged_decode_state_plain"]


def combine_softmax_states(o, m, l):
    """Merge shard states stacked on axis 0 — o [n, B, Hq, L, D] (each
    normalised within its shard), m and l [n, B, Hq, L] f32 — into the
    attention output [B, Hq, L, D]: in f32, one cast to o's dtype at the
    end. Identity shards (l = 0) weigh nothing."""
    w = l * torch.exp(m - m.amax(0))
    num = (w[..., None] * o.float()).sum(0)
    return (num / w.sum(0).clamp(min=1e-30)[..., None]).to(o.dtype)


def _combine(states) -> torch.Tensor:
    return combine_softmax_states(*(torch.stack(part) for part in zip(*states)))


class SPAttention:
    """Attention strategy: pass it as Qwen3Model's `attn_impl` (or as `impl`
    to flash_attention / paged_attention). KV is sharded on the sequence over
    `axis` (default the mesh's tp axis).

    `impl`: None runs the kernels on CUDA tensors and their plain versions on
    CPU tensors; "torch" the plain versions on either; "gather" as None, but
    a prefill chunk over the dense slab runs K3 over the whole slab (the JAX
    package's all-gather route, kept for A/B)."""

    def __init__(self, scfg: ShardingConfig, axis: str | None = None, impl: str | None = None):
        if impl not in (None, "torch", "gather"):
            raise ValueError(f"impl {impl!r}: expected None, 'torch' or 'gather'")
        self.scfg = scfg
        self.axis = axis or scfg.tp_axis
        self.impl = impl
        self.n_shards = scfg.mesh.shape[self.axis]
        self._inner = None if impl == "gather" else impl

    def _check_device(self, t: torch.Tensor) -> None:
        for d in self.scfg.mesh.devices:
            if d.type != t.device.type or d.index not in (None, t.device.index):
                raise NotImplementedError(
                    f"the mesh holds {d}, the tensors lie on {t.device}: the port runs an "
                    "axis's shards on the tensors' own device only")

    def flash(self, q, k, v, lens=None, scale=None):
        """Causal attention of q [B, Hq, L, D] over the slab k/v
        [B, Hkv, S, D] sharded on S (see flash_attention)."""
        B, Hq, L, D = q.shape
        S, n = k.shape[2], self.n_shards
        if S % n:
            raise ValueError(f"KV length {S} must divide over {n} shards")
        self._check_device(q)
        scale = D**-0.5 if scale is None else float(scale)
        if lens is None:
            lens = torch.full((B,), S, dtype=torch.int32, device=q.device)
        if L > 1 and self.impl == "gather":
            return flash_attention(q, k, v, lens, scale=scale)
        S_loc = S // n
        starts = torch.arange(0, S, S_loc, dtype=torch.int32, device=q.device)
        shard_lens = lens.to(device=q.device, dtype=torch.int32)[None] - starts[:, None]  # [n, B]
        if L == 1:
            shard_lens = shard_lens.clamp(0, S_loc)
        states = []
        for s in range(n):
            ks, vs = k[:, :, s * S_loc : (s + 1) * S_loc], v[:, :, s * S_loc : (s + 1) * S_loc]
            if L == 1:
                states.append(flash_decode_state(q, ks, vs, shard_lens[s], scale, self._inner))
            else:  # the chunk-state kernel takes a contiguous shard
                states.append(flash_prefill_state(q, ks.contiguous(), vs.contiguous(),
                                                  shard_lens[s], scale, self._inner))
        return _combine(states)

    def paged(self, q, key_pages, value_pages, block_table, context_lens, scale=None):
        """Causal attention of q [B, Hq, L, D] over one layer's page pool
        [P, Hkv, ps, D] sharded on its page axis (see paged_attention)."""
        B, Hq, L, D = q.shape
        P, n = key_pages.shape[0], self.n_shards
        if P % n:
            raise ValueError(f"num_pages {P} must divide over {n} shards; pad the pool "
                             "(PagePool(num_pages=...))")
        self._check_device(q)
        scale = D**-0.5 if scale is None else float(scale)
        if L > DECODE_MAX_L:
            return paged_attention(q, key_pages, value_pages, block_table, context_lens,
                                   scale=scale, impl=self._inner)
        P_loc = P // n
        return _combine([
            paged_decode_state(q, key_pages[s * P_loc : (s + 1) * P_loc],
                               value_pages[s * P_loc : (s + 1) * P_loc], block_table,
                               context_lens, s * P_loc, scale, self._inner)
            for s in range(n)
        ])
