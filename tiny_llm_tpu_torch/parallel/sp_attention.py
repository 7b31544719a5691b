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
is pmax / psum over the axis. The port's axis (ops/axis.py, from the
ShardingConfig) holds its shards in one process, one after another, each a
view of one slab or pool on its device (the counterpart of the JAX tests'
virtual devices), or one shard a rank of a torch.distributed group
(ShardingConfig.rank_axis): each rank reads its own shard of the slab or
pool alone (the other positions are never read), then the shards' states
are gathered (all_gather of o, m and l) and every rank runs the
in-process combine on them, in shard order: the max of m, then the sums
of w * o and w. all_reduce(SUM) would add in an order it does not
promise; gathering keeps the ranks' combine bit-equal to the in-process
one. A paged chunk of more than 16 tokens (and the gather route's slab
chunks) gathers the shards first, as the JAX package all-gathers the
pages.

`mask` of `paged`: "causal" or None, as the JAX package's SP takes. None is
non-causal over the whole context, as paged_attention reads it; a decode
state is causal, so a None chunk of 2 to 16 queries takes the whole-pool
route too (at one query the two agree).
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
from ..ops.axis import LocalAxis
from .sharding import ShardingConfig

__all__ = ["SPAttention", "combine_softmax_states", "combine_states", "decode_state_plain",
           "gather_shards", "paged_decode_state_plain"]


def combine_softmax_states(o, m, l):
    """Merge shard states stacked on axis 0 — o [n, B, Hq, L, D] (each
    normalised within its shard), m and l [n, B, Hq, L] f32 — into the
    attention output [B, Hq, L, D]: in f32, one cast to o's dtype at the
    end. Identity shards (l = 0) weigh nothing."""
    w = l * torch.exp(m - m.amax(0))
    num = (w[..., None] * o.float()).sum(0)
    return (num / w.sum(0).clamp(min=1e-30)[..., None]).to(o.dtype)


def combine_states(axis, states: dict) -> torch.Tensor:
    """combine_softmax_states over an axis (ops/axis.py): `states` maps each
    held shard to its (o, m, l); every shard's state gathered, stacked in
    shard order and combined on every rank alike."""
    dev = next(iter(states.values()))[0].device
    return combine_softmax_states(*(torch.stack(axis.gather({s: st[i] for s, st in
                                                             states.items()}, dev))
                                    for i in range(3)))


def gather_shards(axis, t: torch.Tensor, dim: int) -> torch.Tensor:
    """t laid out at its whole size along `dim`, each position's shard
    filled from the position that holds it: t itself in this process; over
    ranks, every rank's own shard gathered."""
    if isinstance(axis, LocalAxis):
        return t
    loc = t.shape[dim] // axis.size
    return torch.cat(axis.gather({axis.rank: t.narrow(dim, axis.rank * loc, loc)}), dim=dim)


class SPAttention:
    """Attention strategy: pass it as Qwen3Model's `attn_impl` (or as `impl`
    to flash_attention / paged_attention). KV is sharded on the sequence over
    `axis` (default the mesh's tp axis), in this process or over ranks.

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
        ax = self.scfg.axis_impl(self.axis)
        scale = D**-0.5 if scale is None else float(scale)
        if lens is None:
            lens = torch.full((B,), S, dtype=torch.int32, device=q.device)
        if L > 1 and self.impl == "gather":
            return flash_attention(q, gather_shards(ax, k, 2), gather_shards(ax, v, 2), lens,
                                   scale=scale)
        S_loc = S // n
        starts = torch.arange(0, S, S_loc, dtype=torch.int32, device=q.device)
        shard_lens = lens.to(device=q.device, dtype=torch.int32)[None] - starts[:, None]  # [n, B]
        if L == 1:
            shard_lens = shard_lens.clamp(0, S_loc)
        states = {}
        for s in ax.positions:
            ks, vs = k[:, :, s * S_loc : (s + 1) * S_loc], v[:, :, s * S_loc : (s + 1) * S_loc]
            if L == 1:
                states[s] = flash_decode_state(q, ks, vs, shard_lens[s], scale, self._inner)
            else:  # the chunk-state kernel takes a contiguous shard
                states[s] = flash_prefill_state(q, ks.contiguous(), vs.contiguous(),
                                                shard_lens[s], scale, self._inner)
        return combine_states(ax, states)

    def paged(self, q, key_pages, value_pages, block_table, context_lens, scale=None,
              mask="causal"):
        """Attention of q [B, Hq, L, D] over one layer's page pool
        [P, Hkv, ps, D] sharded on its page axis (see paged_attention)."""
        B, Hq, L, D = q.shape
        P, n = key_pages.shape[0], self.n_shards
        if not (mask is None or (isinstance(mask, str) and mask == "causal")):
            raise ValueError("sequence-parallel paged attention takes mask 'causal' or None")
        if P % n:
            raise ValueError(f"num_pages {P} must divide over {n} shards; pad the pool "
                             "(PagePool(num_pages=...))")
        self._check_device(q)
        ax = self.scfg.axis_impl(self.axis)
        scale = D**-0.5 if scale is None else float(scale)
        if L > DECODE_MAX_L or (mask is None and L > 1):
            return paged_attention(q, gather_shards(ax, key_pages, 0),
                                   gather_shards(ax, value_pages, 0), block_table, context_lens,
                                   scale=scale, mask=mask, impl=self._inner)
        P_loc = P // n
        return combine_states(ax, {
            s: paged_decode_state(q, key_pages[s * P_loc : (s + 1) * P_loc],
                                  value_pages[s * P_loc : (s + 1) * P_loc], block_table,
                                  context_lens, s * P_loc, scale, self._inner)
            for s in ax.positions})
