"""Attention kernels under tensor parallelism — counterpart of
tiny_llm_tpu/parallel/tp_kernels.py.

Under the TP rules (sharding.py) every shard holds whole query heads and
their KV heads, and pages never cross shards, so attention is parallel
over the head axis with no collective: each shard runs the single-device
kernels on its own heads and KV (K3, and row 4's route at L <= 16, for
`.flash`; the paged decode and prefill kernels for `.paged`), and the
shards' outputs are concatenated on the head axis. The JAX package does
this with a shard_map over the mesh; the port runs the shards one after
another in one process, each on its mesh device, batch rows split over
`dp` where they divide. A shard's KV is a view of the slab or the pool
(its heads, its rows), which K3 and the paged kernels read in place; it
is copied only to reach a shard on another device. Over ranks
(ShardingConfig.rank_axis = the tp axis) each rank runs its own head shard
alone, reading its heads of the slab or pool only, and the shards' outputs
are gathered in head order (ops/axis.py).

Pass a TPAttention as the model's `attn_impl`.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.paged_attention import paged_attention
from .sharding import ShardingConfig

__all__ = ["TPAttention", "paged_pool_spec"]


class TPAttention:
    """Attention strategy running the port's kernels per head shard of the
    `tp` axis. `impl`: None runs the kernels on CUDA tensors and their
    plain versions on CPU tensors; "torch" the plain versions on either."""

    def __init__(self, scfg: ShardingConfig, impl: str | None = None):
        if impl not in (None, "torch"):
            raise ValueError(f"impl {impl!r}: expected None or 'torch'")
        self.scfg = scfg
        self.impl = impl
        shape = scfg.mesh.shape
        self.tp = shape[scfg.tp_axis]
        self.dp = shape.get(scfg.dp_axis, 1)

    def _run(self, B: int, hq: int, hkv: int, fn, like: torch.Tensor) -> torch.Tensor:
        """fn(device, batch rows, q heads, KV heads) of every held (dp, tp)
        shard, its outputs [rows, heads, L, D] put back into [B, Hq, L, D]:
        rows split over dp where B divides, else every row on each tp shard
        of replica 0; the tp shards' heads gathered in order."""
        if hq % self.tp or hkv % self.tp:
            raise ValueError(f"{hq} / {hkv} heads do not divide over tp = {self.tp}")
        dp = self.dp if B % self.dp == 0 else 1
        rb, qh, kh = B // dp, hq // self.tp, hkv // self.tp
        blocks = []
        for r in range(dp):
            ax = self.scfg.axis_impl(self.scfg.tp_axis,
                                     **({self.scfg.dp_axis: r} if dp > 1 else {}))
            outs = {t: fn(ax.device(t), slice(r * rb, (r + 1) * rb), slice(t * qh, (t + 1) * qh),
                          slice(t * kh, (t + 1) * kh)) for t in ax.positions}
            blocks.append(torch.cat(ax.gather(outs, like.device), dim=1))
        return torch.cat(blocks, dim=0)

    def flash(self, q, k, v, lens=None, scale=None):
        """Causal attention of q [B, Hq, L, D] over the slab k/v
        [B, Hkv, S, D] (see flash_attention), per head shard."""
        B, Hq, L, D = q.shape
        if lens is None:
            lens = torch.full((B,), k.shape[2], dtype=torch.int32, device=q.device)
        return self._run(B, Hq, k.shape[1], lambda dev, rows, qh, kh: flash_attention(
            q[rows, qh].contiguous().to(dev), k[rows, kh].to(dev), v[rows, kh].to(dev),
            lens[rows].to(dev), scale=scale, impl=self.impl), q)

    def paged(self, q, key_pages, value_pages, block_table, context_lens, scale=None,
              mask="causal"):
        """Attention of q [B, Hq, L, D] over one layer's page pool
        [P, Hkv, ps, D] (see paged_attention), the pool's KV heads split
        over tp; the block table, the lengths and a shared mask are the
        same for every head shard (a per-row mask takes the shard's rows).
        A mask other than "causal" runs on a contiguous copy of the head
        shard (the prefix-state walk takes whole pools)."""
        def rows_of(rows):
            per_row = torch.is_tensor(mask) and mask.ndim >= 3
            return mask[rows] if per_row else mask

        def pages(p, kh, dev):
            shard = p[:, kh].to(dev)
            return shard if isinstance(mask, str) else shard.contiguous()

        return self._run(q.shape[0], q.shape[1], key_pages.shape[1],
                         lambda dev, rows, qh, kh: paged_attention(
                             q[rows, qh].contiguous().to(dev), pages(key_pages, kh, dev),
                             pages(value_pages, kh, dev), block_table[rows].to(dev),
                             context_lens[rows].to(dev), scale=scale, mask=rows_of(rows),
                             impl=self.impl), q)


def paged_pool_spec(scfg: ShardingConfig) -> tuple:
    """Per-layer [Pg, H_kv, page_size, D] pool buffer: KV heads on tp."""
    return (None, scfg.tp_axis, None, None)
