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
is copied only to reach a shard on another device.

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

    def _blocks(self, B: int, hq: int, hkv: int):
        """(device, batch rows, q heads, KV heads) of every (dp, tp) shard:
        rows split over dp where B divides, else every row on each tp
        shard of replica 0."""
        if hq % self.tp or hkv % self.tp:
            raise ValueError(f"{hq} / {hkv} heads do not divide over tp = {self.tp}")
        dp = self.dp if B % self.dp == 0 else 1
        rb, qh, kh = B // dp, hq // self.tp, hkv // self.tp
        mesh, ax = self.scfg.mesh, self.scfg.tp_axis
        for r in range(dp):
            devs = mesh.devices_along(ax, **({self.scfg.dp_axis: r} if dp > 1 else {}))
            for t, dev in enumerate(devs):
                yield (dev, slice(r * rb, (r + 1) * rb), slice(t * qh, (t + 1) * qh),
                       slice(t * kh, (t + 1) * kh))

    @staticmethod
    def _assemble(outs, B: int, dp_rows: int, like: torch.Tensor) -> torch.Tensor:
        """Shard outputs [rows, heads, L, D] back into [B, Hq, L, D]."""
        per_row = len(outs) // (B // dp_rows)
        rows = [torch.cat(outs[i : i + per_row], dim=1) for i in range(0, len(outs), per_row)]
        return torch.cat(rows, dim=0).to(like.device)

    def flash(self, q, k, v, lens=None, scale=None):
        """Causal attention of q [B, Hq, L, D] over the slab k/v
        [B, Hkv, S, D] (see flash_attention), per head shard."""
        B, Hq, L, D = q.shape
        if lens is None:
            lens = torch.full((B,), k.shape[2], dtype=torch.int32, device=q.device)
        outs, rows_per = [], B
        for dev, rows, qh, kh in self._blocks(B, Hq, k.shape[1]):
            rows_per = rows.stop - rows.start
            outs.append(flash_attention(
                q[rows, qh].contiguous().to(dev), k[rows, kh].to(dev), v[rows, kh].to(dev),
                lens[rows].to(dev), scale=scale, impl=self.impl))
        return self._assemble(outs, B, rows_per, q)

    def paged(self, q, key_pages, value_pages, block_table, context_lens, scale=None):
        """Causal attention of q [B, Hq, L, D] over one layer's page pool
        [P, Hkv, ps, D], the pool's KV heads split over tp; the block
        table and lengths are the same for every head shard."""
        B = q.shape[0]
        outs, rows_per = [], B
        for dev, rows, qh, kh in self._blocks(B, q.shape[1], key_pages.shape[1]):
            rows_per = rows.stop - rows.start
            outs.append(paged_attention(
                q[rows, qh].contiguous().to(dev), key_pages[:, kh].to(dev),
                value_pages[:, kh].to(dev), block_table[rows].to(dev),
                context_lens[rows].to(dev), scale=scale, impl=self.impl))
        return self._assemble(outs, B, rows_per, q)


def paged_pool_spec(scfg: ShardingConfig) -> tuple:
    """Per-layer [Pg, H_kv, page_size, D] pool buffer: KV heads on tp."""
    return (None, scfg.tp_axis, None, None)
