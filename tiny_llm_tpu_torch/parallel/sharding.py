"""Sharding configuration — counterpart of tiny_llm_tpu/parallel/sharding.py's
ShardingConfig. The parameter and KV-cache sharding rules (tensor
parallelism) are not ported yet."""

from __future__ import annotations

import dataclasses

from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    mesh: Mesh
    tp_axis: str = "tp"
    dp_axis: str = "dp"
    # Composed EP x TP: the MoE expert axis's mesh axis; None shards experts
    # over tp_axis.
    ep_axis: str | None = None
