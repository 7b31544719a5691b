"""Parallel strategies of the port (counterpart of tiny_llm_tpu/parallel):
the mesh, the sharding configuration and the sequence-parallel attention
strategy. Tensor, data, expert and pipeline parallelism are not ported yet."""

from .mesh import Mesh, make_mesh
from .sharding import ShardingConfig
from .sp_attention import (
    SPAttention,
    combine_softmax_states,
    decode_state_plain,
    paged_decode_state_plain,
)

__all__ = [
    "Mesh",
    "SPAttention",
    "ShardingConfig",
    "combine_softmax_states",
    "decode_state_plain",
    "make_mesh",
    "paged_decode_state_plain",
]
