"""Parallel strategies of the port (counterpart of tiny_llm_tpu/parallel):
the mesh, the sharding rules (tensor parallelism: param_shardings,
shard_params, shard_kv_cache), the attention strategies (SPAttention for
sequence parallelism, TPAttention for heads under TP, DPPagedAttention for
a dp-striped page pool), data-parallel serving (DPServing) and
expert-parallel MoE (EPMoE). Every shard of an axis runs in one process on
its mesh device. Pipeline parallelism, the overlapped TP matmuls and the
multi-process runtime (pipeline.py, overlap.py, distributed.py) are not
ported yet."""

from .dp import DPPagedAttention, DPPagedBatchingKVCache, DPServing, dp_paged_pool_spec
from .ep_moe import EPMoE
from .mesh import Mesh, make_mesh
from .sharding import (
    ShardingConfig,
    kv_cache_spec,
    param_shardings,
    shard_kv_cache,
    shard_params,
)
from .sp_attention import (
    SPAttention,
    combine_softmax_states,
    decode_state_plain,
    paged_decode_state_plain,
)
from .tp_kernels import TPAttention, paged_pool_spec

__all__ = [
    "DPPagedAttention",
    "DPPagedBatchingKVCache",
    "DPServing",
    "EPMoE",
    "Mesh",
    "SPAttention",
    "ShardingConfig",
    "TPAttention",
    "combine_softmax_states",
    "decode_state_plain",
    "dp_paged_pool_spec",
    "kv_cache_spec",
    "make_mesh",
    "paged_decode_state_plain",
    "paged_pool_spec",
    "param_shardings",
    "shard_kv_cache",
    "shard_params",
]
