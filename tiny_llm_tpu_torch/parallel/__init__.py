"""Parallel strategies of the port (counterpart of tiny_llm_tpu/parallel):
the mesh, the sharding rules (tensor parallelism: param_shardings,
shard_params, shard_kv_cache), the attention strategies (SPAttention for
sequence parallelism, TPAttention for heads under TP, DPPagedAttention for
a dp-striped page pool), data-parallel serving (DPServing),
expert-parallel MoE (EPMoE), pipeline parallelism (PipelinedQwen3,
MicrobatchedPipeline, DecodePipeline), the overlapped TP matmuls
(overlapped_tp_matmuls) and the multi-process runtime (initialize,
runtime_topology, make_multihost_mesh, host_local_requests, barrier). The
shards of an axis run in one process, each on its mesh device; the
pipelines and the overlapped matmuls also run as torch.distributed ranks,
through the ring hop of ring.py."""

from .distributed import (
    Topology,
    barrier,
    host_local_requests,
    initialize,
    make_multihost_mesh,
    runtime_topology,
)
from .dp import DPPagedAttention, DPPagedBatchingKVCache, DPServing, dp_paged_pool_spec
from .ep_moe import EPMoE
from .mesh import Mesh, make_mesh
from .overlap import allgather_matmul, matmul_reducescatter, overlapped_tp_matmuls
from .pipeline import DecodePipeline, MicrobatchedPipeline, PipelinedQwen3, split_stages
from .ring import GroupRing, LocalRing
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
    "DecodePipeline",
    "EPMoE",
    "GroupRing",
    "LocalRing",
    "Mesh",
    "MicrobatchedPipeline",
    "PipelinedQwen3",
    "SPAttention",
    "ShardingConfig",
    "TPAttention",
    "Topology",
    "allgather_matmul",
    "barrier",
    "combine_softmax_states",
    "decode_state_plain",
    "dp_paged_pool_spec",
    "host_local_requests",
    "initialize",
    "kv_cache_spec",
    "make_mesh",
    "make_multihost_mesh",
    "matmul_reducescatter",
    "overlapped_tp_matmuls",
    "paged_decode_state_plain",
    "paged_pool_spec",
    "param_shardings",
    "runtime_topology",
    "shard_kv_cache",
    "shard_params",
    "split_stages",
]
