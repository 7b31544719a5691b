"""Qwen3 for the port (counterpart of tiny_llm_tpu/models)."""

from .bridge import from_jax_numpy
from .loader import synthetic_quantized_params, tiny_test_config
from .qwen3 import (
    AttentionParams,
    BlockParams,
    MLPParams,
    MoEParams,
    Qwen3Config,
    Qwen3Model,
    Qwen3Params,
    forward_decode_burst_dense,
    forward_step,
    fuse_projections,
)
from .registry import QWEN3_CONFIGS

__all__ = [
    "AttentionParams",
    "BlockParams",
    "MLPParams",
    "MoEParams",
    "QWEN3_CONFIGS",
    "Qwen3Config",
    "Qwen3Model",
    "Qwen3Params",
    "forward_decode_burst_dense",
    "forward_step",
    "from_jax_numpy",
    "fuse_projections",
    "synthetic_quantized_params",
    "tiny_test_config",
]
