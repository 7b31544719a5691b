"""Qwen3 for the port (counterpart of tiny_llm_tpu/models)."""

from .bridge import from_jax_numpy
from .loader import (
    load_config,
    load_params,
    random_params,
    synthetic_quantized_params,
    tiny_test_config,
)
from .qwen3 import (
    AttentionParams,
    BlockParams,
    MLPParams,
    MoEParams,
    Qwen3Config,
    Qwen3Model,
    Qwen3Params,
    forward_decode_burst_dense,
    forward_full,
    forward_layers,
    forward_step,
    fuse_projections,
)
from .registry import MODEL_SHORTCUTS, QWEN3_CONFIGS, dispatch_model

__all__ = [
    "AttentionParams",
    "BlockParams",
    "MLPParams",
    "MODEL_SHORTCUTS",
    "MoEParams",
    "QWEN3_CONFIGS",
    "Qwen3Config",
    "Qwen3Model",
    "Qwen3Params",
    "dispatch_model",
    "forward_decode_burst_dense",
    "forward_full",
    "forward_layers",
    "forward_step",
    "from_jax_numpy",
    "fuse_projections",
    "load_config",
    "load_params",
    "random_params",
    "synthetic_quantized_params",
    "tiny_test_config",
]
