"""Plain tensor ops of the port (counterparts of tiny_llm_tpu/ops)."""

from .attention import (
    causal_mask,
    scaled_dot_product_attention_grouped,
    scaled_dot_product_attention_simple,
)
from .basics import linear, silu, softmax, swiglu
from .embedding import Embedding, QuantizedEmbedding, quantized_embedding_gather
from .norm import RMSNorm, rms_norm
from .quantize import (
    QuantizedTensor,
    concat_out_features,
    dequantize,
    from_codes,
    from_mlx_packing,
    permute_out_features,
    quantized_linear,
)
from .rope import RoPE, apply_rope, rope_tables
from .sampler import make_sampler

__all__ = [
    "Embedding",
    "QuantizedEmbedding",
    "QuantizedTensor",
    "RMSNorm",
    "RoPE",
    "apply_rope",
    "causal_mask",
    "concat_out_features",
    "dequantize",
    "from_codes",
    "from_mlx_packing",
    "linear",
    "make_sampler",
    "permute_out_features",
    "quantized_linear",
    "quantized_embedding_gather",
    "rms_norm",
    "rope_tables",
    "scaled_dot_product_attention_grouped",
    "scaled_dot_product_attention_simple",
    "silu",
    "softmax",
    "swiglu",
]
