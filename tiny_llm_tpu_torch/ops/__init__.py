"""Plain tensor ops of the port (counterparts of tiny_llm_tpu/ops)."""

from .attention import (
    causal_mask,
    scaled_dot_product_attention_grouped,
    scaled_dot_product_attention_simple,
)
from .basics import linear, silu, softmax, swiglu
from .embedding import quantized_embedding_gather
from .norm import rms_norm
from .quantize import (
    QuantizedTensor,
    concat_out_features,
    dequantize,
    from_codes,
    permute_out_features,
)
from .rope import apply_rope, rope_tables
from .sampler import make_sampler

__all__ = [
    "QuantizedTensor",
    "apply_rope",
    "causal_mask",
    "concat_out_features",
    "dequantize",
    "from_codes",
    "linear",
    "make_sampler",
    "permute_out_features",
    "quantized_embedding_gather",
    "rms_norm",
    "rope_tables",
    "scaled_dot_product_attention_grouped",
    "scaled_dot_product_attention_simple",
    "silu",
    "softmax",
    "swiglu",
]
