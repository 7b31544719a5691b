"""Continuous-batching serving of the port (counterpart of tiny_llm_tpu/serving)."""

from .batch import Request, batch_generate
from .metrics import ServingMetrics

__all__ = ["Request", "batch_generate", "ServingMetrics"]
