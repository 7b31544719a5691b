"""KV caches of the port (counterpart of tiny_llm_tpu/kv)."""

from .cache import DenseKVCache, bucket_for

__all__ = ["DenseKVCache", "bucket_for"]
