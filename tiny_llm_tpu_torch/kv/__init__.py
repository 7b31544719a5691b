"""KV caches of the port (counterpart of tiny_llm_tpu/kv)."""

from .cache import BatchingKVCache, DenseKVCache, bucket_for
from .paged import PagedBatchingKVCache, PagedKVCache, PagePool, PoolExhausted

__all__ = [
    "BatchingKVCache",
    "DenseKVCache",
    "PagePool",
    "PagedBatchingKVCache",
    "PagedKVCache",
    "PoolExhausted",
    "bucket_for",
]
