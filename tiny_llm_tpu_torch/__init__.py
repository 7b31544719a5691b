"""tiny_llm_tpu_torch: the PyTorch/CUDA port of tiny_llm_tpu for one NVIDIA H100.

Imports torch and numpy only — never JAX, never the JAX package. Layout
mirrors tiny_llm_tpu: ops/, kernels/ (hand-written CUDA in csrc/, each
kernel beside its plain PyTorch version), kv/ (dense and paged caches),
models/, parallel/ (the sequence-parallel attention strategy), serving/
(continuous batching), generate.py, tokenizer.py.
Entry points run on the card unless given device="cpu".
"""

__all__ = ["generate", "kernels", "kv", "models", "ops", "parallel", "serving", "tokenizer"]
