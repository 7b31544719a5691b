"""Published Qwen3 shapes — copy of tiny_llm_tpu/models/registry.py's table,
the dense members and Qwen3-30B-A3B (MoE)."""

from __future__ import annotations

from .qwen3 import Qwen3Config

QWEN3_CONFIGS: dict[str, Qwen3Config] = {
    "qwen3-0.6b": Qwen3Config(
        num_hidden_layers=28, hidden_size=1024, num_attention_heads=16,
        num_key_value_heads=8, head_dim=128, intermediate_size=3072,
        vocab_size=151936, tie_word_embeddings=True,
    ),
    "qwen3-1.7b": Qwen3Config(
        num_hidden_layers=28, hidden_size=2048, num_attention_heads=16,
        num_key_value_heads=8, head_dim=128, intermediate_size=6144,
        vocab_size=151936, tie_word_embeddings=True,
    ),
    "qwen3-4b": Qwen3Config(
        num_hidden_layers=36, hidden_size=2560, num_attention_heads=32,
        num_key_value_heads=8, head_dim=128, intermediate_size=9728,
        vocab_size=151936, tie_word_embeddings=True,
    ),
    "qwen3-8b": Qwen3Config(
        num_hidden_layers=36, hidden_size=4096, num_attention_heads=32,
        num_key_value_heads=8, head_dim=128, intermediate_size=12288,
        vocab_size=151936, tie_word_embeddings=False,
    ),
    "qwen3-14b": Qwen3Config(
        num_hidden_layers=40, hidden_size=5120, num_attention_heads=40,
        num_key_value_heads=8, head_dim=128, intermediate_size=17408,
        vocab_size=151936, tie_word_embeddings=False,
    ),
    "qwen3-30b-a3b": Qwen3Config(
        num_hidden_layers=48, hidden_size=2048, num_attention_heads=32,
        num_key_value_heads=4, head_dim=128, intermediate_size=6144,
        vocab_size=151936, tie_word_embeddings=False,
        num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
        decoder_sparse_step=1, norm_topk_prob=True,
    ),
}
