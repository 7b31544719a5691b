"""Model registry — counterpart of tiny_llm_tpu/models/registry.py: the
shortcut names, the published Qwen3 shapes (the dense members and
Qwen3-30B-A3B, MoE) and `dispatch_model`."""

from __future__ import annotations

from .qwen3 import Qwen3Config, Qwen3Model

MODEL_SHORTCUTS = {
    "qwen3-0.6b": "Qwen/Qwen3-0.6B",
    "qwen3-1.7b": "Qwen/Qwen3-1.7B",
    "qwen3-4b": "Qwen/Qwen3-4B",
    "qwen3-8b": "Qwen/Qwen3-8B",
    "qwen3-14b": "Qwen/Qwen3-14B",
    "qwen3-30b-a3b": "Qwen/Qwen3-30B-A3B",
}

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


def dispatch_model(model_name: str, params, cfg: Qwen3Config | None = None,
                   **kwargs) -> Qwen3Model:
    """A Qwen3Model from params and the named (or an explicit) config;
    `kwargs` go to Qwen3Model (device defaults to the card there)."""
    if cfg is None:
        key = model_name.lower()
        if key not in QWEN3_CONFIGS:
            raise ValueError(f"unknown model {model_name!r}; pass cfg explicitly")
        cfg = QWEN3_CONFIGS[key]
    return Qwen3Model(params, cfg, **kwargs)
