"""Synthetic weights and the test config — counterpart of the synthetic part
of tiny_llm_tpu/models/loader.py. Loading real HF checkpoints is not ported
yet (it needs safetensors and checkpoint files the repository does not hold).
"""

from __future__ import annotations

import torch

from ..kernels.dispatch import check_device
from ..ops.quantize import GROUP_SIZE, QuantizedTensor, check_width, padded_k
from .qwen3 import AttentionParams, BlockParams, MLPParams, MoEParams, Qwen3Config, Qwen3Params


def synthetic_quantized_params(
    cfg: Qwen3Config,
    seed: int = 0,
    device: str | torch.device = "cuda",
    group_size: int = GROUP_SIZE,
    bits: int = 4,
) -> Qwen3Params:
    """Random quantized params at `bits` and `group_size`, built straight on
    `device` in the port's layout: random code words, and per group a scale
    and a bias that centre the codes on 0 at every width. With
    levels = 2^bits - 1: scale uniform in [0.001, 0.005) * 15 / levels, so
    that levels * scale spans what 15 * scale spans at W4, and bias
    -(levels / 2) * scale. At W4 that is the JAX package's draw (scale in
    [0.001, 0.005), bias -7.5 * scale) and the tensors are those of earlier
    versions bit for bit; the JAX package keeps -7.5 * scale at every width,
    which centres 4-bit codes only (W8 weights would all be positive).
    A MoE layer gets a router [E, D] and stacked experts: gate and up
    [E, I, D], down [E, D, I]. The tied LM head shares the embedding
    tensor. For benchmarks, where shapes and bytes matter."""
    check_width(bits, group_size)
    dev = check_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    levels = (1 << bits) - 1

    def qlin(*shape: int) -> QuantizedTensor:  # ([E,] N, K)
        *lead, n, k = shape
        kp = padded_k(k)
        packed = torch.randint(
            -(2**31), 2**31, (*lead, n, kp * bits // 32), dtype=torch.int32, generator=gen,
            device=dev,
        )
        scales = (
            (torch.rand((*lead, n, kp // group_size), generator=gen, device=dev) * 0.004 + 0.001)
            * (15 / levels)
        ).to(torch.bfloat16)
        biases = (-(levels / 2) * scales.to(torch.float32)).to(torch.bfloat16)
        return QuantizedTensor(packed=packed, scales=scales, biases=biases, out_features=n,
                               in_features=k, k_padded=kp, group_size=group_size, bits=bits)

    def ones(n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=torch.bfloat16, device=dev)

    D, Dh = cfg.hidden_size, cfg.head_dim
    layers = []
    for i in range(cfg.num_hidden_layers):
        attn = AttentionParams(
            wq=qlin(cfg.num_attention_heads * Dh, D),
            wk=qlin(cfg.num_key_value_heads * Dh, D),
            wv=qlin(cfg.num_key_value_heads * Dh, D),
            wo=qlin(D, cfg.num_attention_heads * Dh),
            q_norm=ones(Dh),
            k_norm=ones(Dh),
        )
        if cfg.is_moe_layer(i):
            E, I = cfg.num_experts, cfg.moe_intermediate_size
            mlp = MoEParams(w_router=qlin(E, D), w_gate=qlin(E, I, D), w_up=qlin(E, I, D),
                            w_down=qlin(E, D, I))
        else:
            mlp = MLPParams(
                w_gate=qlin(cfg.intermediate_size, D),
                w_up=qlin(cfg.intermediate_size, D),
                w_down=qlin(D, cfg.intermediate_size),
            )
        layers.append(BlockParams(ones(D), ones(D), attn, mlp))
    embedding = qlin(cfg.vocab_size, D)
    lm_head = None if cfg.tie_word_embeddings else qlin(cfg.vocab_size, D)
    return Qwen3Params(embedding=embedding, layers=layers, final_norm=ones(D), lm_head=lm_head)


def tiny_test_config(num_hidden_layers: int = 1, **overrides) -> Qwen3Config:
    """The JAX package's tiny test shape (tiny_llm_tpu/models/loader.py)."""
    d = dict(
        num_hidden_layers=num_hidden_layers,
        hidden_size=128,
        vocab_size=128,
        num_attention_heads=2,
        num_key_value_heads=1,
        head_dim=64,
        intermediate_size=128,
        rms_norm_eps=1e-5,
        max_position_embeddings=256,
        rope_theta=10000,
        tie_word_embeddings=True,
    )
    d.update(overrides)
    return Qwen3Config(**d)
