"""Checkpoint loading and synthetic weights — counterpart of
tiny_llm_tpu/models/loader.py.

`load_params` reads a HF-format checkpoint directory (config.json and
*.safetensors, through the port's own numpy reader, models/safetensors_io.py):
BF16 / F16 / F32 weights, kept dense (`quantized=False`, in `dtype`) or
quantized at load (`quantize`, codes bit-equal to the JAX package's), and
MLX exports (uint32 weight, scales, biases triplets, ingested as they are).
MoE layers come from the MLX `switch_mlp` export or the HF per-expert
tensors; a HF router stays dense, as in the JAX package. Every tensor is
moved to `device` before it is converted, so a checkpoint is repacked on
the card. The JAX package keeps a second copy of a tied embedding's codes
for the LM head; the port's layout serves both, so a tied head is None.

`random_params` draws normal * scale weights from a torch.Generator on
`device` (optionally quantized); `synthetic_quantized_params` builds random
codes straight in the port's layout, for benchmarks.
"""

from __future__ import annotations

import json
import os

import torch

from ..kernels.dispatch import check_device
from ..ops.quantize import (
    GROUP_SIZE,
    QuantizedTensor,
    check_width,
    from_mlx_packing,
    from_mlx_packing_stacked,
    padded_k,
    quantize,
    quantize_stacked,
)
from .qwen3 import AttentionParams, BlockParams, MLPParams, MoEParams, Qwen3Config, Qwen3Params
from .safetensors_io import load_dir


def _maybe_quantize(w: torch.Tensor, quantized: bool, group_size: int, bits: int,
                    dtype: torch.dtype = torch.bfloat16):
    """A float weight [N, K] or stacked [E, N, K]: quantized in the port's
    layout, or kept dense in `dtype`."""
    if not quantized:
        return w.to(dtype)
    return quantize(w, group_size, bits) if w.ndim == 2 else quantize_stacked(w, group_size, bits)


def random_params(
    cfg: Qwen3Config,
    seed: int = 0,
    quantized: bool = True,
    group_size: int = GROUP_SIZE,
    bits: int = 4,
    scale: float = 0.02,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> Qwen3Params:
    """Random Qwen3-shaped params: f32 normal * `scale` drawn on `device`
    from a torch.Generator seeded with `seed` (in the JAX package's order:
    the layers, then the embedding, then an untied head), quantized or kept
    dense in `dtype`; norms 1."""
    dev = check_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape: int):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale
        return _maybe_quantize(w, quantized, group_size, bits, dtype)

    def ones(n: int):
        return torch.ones((n,), dtype=dtype, device=dev)

    D, Dh = cfg.hidden_size, cfg.head_dim
    layers = []
    for i in range(cfg.num_hidden_layers):
        attn = AttentionParams(
            wq=rand(cfg.num_attention_heads * Dh, D), wk=rand(cfg.num_key_value_heads * Dh, D),
            wv=rand(cfg.num_key_value_heads * Dh, D), wo=rand(D, cfg.num_attention_heads * Dh),
            q_norm=ones(Dh), k_norm=ones(Dh),
        )
        if cfg.is_moe_layer(i):
            E, I = cfg.num_experts, cfg.moe_intermediate_size
            mlp = MoEParams(w_router=rand(E, D), w_gate=rand(E, I, D), w_up=rand(E, I, D),
                            w_down=rand(E, D, I))
        else:
            I = cfg.intermediate_size
            mlp = MLPParams(w_gate=rand(I, D), w_up=rand(I, D), w_down=rand(D, I))
        layers.append(BlockParams(ones(D), ones(D), attn, mlp))
    embedding = rand(cfg.vocab_size, D)
    lm_head = None if cfg.tie_word_embeddings else rand(cfg.vocab_size, D)
    return Qwen3Params(embedding=embedding, layers=layers, final_norm=ones(D), lm_head=lm_head)


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


# ---------------------------------------------------------------------------
# HF checkpoints (config.json + *.safetensors): dense (BF16 / F16 / F32) and
# MLX exports (weight / scales / biases triplets).
# ---------------------------------------------------------------------------


def load_config(model_dir: str) -> Qwen3Config:
    with open(os.path.join(model_dir, "config.json")) as f:
        return Qwen3Config.from_hf_dict(json.load(f))


def _load_moe_mlp(t, p: str, cfg: Qwen3Config, to_dev, quantized: bool, group_size: int,
                  bits: int, dtype: torch.dtype) -> MoEParams:
    """A MoE layer from either convention: the MLX switch_mlp export
    (stacked `{p}.mlp.switch_mlp.{gate,up,down}_proj` [E, N, K(/vpw)] and
    the `{p}.mlp.gate` router) or HF's per-expert
    `{p}.mlp.experts.{e}.{name}.weight`. A float router stays dense in
    `dtype` (E x D is small and routing is precision-sensitive)."""

    def triplet(prefix: str):
        return (to_dev(t[f"{prefix}.weight"]), to_dev(t[f"{prefix}.scales"]),
                to_dev(t[f"{prefix}.biases"]))

    def router():
        prefix = f"{p}.mlp.gate"
        if f"{prefix}.scales" in t:
            return from_mlx_packing(*triplet(prefix), group_size, bits)
        return to_dev(t[f"{prefix}.weight"]).to(torch.float32).to(dtype)

    sw = f"{p}.mlp.switch_mlp"

    def stacked(name: str):
        key = f"{sw}.{name}.weight"
        if key in t:
            if f"{sw}.{name}.scales" in t:
                return from_mlx_packing_stacked(*triplet(f"{sw}.{name}"), group_size, bits)
            w = to_dev(t[key]).to(torch.float32)
        else:
            w = torch.stack([to_dev(t[f"{p}.mlp.experts.{e}.{name}.weight"]).to(torch.float32)
                             for e in range(cfg.num_experts)])
        return _maybe_quantize(w, quantized, group_size, bits, dtype)

    return MoEParams(w_router=router(), w_gate=stacked("gate_proj"), w_up=stacked("up_proj"),
                     w_down=stacked("down_proj"))


def load_params(
    model_dir: str,
    cfg: Qwen3Config | None = None,
    quantized: bool = True,
    group_size: int = GROUP_SIZE,
    bits: int = 4,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> tuple[Qwen3Params, Qwen3Config]:
    """Load a HF-format Qwen3 checkpoint onto `device`: (params, config).

    `dtype` is that of dense weights and of the norm vectors: bf16 to
    serve, f32 for the JAX package's oracle mode (an f32 model runs on the
    CPU only). MLX triplets are ingested whatever `quantized` says."""
    dev = check_device(device)
    cfg = cfg or load_config(model_dir)
    t = load_dir(model_dir)

    def to_dev(x: torch.Tensor) -> torch.Tensor:
        return x.to(device=dev, copy=True)  # a copy: never a view of the file's mapping

    def get_linear(prefix: str):
        if f"{prefix}.scales" in t:
            return from_mlx_packing(to_dev(t[f"{prefix}.weight"]), to_dev(t[f"{prefix}.scales"]),
                                    to_dev(t[f"{prefix}.biases"]), group_size, bits)
        w = to_dev(t[f"{prefix}.weight"]).to(torch.float32)
        return _maybe_quantize(w, quantized, group_size, bits, dtype)

    def get_array(name: str) -> torch.Tensor:
        return to_dev(t[name]).to(torch.float32).to(dtype)

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        attn = AttentionParams(
            wq=get_linear(f"{p}.self_attn.q_proj"), wk=get_linear(f"{p}.self_attn.k_proj"),
            wv=get_linear(f"{p}.self_attn.v_proj"), wo=get_linear(f"{p}.self_attn.o_proj"),
            q_norm=get_array(f"{p}.self_attn.q_norm.weight"),
            k_norm=get_array(f"{p}.self_attn.k_norm.weight"),
        )
        if cfg.is_moe_layer(i):
            mlp = _load_moe_mlp(t, p, cfg, to_dev, quantized, group_size, bits, dtype)
        else:
            mlp = MLPParams(w_gate=get_linear(f"{p}.mlp.gate_proj"),
                            w_up=get_linear(f"{p}.mlp.up_proj"),
                            w_down=get_linear(f"{p}.mlp.down_proj"))
        layers.append(BlockParams(
            input_layernorm=get_array(f"{p}.input_layernorm.weight"),
            post_attention_layernorm=get_array(f"{p}.post_attention_layernorm.weight"),
            attn=attn, mlp=mlp,
        ))
    params = Qwen3Params(
        embedding=get_linear("model.embed_tokens"),
        layers=layers,
        final_norm=get_array("model.norm.weight"),
        lm_head=None if cfg.tie_word_embeddings else get_linear("lm_head"),
    )
    return params, cfg
