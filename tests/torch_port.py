"""Helpers for the tests that hold tiny_llm_tpu_torch against tiny_llm_tpu.

Only tests import both packages; data crosses between them as numpy."""

from __future__ import annotations

import numpy as np

from tiny_llm_tpu.ops.quantize import QuantizedTensor as JaxQT


def qt_to_numpy(qt: JaxQT) -> dict:
    """A JAX QuantizedTensor as the bridge's dict of numpy arrays + static fields."""
    return {
        "packed": np.asarray(qt.packed),
        "scales": np.asarray(qt.scales),
        "biases": np.asarray(qt.biases),
        "layout": qt.layout,
        "group_size": qt.group_size,
        "bits": qt.bits,
        "out_features": qt.out_features,
        "in_features": qt.in_features,
        "k_padded": qt.k_padded,
    }


def params_to_numpy(params) -> dict:
    """The JAX package's unfused Qwen3Params as the bridge's nested dict."""
    layers = []
    for layer in params.layers:
        a, m = layer.attn, layer.mlp
        layers.append({
            "input_layernorm": np.asarray(layer.input_layernorm),
            "post_attention_layernorm": np.asarray(layer.post_attention_layernorm),
            "attn": {
                "wq": qt_to_numpy(a.wq), "wk": qt_to_numpy(a.wk),
                "wv": qt_to_numpy(a.wv), "wo": qt_to_numpy(a.wo),
                "q_norm": np.asarray(a.q_norm), "k_norm": np.asarray(a.k_norm),
            },
            "mlp": {
                "w_gate": qt_to_numpy(m.w_gate), "w_up": qt_to_numpy(m.w_up),
                "w_down": qt_to_numpy(m.w_down),
            },
        })
    return {
        "embedding": qt_to_numpy(params.embedding),
        "lm_head": None if params.lm_head is None else qt_to_numpy(params.lm_head),
        "final_norm": np.asarray(params.final_norm),
        "layers": layers,
    }


def f32(x) -> np.ndarray:
    """Any JAX array or torch tensor as a float32 numpy array."""
    if hasattr(x, "detach"):
        return x.detach().to("cpu").float().numpy()
    return np.asarray(x, dtype=np.float32)


def bf16_numpy(x: np.ndarray):
    """The same values as a JAX bf16 array and a torch bf16 tensor."""
    import jax.numpy as jnp
    import torch

    j = jnp.asarray(x, dtype=jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(torch.bfloat16)
    return j, t
