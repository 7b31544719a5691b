"""Helpers for the tests that hold tiny_llm_tpu_torch against tiny_llm_tpu.

Only tests import both packages; data crosses between them as numpy."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

import tiny_llm_tpu.kernels as jax_kernels
from tiny_llm_tpu.ops.quantize import QuantizedTensor as JaxQT


@contextlib.contextmanager
def jax_k1_on_pallas():
    """Inside the block the JAX package's dense quantized matmuls take their
    Pallas route in interpret mode: the functions the port's K1 replaces
    (the decode schedule at <= 32 rows, the staged schedule above, which
    rounds q * s to bf16 as K1's staged tile does), where the JAX model on
    the CPU would otherwise take the XLA route. `quantized_linear` looks
    `quantized_matmul` up at every call, so the JAX models traced inside
    the block take it; nothing of the JAX package is edited."""
    orig = jax_kernels.quantized_matmul

    def pallas(*args, **kwargs):
        return orig(*args, **{**kwargs, "impl": "pallas", "interpret": True})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_kernels, "quantized_matmul", pallas)
        yield


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


# Logit tolerance (bf16 ladder, absolute), as tests/test_torch_model.py.
LOGIT_ATOL = 3e-2


def teacher_forced(jm, pm, chunks, steps, seed: int = 11):
    """Logits of a JAX and a port model over prompt chunks (one cache each)
    then `steps` decode steps, both fed the JAX model's greedy tokens:
    [(jax, port)] float32 numpy [L, V] per call."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    prompt = [int(t) for t in rng.integers(0, pm.vocab_size, size=sum(chunks))]
    cj, cp = jm.create_kv_cache(), pm.create_kv_cache()
    calls, off = [], 0
    for L in chunks:
        chunk = [prompt[off : off + L]]
        calls.append((np.asarray(jm(jnp.asarray(chunk, jnp.int32), off, cj), np.float32)[0],
                      f32(pm(chunk, off, cp)[0])))
        off += L
    for _ in range(steps):
        tok = int(np.argmax(calls[-1][0][-1]))
        calls.append((np.asarray(jm(jnp.asarray([[tok]], jnp.int32), off, cj), np.float32)[0],
                      f32(pm([[tok]], off, cp)[0])))
        off += 1
    return calls


def assert_logit_calls(calls, skip=frozenset(), atol: float = LOGIT_ATOL):
    """Each call's port logits within `atol` of JAX's and top-1 equal where
    JAX's top-2 gap exceeds 2 * atol; positions (call, row) in `skip` are
    left out."""
    for c, (want, got) in enumerate(calls):
        keep = [t for t in range(want.shape[0]) if (c, t) not in skip]
        want, got = want[keep], got[keep]
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
        top2 = np.sort(want, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * atol
        np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])
