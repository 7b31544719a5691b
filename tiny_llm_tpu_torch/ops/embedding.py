"""Quantized token embedding — counterpart of tiny_llm_tpu/ops/embedding.py.

Gathers the selected rows' packed words, scales and biases and dequantizes
only those rows, at the weight's own bits and group size. Plain torch, as
it is plain XLA in the JAX package.
"""

from __future__ import annotations

import torch

from .quantize import QuantizedTensor, unpack_codes


def quantized_embedding_gather(qt: QuantizedTensor, ids: torch.Tensor) -> torch.Tensor:
    """ids [...] -> bf16 [..., in_features]."""
    flat = ids.reshape(-1).to(torch.long)
    G = qt.k_padded // qt.group_size
    vals = unpack_codes(qt.packed.index_select(0, flat), qt.bits).reshape(-1, G, qt.group_size)
    s = qt.scales.index_select(0, flat).to(torch.float32)[..., None]
    b = qt.biases.index_select(0, flat).to(torch.float32)[..., None]
    w = (vals.to(torch.float32) * s + b).reshape(-1, qt.k_padded)[:, : qt.in_features]
    return w.reshape(*ids.shape, qt.in_features).to(torch.bfloat16)
