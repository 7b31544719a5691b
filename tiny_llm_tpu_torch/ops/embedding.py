"""Token embeddings, dense and quantized — counterpart of
tiny_llm_tpu/ops/embedding.py.

The quantized gather takes the selected rows' packed words, scales and
biases and dequantizes only those rows, at the weight's own bits and group
size: plain torch, as it is plain XLA in the JAX package. A quantized tied
head (`QuantizedEmbedding.as_linear`) is the quantized matmul: K1 on the
card.
"""

from __future__ import annotations

import torch

from .quantize import QuantizedTensor, quantized_linear, unpack_codes


def quantized_embedding_gather(qt: QuantizedTensor, ids: torch.Tensor) -> torch.Tensor:
    """ids [...] -> bf16 [..., in_features]."""
    flat = ids.reshape(-1).to(torch.long)
    G = qt.k_padded // qt.group_size
    vals = unpack_codes(qt.packed.index_select(0, flat), qt.bits).reshape(-1, G, qt.group_size)
    s = qt.scales.index_select(0, flat).to(torch.float32)[..., None]
    b = qt.biases.index_select(0, flat).to(torch.float32)[..., None]
    w = (vals.to(torch.float32) * s + b).reshape(-1, qt.k_padded)[:, : qt.in_features]
    return w.reshape(*ids.shape, qt.in_features).to(torch.bfloat16)


class Embedding:
    """Dense embedding table [vocab_size, embedding_dim]."""

    def __init__(self, vocab_size: int, embedding_dim: int, weight: torch.Tensor):
        if tuple(weight.shape) != (vocab_size, embedding_dim):
            raise ValueError(f"weight shape {tuple(weight.shape)} != "
                             f"({vocab_size}, {embedding_dim})")
        self.vocab_size = vocab_size
        self.embedding_dim = embedding_dim
        self.weight = weight

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        return self.weight[ids.to(torch.long)]

    def as_linear(self, x: torch.Tensor) -> torch.Tensor:
        """Tied LM head: x @ weight.T, f32 sums rounded to x's dtype once."""
        return torch.matmul(x.to(torch.float32), self.weight.to(torch.float32).T).to(x.dtype)


class QuantizedEmbedding:
    """Quantized embedding table [vocab_size, embedding_dim]."""

    def __init__(self, vocab_size: int, embedding_dim: int, weight: QuantizedTensor):
        if (weight.out_features, weight.in_features) != (vocab_size, embedding_dim):
            raise ValueError(f"weight shape ({weight.out_features}, {weight.in_features}) != "
                             f"({vocab_size}, {embedding_dim})")
        self.vocab_size = vocab_size
        self.embedding_dim = embedding_dim
        self.weight = weight

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        return quantized_embedding_gather(self.weight, ids)

    def as_linear(self, x: torch.Tensor) -> torch.Tensor:
        """Tied LM head through the quantized matmul."""
        return quantized_linear(x, self.weight)
