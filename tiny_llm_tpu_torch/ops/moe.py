"""Mixture-of-Experts: top-k routing and the grouped expert matmul —
counterpart of tiny_llm_tpu/ops/moe.py.

The router is a W4A16 projection (K1); its bf16 logits go through an f32
softmax and a top-k that takes the lowest expert id among equal
probabilities, as jax.lax.top_k does. The k copies of each token are
sorted by expert id (a stable argsort) and the expert projections run on
the sorted rows through the grouped W4A16 kernel (kernels/moe_matmul.py).
Nothing here reads a device value on the host: the group sizes are counted
with scatter_add_ on the device (torch.bincount, boolean masks and nonzero
would each sync), so a MoE layer keeps a decode burst free of syncs.
"""

from __future__ import annotations

import torch

from ..kernels.moe_matmul import grouped_quant_matmul
from ..kernels.quant_matmul import quant_matmul
from .basics import softmax, swiglu
from .quantize import QuantizedTensor


def select_topk(
    router_logits: torch.Tensor, top_k: int, norm_topk_prob: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router logits [..., E] -> (probs f32 [..., E], expert ids int64
    [..., k], scores f32 [..., k]), ids by descending probability.

    A stable descending sort cut at k: among equal probabilities the lowest
    id comes first, as in jax.lax.top_k (torch.topk breaks ties otherwise,
    and bf16 logits tie often among 128 experts)."""
    probs = softmax(router_logits.to(torch.float32), dim=-1)
    scores, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    scores, ids = scores[..., :top_k], ids[..., :top_k]
    if norm_topk_prob:
        scores = scores / scores.sum(dim=-1, keepdim=True)
    return probs, ids, scores


def route_topk(
    x: torch.Tensor,
    w_router: QuantizedTensor,
    top_k: int,
    norm_topk_prob: bool = False,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax router + top-k selection: (probs [..., E], ids [..., k],
    scores [..., k]). The logits are K1's bf16 output."""
    return select_topk(quant_matmul(x, w_router, impl=impl), top_k, norm_topk_prob)


def sort_by_expert(
    expert_ids: torch.Tensor, num_experts: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat expert ids [R] -> (order [R], group_sizes int32 [E]): rows
    order[i] sorted by expert (ties in row order), expert e owning
    group_sizes[e] consecutive sorted rows."""
    ids = expert_ids.reshape(-1)
    order = torch.argsort(ids, stable=True)
    sizes = torch.zeros((num_experts,), dtype=torch.int32, device=ids.device)
    sizes.scatter_add_(0, ids.to(torch.long), torch.ones_like(ids, dtype=torch.int32))
    return order, sizes


def grouped_matmul(
    grouped_x: torch.Tensor,  # [T, K], rows sorted by expert id
    w_stacked: QuantizedTensor,  # [E, N, K]
    group_sizes: torch.Tensor,  # [E] int32, sums to T
    impl: str | None = None,
) -> torch.Tensor:
    """Per-group matmul: rows of group e hit expert e's weight. -> [T, N] bf16."""
    return grouped_quant_matmul(grouped_x, w_stacked, group_sizes, impl=impl)


def _unsort(sorted_rows: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows back in their original order: out[order[i]] = sorted_rows[i]."""
    return torch.empty_like(sorted_rows).index_copy_(0, order, sorted_rows)


def grouped_expert_linear(
    x: torch.Tensor,  # [..., K]
    w_experts: QuantizedTensor,  # stacked [E, N, K]
    expert_ids: torch.Tensor,  # [...] one expert id per row of x
    impl: str | None = None,
) -> torch.Tensor:
    """Sort rows by expert id, run the grouped matmul, restore row order."""
    *lead, K = x.shape
    order, sizes = sort_by_expert(expert_ids, w_experts.num_experts)
    out = grouped_matmul(x.reshape(-1, K).index_select(0, order), w_experts, sizes, impl=impl)
    return _unsort(out, order).reshape(*lead, -1)


def moe_forward(
    x: torch.Tensor,  # [B, L, D]
    w_router: QuantizedTensor,
    w_gate: QuantizedTensor,
    w_up: QuantizedTensor,
    w_down: QuantizedTensor,
    num_experts_per_tok: int,
    norm_topk_prob: bool = False,
    impl: str | None = None,
) -> torch.Tensor:
    """The sparse MLP: route, then gate/up/down per expert on the token
    copies, weighted by the scores and summed over the k experts.

    Rounding points as the JAX package's: each projection rounds to bf16,
    silu(gate) * up in bf16, the scores cast to bf16 before the bf16
    product, the sum over k (in f32) cast to bf16. The JAX package sorts
    the rows once per projection; the three share one sort here (the
    same ids), which changes no value."""
    B, L, D = x.shape
    k = num_experts_per_tok
    _, ids, scores = route_topk(x, w_router, k, norm_topk_prob, impl=impl)
    order, sizes = sort_by_expert(ids, w_gate.num_experts)
    xs = x.reshape(-1, D).index_select(0, order // k)  # each sorted row's token
    gate = grouped_matmul(xs, w_gate, sizes, impl=impl)
    up = grouped_matmul(xs, w_up, sizes, impl=impl)
    down = _unsort(grouped_matmul(swiglu(gate, up), w_down, sizes, impl=impl), order)
    out = down.reshape(B, L, k, D) * scores[..., None].to(x.dtype)
    return out.to(torch.float32).sum(dim=-2).to(x.dtype)
