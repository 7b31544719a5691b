"""Mixture-of-Experts: top-k routing and the grouped expert matmul —
counterpart of tiny_llm_tpu/ops/moe.py.

Dense weights (a dense router [E, D], stacked experts [E, N, K]) follow
the JAX package's dense branches: the same routing, each projection an f32-
accumulated product rounded to the activations' dtype. On the card the
dense grouped product is one torch._grouped_mm over the group offsets,
which stay on the device (JAX's dense branch is ragged_dot, outside any
Pallas kernel); its plain version (the CPU, impl="torch") slices the rows
per expert, which reads the group sizes on the host.

The router is a W4A16 projection (K1); its bf16 logits go through an f32
softmax and a top-k that takes the lowest expert id among equal
probabilities, as jax.lax.top_k does. The k copies of each token are
sorted by expert id (a stable argsort) and the expert projections run on
the sorted rows through the grouped W4A16 kernel (kernels/moe_matmul.py).
Nothing here reads a device value on the host: the group sizes are counted
with scatter_add_ on the device (torch.bincount, boolean masks and nonzero
would each sync), so a MoE layer keeps a decode burst free of syncs.

Experts split over a mesh axis (a ShardedWeight on the expert dim,
ops/sharded.py) run as the JAX package's EPMoE body does (expert_rows):
each shard takes its contiguous segment of the sorted rows, a fixed C
rows from its first (C = the row count: dropless; or a capacity), runs
gate, up and down through the grouped kernel on its local experts, and
zeroes the rows past its segment; one sum merges the shards' disjoint
segments. The segment's start and length stay on the device. An expert
part split again on its features (composed EP x TP) runs part by part.
Experts replicated over a data-parallel axis run each replica's block of
the batch rows on its copies.
"""

from __future__ import annotations

import torch

from ..kernels.dispatch import resolve
from ..kernels.moe_matmul import grouped_quant_matmul
from ..kernels.quant_matmul import quant_matmul
from .basics import dense_linear, softmax, swiglu
from .quantize import QuantizedTensor
from .sharded import ShardedWeight, replica, replica_rows, sharded_apply


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
    w_router: QuantizedTensor | torch.Tensor,
    top_k: int,
    norm_topk_prob: bool = False,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Softmax router + top-k selection: (probs [..., E], ids [..., k],
    scores [..., k]). The logits are K1's bf16 output, or a dense router's
    product in x's dtype."""
    if isinstance(w_router, QuantizedTensor):
        logits = quant_matmul(x, w_router, impl=impl)
    elif w_router.dtype != x.dtype:  # promoted to f32, as JAX's dot_general promotes
        logits = dense_linear(x.float(), w_router.float()).to(x.dtype)
    else:
        logits = dense_linear(x, w_router)
    return select_topk(logits, top_k, norm_topk_prob)


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


def num_experts(w) -> int:
    """E of a stacked expert weight (quantized, dense or sharded)."""
    return w.shape[0] if torch.is_tensor(w) else w.num_experts


def grouped_matmul(
    grouped_x: torch.Tensor,  # [T, K], rows sorted by expert id
    w_stacked: QuantizedTensor | torch.Tensor | ShardedWeight,  # [E, N, K]
    group_sizes: torch.Tensor,  # [E] int32, sums to T (`partial`: at most T)
    impl: str | None = None,
    partial: bool = False,
) -> torch.Tensor:
    """Per-group matmul: rows of group e hit expert e's weight. -> [T, N]
    (bf16; a dense weight's in x's dtype). `partial`: the rows past the
    groups belong to no expert (the plain versions give 0 there, the
    kernels leave them unspecified). A weight split on its features runs
    part by part."""
    if isinstance(w_stacked, ShardedWeight):
        return sharded_apply(grouped_x, w_stacked, lambda xs, p, r: grouped_matmul(
            xs, p, group_sizes.to(xs.device), impl, partial))
    if isinstance(w_stacked, QuantizedTensor):
        return grouped_quant_matmul(grouped_x, w_stacked, group_sizes, impl=impl,
                                    partial=partial)
    if resolve(impl, grouped_x) == "cuda":
        offs = torch.cumsum(group_sizes, 0, dtype=torch.int32)
        return torch._grouped_mm(grouped_x, w_stacked.transpose(-2, -1), offs=offs)
    sizes = [int(n) for n in group_sizes.tolist()]
    tail = grouped_x.shape[0] - sum(sizes)
    if tail < 0 or (tail and not partial):
        raise ValueError(f"group sizes sum to {sum(sizes)}, x has {grouped_x.shape[0]} rows")
    parts = grouped_x.split(sizes + [tail])
    out = [dense_linear(xe, w_stacked[e]) for e, xe in enumerate(parts[:-1])]
    return torch.cat(out + [parts[-1].new_zeros((tail, w_stacked.shape[-2]))])


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
    order, sizes = sort_by_expert(expert_ids, num_experts(w_experts))
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
    same ids), which changes no value. Weights replicated over a
    data-parallel axis run each replica's block of the batch rows on that
    replica's copies."""
    if isinstance(w_gate, ShardedWeight) and w_gate.dim == "batch":
        return replica_rows(x, w_gate, lambda xs, s, _: moe_forward(
            xs, replica(w_router, s), w_gate.parts[s], w_up.parts[s], w_down.parts[s],
            num_experts_per_tok, norm_topk_prob, impl))
    B, L, D = x.shape
    k = num_experts_per_tok
    xs, order, sizes, scores = route_and_sort(x, w_router, k, norm_topk_prob, num_experts(w_gate),
                                              impl)
    down = _unsort(expert_rows(xs, w_gate, w_up, w_down, sizes, impl=impl), order)
    out = down.reshape(B, L, k, D) * scores[..., None].to(x.dtype)
    return out.to(torch.float32).sum(dim=-2).to(x.dtype)


def route_and_sort(x: torch.Tensor, w_router, top_k: int, norm_topk_prob: bool,
                   n_experts: int, impl: str | None = None):
    """Route x [B, L, D] and sort its token copies by expert: (rows [B L k,
    D], order, group sizes [E], scores [B, L, k])."""
    _, ids, scores = route_topk(x, w_router, top_k, norm_topk_prob, impl=impl)
    order, sizes = sort_by_expert(ids, n_experts)
    xs = x.reshape(-1, x.shape[-1]).index_select(0, order // top_k)  # each sorted row's token
    return xs, order, sizes, scores


def expert_rows(
    xs: torch.Tensor,  # [T, D] token copies sorted by expert
    w_gate, w_up, w_down,  # stacked [E, I, D], [E, I, D], [E, D, I]
    sizes: torch.Tensor,  # [E] int32
    capacity: int | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """swiglu(xs @ gate_e.T, xs @ up_e.T) @ down_e.T for each row's expert e,
    in the sorted order: [T, D]. Experts split over a mesh axis run shard
    by shard on their segments of the rows (see the module docstring),
    each at most `capacity` rows (None: dropless); rows dropped by the
    capacity give 0."""
    if not isinstance(w_gate, ShardedWeight):
        gate = grouped_matmul(xs, w_gate, sizes, impl=impl)
        up = grouped_matmul(xs, w_up, sizes, impl=impl)
        return grouped_matmul(swiglu(gate, up), w_down, sizes, impl=impl)
    if w_gate.dim != "expert":
        raise ValueError(f"expert weights split on {w_gate.dim!r}, not on the experts")
    T, D = xs.shape
    C = T if capacity is None else capacity
    home = xs.device
    zero = sizes.new_zeros(1)
    starts = torch.cat([zero, torch.cumsum(sizes, 0, dtype=torch.int32)])  # [E + 1]
    ar = torch.arange(C, device=home)
    padded = torch.cat([xs, xs.new_zeros((C, D))])
    frame = None
    for s, (e0, e1) in enumerate(w_gate.bounds):
        ends = torch.clamp(torch.cumsum(sizes[e0:e1], 0, dtype=torch.int32), max=C)
        idx = starts[e0].to(torch.long) + ar  # the shard's segment, C rows from its start
        dev = w_gate.devices[s]
        rows, sz = padded.index_select(0, idx).to(dev), torch.diff(ends, prepend=zero).to(dev)
        h = swiglu(grouped_matmul(rows, w_gate.parts[s], sz, impl, partial=True),
                   grouped_matmul(rows, w_up.parts[s], sz, impl, partial=True))
        out = grouped_matmul(h, w_down.parts[s], sz, impl, partial=True).to(home)
        out = torch.where((ar < ends[-1])[:, None], out, 0)
        if frame is None:
            frame = out.new_zeros((T + C, out.shape[-1]))
        frame.index_add_(0, idx, out)  # the shards' segments are disjoint
    return frame[:T]
