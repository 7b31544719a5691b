"""Expert-parallel MoE with explicit token routing — counterpart of
tiny_llm_tpu/parallel/ep_moe.py.

The experts are split over one mesh axis and only tokens move, never
expert weights:

  1. The router runs replicated: every shard knows the whole sorted token
     order and the group sizes.
  2. Each shard takes the contiguous segment of the sorted token copies
     its experts own (a slice: the activations are replicated at the MoE
     input) and runs gate, up, SwiGLU and down through the grouped kernels
     on its local experts (ops/moe.py expert_rows).
  3. One sum of the shards' disjoint segments merges them: the receive
     half of the all-to-all, one collective a layer. Over ranks
     (ShardingConfig.rank_axis = `axis`) each rank holds its own experts'
     weights alone and runs its own segment; the segments are gathered
     and merged in shard order on every rank (ops/moe.py expert_rows).

`capacity_factor=None` is dropless (a shard's buffer holds every row). A
finite factor bounds a shard at ceil(T f / n) rows; the overflow is dropped
before the scores weight it (its contribution is 0). The segment's start,
length and capacity cut stay on the device, so a layer never syncs the
host.
"""

from __future__ import annotations

import math

import torch

from ..ops.moe import _unsort, expert_rows, num_experts, route_and_sort
from ..ops.sharded import ShardedWeight, shard_weight
from .sharding import ShardingConfig

__all__ = ["EPMoE"]


class EPMoE:
    """Expert-parallel sparse MLP over mesh axis `axis` (default tp).

    The expert weights may be unsharded (QuantizedTensor or dense [E, N, K];
    split here over the axis's devices) or ShardedWeights split on the
    expert dim over `axis` (shard_params; their parts may be split again on
    their features, the composed EP x TP). `__call__` matches
    ops.moe.moe_forward: x [B, L, D] -> [B, L, D]."""

    def __init__(self, scfg: ShardingConfig, w_router, w_gate, w_up, w_down,
                 num_experts_per_tok: int, norm_topk_prob: bool = False,
                 capacity_factor: float | None = None, axis: str | None = None,
                 impl: str | None = None):
        self.scfg = scfg
        self.axis = axis or scfg.tp_axis
        self.n = scfg.mesh.shape[self.axis]
        self.E = num_experts(w_gate)
        if self.E % self.n:
            raise ValueError(f"num_experts {self.E} must divide over {self.n} shards")
        devices = scfg.mesh.devices_along(self.axis)

        def split(w):
            if isinstance(w, ShardedWeight):
                if w.dim != "expert" or w.axis != self.axis:
                    raise ValueError(f"expert weights split on {w.dim!r} over {w.axis!r}, "
                                     f"not on the experts over {self.axis!r}")
                return w
            return shard_weight(w, "expert", self.axis, devices,
                                comm=scfg.axis_impl(self.axis))

        self.w_router = w_router
        self.w_gate, self.w_up, self.w_down = split(w_gate), split(w_up), split(w_down)
        self.k = num_experts_per_tok
        self.norm_topk_prob = norm_topk_prob
        self.capacity_factor = capacity_factor
        self.impl = impl

    def _capacity(self, T: int) -> int:
        if self.capacity_factor is None:
            return T  # dropless
        return min(T, max(1, math.ceil(T * self.capacity_factor / self.n)))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        k = self.k
        xs, order, sizes, scores = route_and_sort(x, self.w_router, k, self.norm_topk_prob,
                                                  self.E, self.impl)
        down = _unsort(expert_rows(xs, self.w_gate, self.w_up, self.w_down, sizes,
                                   capacity=self._capacity(B * L * k), impl=self.impl), order)
        # The JAX layer weights the merged rows in f32 (moe_forward in bf16).
        out = down.reshape(B, L, k, D).to(torch.float32) * scores[..., None]
        return out.sum(dim=-2).to(x.dtype)
