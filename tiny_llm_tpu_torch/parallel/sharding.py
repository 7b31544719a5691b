"""Tensor-parallel sharding rules for Qwen3 params and KV caches —
counterpart of tiny_llm_tpu/parallel/sharding.py.

Megatron-style TP, as in the JAX package:

  * q/k/v projections and MLP gate/up: split on out-features over `tp`
    (whole attention heads per shard);
  * o_proj and MLP down: split on in-features over `tp`, the partial
    products summed after the matmul (the psum GSPMD inserts);
  * MoE expert stacks: split on the expert axis, over `ep_axis` when it is
    set (and then each expert's features over `tp`: gate/up on out-, down
    on in-features), else over `tp`;
  * embedding, LM head, norms and the router: replicated;
  * KV caches: batch on `dp`, KV heads on `tp`.

Specs are tuples of mesh axis names or None, one entry per axis of the
port's own layout (ops/quantize.py: packed [(E,) N, K words], scales and
biases [(E,) N, G]); each names the same logical axis as the JAX
package's spec of that leaf (whose "magic_t" layout stores [K, N]). The
quant-group axis G of a W4 g128 weight's scales and biases is never
partitioned, as the JAX package replicates it: an in-feature part keeps
the groups its columns touch (ops/sharded.py). Other widths split G with
K, as the JAX "sg" layout does.

`shard_params` is the counterpart of jax.device_put with a NamedSharding:
each split weight becomes an ops.sharded.ShardedWeight whose parts are
copies on the mesh devices along its axis; over a dp axis, each matmul
weight is replicated, one copy a replica (GSPMD's replication over dp),
and each replica's copy serves its block of the batch rows. The model's
matmuls need nothing else (models/qwen3.py runs a sharded weight part by
part).
"""

from __future__ import annotations

import dataclasses

from ..models.qwen3 import AttentionParams, MLPParams, MoEParams, Qwen3Params
from ..ops.quantize import QuantizedTensor
from ..ops.sharded import (ShardedWeight, in_features_of, out_features_of, replicate,
                           shard_weight)
from .mesh import Mesh


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    mesh: Mesh
    tp_axis: str = "tp"
    dp_axis: str = "dp"
    # Composed EP x TP: the MoE expert axis's mesh axis; None shards experts
    # over tp_axis.
    ep_axis: str | None = None


def _qt_spec(w: QuantizedTensor, row, col, expert=None) -> QuantizedTensor:
    """The QuantizedTensor of specs for (row = N, col = K) axes."""
    lead = () if w.num_experts is None else (expert,)
    group = None if w.is_w4g128 else col  # JAX's magic_t replicates G, its sg splits it
    return dataclasses.replace(w, packed=(*lead, row, col), scales=(*lead, row, group),
                               biases=(*lead, row, group))


def _spec_for_linear(w, row, col, expert=None):
    """The spec of one linear weight (dense tensor or QuantizedTensor)."""
    if w is None:
        return None
    if isinstance(w, QuantizedTensor):
        return _qt_spec(w, row, col, expert)
    return (expert, row, col) if w.ndim == 3 else (row, col)


def param_shardings(params: Qwen3Params, cfg: ShardingConfig) -> Qwen3Params:
    """A tree of specs with `params`' structure. Unfused (wq, wk, wv, w_gate,
    w_up) and fused (wqkv interleaved per KV head, w_gate_up) projections
    both take the out-feature split: a fused weight's parts hold whole KV
    heads, or [gate_s; up_s] (ops/sharded.py)."""
    tp = cfg.tp_axis

    def attn_spec(a: AttentionParams):
        return dataclasses.replace(
            a,
            wq=_spec_for_linear(a.wq, tp, None), wk=_spec_for_linear(a.wk, tp, None),
            wv=_spec_for_linear(a.wv, tp, None), wqkv=_spec_for_linear(a.wqkv, tp, None),
            wo=_spec_for_linear(a.wo, None, tp), q_norm=(None,), k_norm=(None,),
        )

    def mlp_spec(m):
        if isinstance(m, MoEParams):
            router = _spec_for_linear(m.w_router, None, None)
            if cfg.ep_axis is not None:
                ep = cfg.ep_axis
                return MoEParams(w_router=router, w_gate=_spec_for_linear(m.w_gate, tp, None, ep),
                                 w_up=_spec_for_linear(m.w_up, tp, None, ep),
                                 w_down=_spec_for_linear(m.w_down, None, tp, ep))
            return MoEParams(w_router=router, w_gate=_spec_for_linear(m.w_gate, None, None, tp),
                             w_up=_spec_for_linear(m.w_up, None, None, tp),
                             w_down=_spec_for_linear(m.w_down, None, None, tp))
        return MLPParams(w_gate=_spec_for_linear(m.w_gate, tp, None),
                         w_up=_spec_for_linear(m.w_up, tp, None),
                         w_down=_spec_for_linear(m.w_down, None, tp),
                         w_gate_up=_spec_for_linear(m.w_gate_up, tp, None))

    return Qwen3Params(
        embedding=_spec_for_linear(params.embedding, None, None),
        layers=[dataclasses.replace(b, input_layernorm=(None,), post_attention_layernorm=(None,),
                                    attn=attn_spec(b.attn), mlp=mlp_spec(b.mlp))
                for b in params.layers],
        final_norm=(None,),
        lm_head=_spec_for_linear(params.lm_head, None, None),
    )


# The matmul weights of a layer's attention and MLP (MoE router included).
_MATMULS = ("wq", "wk", "wv", "wqkv", "wo", "w_gate", "w_up", "w_down", "w_gate_up", "w_router")


def shard_params(params: Qwen3Params, cfg: ShardingConfig) -> Qwen3Params:
    """`params` with each weight that param_shardings splits replaced by a
    ShardedWeight: parts copied onto the mesh devices along the split axis,
    contiguous. Replicated leaves stay as they are. Heads need Hq and Hkv
    divisible by tp; experts, E by their axis.

    Over a dp axis of more than one replica every matmul weight (the LM
    head and the router too) is replicated (ops/sharded.py replicate):
    replica r's copy, split over the tp devices at dp = r, serves the r-th
    block of the batch rows. The embedding gather and the norms run on the
    model's device for every row."""
    for b in params.layers:
        for w in (b.attn.wq, b.attn.wqkv, b.attn.wo):
            if isinstance(w, ShardedWeight):
                raise ValueError("params are sharded already")
    mesh, dp = cfg.mesh, cfg.dp_axis
    n_dp = mesh.shape.get(dp, 1)
    if n_dp == 1:
        return _shard_replica(params, cfg, {})
    reps = [_shard_replica(params, cfg, {dp: r}) for r in range(n_dp)]
    devs = mesh.devices_along(dp)

    def merge(objs):
        return dataclasses.replace(objs[0], **{
            f.name: None if getattr(objs[0], f.name) is None
            else replicate([getattr(o, f.name) for o in objs], dp, devs)
            for f in dataclasses.fields(objs[0]) if f.name in _MATMULS})

    return dataclasses.replace(
        params,
        layers=[dataclasses.replace(b, attn=merge([r.layers[i].attn for r in reps]),
                                    mlp=merge([r.layers[i].mlp for r in reps]))
                for i, b in enumerate(params.layers)],
        lm_head=None if params.lm_head is None
        else replicate([r.lm_head for r in reps], dp, devs))


def _shard_replica(params: Qwen3Params, cfg: ShardingConfig, at: dict) -> Qwen3Params:
    """One replica's params: the TP and EP splits over the devices at mesh
    position `at` ({} for a mesh of one replica); the LM head and router
    moved to the replica's device where `at` names a replica."""
    mesh, tp = cfg.mesh, cfg.tp_axis
    tp_devs = mesh.devices_along(tp, **at)

    def home(w):
        return w if w is None or not at else w.to(tp_devs[0])

    def heads(w, rows_per_head):
        return None if w is None else shard_weight(w, "out", tp, tp_devs, unit=rows_per_head)

    def attn(a: AttentionParams):
        d, wo = a.q_norm.shape[-1], shard_weight(a.wo, "in", tp, tp_devs)
        if a.wqkv is not None:
            n, k = out_features_of(a.wqkv), in_features_of(a.wo)  # hkv (n_rep + 2) d, hkv n_rep d
            return dataclasses.replace(a, wqkv=heads(a.wqkv, n // ((n - k) // (2 * d))), wo=wo)
        n_rep = out_features_of(a.wq) // out_features_of(a.wk)
        return dataclasses.replace(a, wq=heads(a.wq, n_rep * d), wk=heads(a.wk, d),
                                   wv=heads(a.wv, d), wo=wo)

    def experts(w, feature_dim):
        if cfg.ep_axis is None:
            return shard_weight(w, "expert", tp, tp_devs)
        ep = cfg.ep_axis
        outer = shard_weight(w, "expert", ep, mesh.devices_along(ep, **at))
        return dataclasses.replace(outer, parts=tuple(
            shard_weight(p, feature_dim, tp, mesh.devices_along(tp, **at, **{ep: e}))
            for e, p in enumerate(outer.parts)))

    def mlp(m):
        if isinstance(m, MoEParams):
            return dataclasses.replace(m, w_router=home(m.w_router),
                                       w_gate=experts(m.w_gate, "out"),
                                       w_up=experts(m.w_up, "out"),
                                       w_down=experts(m.w_down, "in"))
        if m.w_gate_up is not None:
            return dataclasses.replace(
                m, w_gate_up=shard_weight(m.w_gate_up, "out", tp, tp_devs, halves=True),
                w_down=shard_weight(m.w_down, "in", tp, tp_devs))
        return dataclasses.replace(m, w_gate=shard_weight(m.w_gate, "out", tp, tp_devs),
                                   w_up=shard_weight(m.w_up, "out", tp, tp_devs),
                                   w_down=shard_weight(m.w_down, "in", tp, tp_devs))

    return dataclasses.replace(params, lm_head=home(params.lm_head), layers=[
        dataclasses.replace(b, attn=attn(b.attn), mlp=mlp(b.mlp)) for b in params.layers])


def kv_cache_spec(cfg: ShardingConfig) -> tuple:
    """[num_layers, B, H_kv, S, D] slab: batch on dp, KV heads on tp."""
    return (None, cfg.dp_axis, cfg.tp_axis, None, None)


def shard_kv_cache(cache, cfg: ShardingConfig):
    """Mark a dense KV cache's slabs as sharded by kv_cache_spec. The slab
    stays one tensor: the attention strategies (tp_kernels.TPAttention)
    take each shard's heads (and rows, over dp) as a view of it, copied to
    the shard's device where that is another. Raises where the batch or the
    KV heads do not divide over the mesh."""
    shape = cfg.mesh.shape
    B, hkv = cache.keys.shape[1], cache.keys.shape[2]
    if B % shape.get(cfg.dp_axis, 1) or hkv % shape[cfg.tp_axis]:
        raise ValueError(f"batch {B} / KV heads {hkv} do not divide over the mesh {shape}")
    cache.spec = kv_cache_spec(cfg)
    return cache
