"""Qwen3 and Qwen3-MoE — PyTorch/CUDA counterpart of tiny_llm_tpu/models/qwen3.py.

Group-quantized weights (2, 4 or 8 bits, groups of 32, 64 or 128; W4A16
g128 by default, W4A8 with act_quant="int8"), GQA attention with
QK-RMSNorm and RoPE, SwiGLU MLP or a top-k mixture of SwiGLU experts per
layer, pre-norm residual blocks, tied or untied LM head. The same routes
run on the card and on the CPU; only the bodies of the kernels differ
(kernels/dispatch.py):

  * every dense projection, the MoE router and the LM head go through
    kernels/quant_matmul: K1 for W4 g128 weights, the W4A8 kernel for
    act="int8" weights at <= 32 rows, the any-width kernel for the others;
  * a MoE layer's expert projections go through kernels/moe_matmul (via
    ops/moe.py), which dispatches the same way (W4A8 at <= 128 rows);
  * a decode step (L == 1) goes through K2 (kernels/fused_decode_attention)
    with the qkv projection fused and interleaved per KV head — over the
    dense slab, or its paged twin over the page pool; with
    `paged_fused_one=False` (TLT_PAGED_FUSED_ONE=0, read once at
    construction, as in the JAX package) a paged decode step takes the
    JAX package's three-launch route instead, here two launches per layer:
    the prep kernel (qkv split, QK-norm, RoPE, and the page write), then
    the paged decode kernel over the pages;
  * a prompt chunk goes through K3 (kernels/flash_attention) over the slab,
    or, over the page pool: K3 on the chunk's own K/V when the chunk is the
    whole context (offset 0); the split paged prefill (kernels/split_prefill:
    the chunk-state and prefix-state kernels, combined) for chunks of >= 1024
    tokens at offset > 0; else the paged decode (L <= 16) or paged prefill
    kernel (kernels/paged_attention);
  * a mixed burst step (forward_mixed_burst_paged) runs B decode rows and a
    c-token prefill sub-chunk through the same projections, the decode rows
    through the fused paged step (with `paged_fused_one=False`: the same
    route as a decode step, whose values are the JAX package's
    unfused mixed rows) and the sub-chunk through paged attention over its
    own pages;
  * with an attention strategy (`attn_impl`, e.g. parallel.SPAttention) the
    strategy runs every attention, as in the JAX package: a decode step
    takes the unfused route (qkv, the k/v write, then the strategy's
    attention), the split prefill and mixed bursts are off, and the
    matmuls keep `impl`.

A weight is a QuantizedTensor or a dense [N, K] tensor (bf16, or f32 for
the JAX package's oracle mode; models/loader.py load_params(quantized=
False)): a dense projection is torch.matmul, accumulated in f32 and rounded
to the activations' dtype, the residual added after that rounding, as
dot_general(preferred_element_type=f32) is in the JAX package (a product
it computes outside any Pallas kernel); a dense embedding is a row gather,
a dense MoE router and stacked experts follow ops/moe.py's dense branches.
A dense model's activations, KV slab and pages take the embedding's dtype.
The kernels take bf16 only, so an f32 model runs on the CPU (the plain
versions follow the JAX XLA route for f32 inputs) and raises on the card.

The KV slab and the pages are updated in place. A decode burst, mixed or
not, is a Python loop of steps whose greedy argmax stays on the device; the
host syncs once per burst. Weights split over a mesh (parallel/sharding.py
shard_params, ops/sharded.py) run part by part in the same routes; a MoE
layer's experts split over a mesh axis run each shard on its segment of
the sorted rows (ops/moe.py); weights replicated over a data-parallel axis
run each replica's block of the batch rows on that replica's copy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.fused_decode_attention import (
    fused_decode_attention,
    fused_paged_decode_attention,
    fused_qkv_prep,
)
from ..kernels.paged_attention import paged_attention
from ..kernels.quant_matmul import quant_matmul
from ..kernels.dispatch import check_device
from ..kernels.split_prefill import split_paged_prefill
from ..kv.cache import BatchingKVCache, DenseKVCache, bucket_for
from ..kv.paged import PagedBatchingKVCache, PagedKVCache, PagePool
from ..ops.basics import dense_linear, swiglu
from ..ops.embedding import quantized_embedding_gather
from ..ops.moe import moe_forward
from ..ops.norm import rms_norm
from ..ops.quantize import QuantizedTensor, concat_out_features, permute_out_features
from ..ops.rope import apply_rope, rope_tables
from ..ops.sampler import make_sampler
from ..ops.sharded import ShardedWeight, out_features_of, replica_rows, sharded_linear, zip_parts


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    num_hidden_layers: int
    hidden_size: int
    num_attention_heads: int
    num_key_value_heads: int
    head_dim: int
    intermediate_size: int
    vocab_size: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = True
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    decoder_sparse_step: int = 1
    mlp_only_layers: tuple[int, ...] = ()
    norm_topk_prob: bool = False

    def is_moe_layer(self, layer_idx: int) -> bool:
        """Whether layer `layer_idx` is sparse (the JAX package's predicate)."""
        return (
            self.num_experts > 0
            and layer_idx not in self.mlp_only_layers
            and (layer_idx + 1) % max(self.decoder_sparse_step, 1) == 0
        )

    @staticmethod
    def from_hf_dict(d: dict) -> "Qwen3Config":
        """A HF config.json's dict, with the JAX package's defaults."""
        return Qwen3Config(
            num_hidden_layers=d["num_hidden_layers"],
            hidden_size=d["hidden_size"],
            num_attention_heads=d["num_attention_heads"],
            num_key_value_heads=d["num_key_value_heads"],
            head_dim=d.get("head_dim", d["hidden_size"] // d["num_attention_heads"]),
            intermediate_size=d["intermediate_size"],
            vocab_size=d["vocab_size"],
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 1_000_000.0),
            max_position_embeddings=d.get("max_position_embeddings", 32768),
            tie_word_embeddings=d.get("tie_word_embeddings", True),
            num_experts=d.get("num_experts", 0),
            num_experts_per_tok=d.get("num_experts_per_tok", 0),
            moe_intermediate_size=d.get("moe_intermediate_size", 0),
            decoder_sparse_step=d.get("decoder_sparse_step", 1),
            mlp_only_layers=tuple(d.get("mlp_only_layers", ())),
            norm_topk_prob=d.get("norm_topk_prob", False),
        )


# ---------------------------------------------------------------------------
# Params: plain dataclasses of tensors and QuantizedTensors. A weight (Weight)
# is a QuantizedTensor or a dense tensor [N, K] ([E, N, K] for experts), or
# a ShardedWeight of either (parallel/sharding.py shard_params).
# ---------------------------------------------------------------------------

Weight = QuantizedTensor | torch.Tensor | ShardedWeight


@dataclasses.dataclass
class AttentionParams:
    wq: Weight | None
    wk: Weight | None
    wv: Weight | None
    wo: Weight
    q_norm: torch.Tensor
    k_norm: torch.Tensor
    # Fused [q; k; v] projection (fuse_projections), rows ordered per KV
    # head as [q_{h*n_rep} .. q_{(h+1)*n_rep-1}, k_h, v_h].
    wqkv: Weight | None = None


@dataclasses.dataclass
class MLPParams:
    w_gate: Weight | None
    w_up: Weight | None
    w_down: Weight
    w_gate_up: Weight | None = None  # fused [gate; up]


@dataclasses.dataclass
class MoEParams:
    w_router: Weight  # [E, D]
    w_gate: Weight  # stacked [E, I, D]
    w_up: Weight  # stacked [E, I, D]
    w_down: Weight  # stacked [E, D, I]


@dataclasses.dataclass
class BlockParams:
    input_layernorm: torch.Tensor
    post_attention_layernorm: torch.Tensor
    attn: AttentionParams
    mlp: MLPParams | MoEParams


@dataclasses.dataclass
class Qwen3Params:
    embedding: Weight
    layers: list[BlockParams]
    final_norm: torch.Tensor
    lm_head: Weight | None = None  # None: tied to the embedding


def _linear(x, w: Weight, residual=None, impl=None):
    """x @ w.T (+ residual: added in f32 inside K1 for a quantized weight,
    after the product's rounding for a dense one, as in the JAX package; a
    sharded weight runs part by part, ops/sharded.py; a weight replicated
    over a data-parallel axis runs each replica's block of rows on its
    copy)."""
    if isinstance(w, ShardedWeight):
        if w.dim == "batch":
            return replica_rows(x, w, lambda xs, s, r: _linear(xs, w.parts[s], r, impl), residual)
        return sharded_linear(x, w, residual=residual, impl=impl)
    if isinstance(w, QuantizedTensor):
        return quant_matmul(x, w, residual=residual, impl=impl)
    out = dense_linear(x, w)
    return out if residual is None else out + residual


def _norm_linear(x, w: Weight, norm_w, eps: float, impl=None):
    """rms_norm(x) @ w.T. The JAX package keeps its fused-norm prologue off
    (FUSE_NORM_ENABLED = False), so the norm is a separate op there too."""
    if norm_w is not None:
        x = rms_norm(x, norm_w, eps)
    return _linear(x, w, impl=impl)


def act_dtype(params: Qwen3Params) -> torch.dtype:
    """The activations' (and KV's) dtype: bf16 for quantized weights, else
    the dense embedding's (bf16, or f32 in the JAX package's oracle mode)."""
    emb = params.embedding
    return torch.bfloat16 if isinstance(emb, QuantizedTensor) else emb.dtype


def _embed(params: Qwen3Params, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(params.embedding, QuantizedTensor):
        return quantized_embedding_gather(params.embedding, tokens)
    # A dense embedding keeps its dtype, so the whole forward runs in it.
    return params.embedding[tokens]


def _lm_head(params: Qwen3Params, h: torch.Tensor, impl=None) -> torch.Tensor:
    w = params.lm_head if params.lm_head is not None else params.embedding
    return _linear(h, w, impl=impl)


def _split_qkv_rope(cfg: Qwen3Config, p: AttentionParams, qkv, positions, rope_tabs):
    """Interleaved fused qkv activation [B, L, F] -> QK-RMSNorm + RoPE ->
    q [B, Hq, L, D], k/v [B, Hkv, L, D]."""
    B, L, _ = qkv.shape
    cos_t, sin_t = rope_tabs
    hd, hq, hkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    nr = hq // hkv
    rows = qkv.reshape(B, L, hkv, (nr + 2) * hd)
    q = rows[..., : nr * hd].reshape(B, L, hq, hd)
    k = rows[..., nr * hd : (nr + 1) * hd]
    v = rows[..., (nr + 1) * hd :]
    q = apply_rope(rms_norm(q, p.q_norm, cfg.rms_norm_eps), cos_t, sin_t, positions, hd)
    k = apply_rope(rms_norm(k, p.k_norm, cfg.rms_norm_eps), cos_t, sin_t, positions, hd)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _qkv(cfg, p: AttentionParams, x, positions, rope_tabs, norm_w=None, impl=None):
    """[pre-norm +] fused qkv projection + QK-RMSNorm + RoPE."""
    qkv = _norm_linear(x, p.wqkv, norm_w, cfg.rms_norm_eps, impl)
    return _split_qkv_rope(cfg, p, qkv, positions, rope_tabs)


def _mlp(cfg, p: MLPParams | MoEParams, x, norm_w=None, residual=None, impl=None):
    """[pre-norm +] fused gate/up, SwiGLU, down [+ residual, added inside K1];
    or, for a MoE layer, [pre-norm +] moe_forward [+ residual, a bf16 add
    as in the JAX package]."""
    if isinstance(p, MoEParams):
        if norm_w is not None:
            x = rms_norm(x, norm_w, cfg.rms_norm_eps)  # router and experts share it
        out = moe_forward(x, p.w_router, p.w_gate, p.w_up, p.w_down,
                          cfg.num_experts_per_tok, cfg.norm_topk_prob, impl=impl)
        return out if residual is None else out + residual
    gu = _norm_linear(x, p.w_gate_up, norm_w, cfg.rms_norm_eps, impl)
    half = gu.shape[-1] // 2
    return _linear(swiglu(gu[..., :half], gu[..., half:]), p.w_down, residual=residual,
                   impl=impl)


def _qkv_interleave_perm(attn: AttentionParams) -> list[int]:
    """Row order interleaving the fused [q; k; v] per KV head (see
    AttentionParams.wqkv). Head counts come from the weights, D from the
    QK-norm weight."""
    return _interleave_perm(attn.wq, attn.wk, attn.wv, attn.q_norm.shape[-1])


def _interleave_perm(wq: Weight, wk: Weight, wv: Weight, d: int) -> list[int]:
    dq, dk, dv = (out_features_of(w) for w in (wq, wk, wv))
    if dk != dv or dq % d or dk % d or dq % dk:
        raise ValueError(f"q/k/v rows {dq}/{dk}/{dv} are not a GQA layout of head dim {d}")
    hkv = dk // d
    nr = dq // dk
    idx: list[int] = []
    for h in range(hkv):
        idx.extend(range(h * nr * d, (h + 1) * nr * d))
        idx.extend(range(dq + h * d, dq + (h + 1) * d))
        idx.extend(range(dq + dk + h * d, dq + dk + (h + 1) * d))
    return idx


def _concat_rows(ws: list[Weight]) -> Weight:
    if all(isinstance(w, QuantizedTensor) for w in ws):
        return concat_out_features(ws)
    if any(isinstance(w, QuantizedTensor) for w in ws):
        raise ValueError("cannot fuse quantized and dense projections")
    return torch.cat(ws, dim=0)


def _permute_rows(w: Weight, perm: list[int]) -> Weight:
    if isinstance(w, QuantizedTensor):
        return permute_out_features(w, perm)
    return w.index_select(0, torch.as_tensor(perm, dtype=torch.long, device=w.device))


def _fuse_qkv(wq: Weight, wk: Weight, wv: Weight, d: int) -> Weight:
    return _permute_rows(_concat_rows([wq, wk, wv]), _interleave_perm(wq, wk, wv, d))


def fuse_projections(params: Qwen3Params) -> Qwen3Params:
    """Fuse each layer's [q; k; v] (interleaved per KV head) and a dense
    MLP's [gate; up] into one weight each — an exact relayout (groups run
    along K), quantized or dense. Weights split over a mesh axis
    (ShardedWeight) fuse part by part: a part holds whole KV heads, so its
    fused rows are the unsharded fused weight's rows of those heads, and a
    fused gate/up's part s is [gate_s; up_s]. MoE experts stay unfused, as
    in the JAX package. The model's routes run on fused params only; a
    layer already fused is kept as it is."""
    layers = []
    for layer in params.layers:
        attn, mlp = layer.attn, layer.mlp
        if attn.wqkv is None:
            d = attn.q_norm.shape[-1]
            if isinstance(attn.wq, ShardedWeight):
                wqkv = zip_parts(lambda q, k, v: _fuse_qkv(q, k, v, d), attn.wq, attn.wk, attn.wv)
            else:
                wqkv = _fuse_qkv(attn.wq, attn.wk, attn.wv, d)
            attn = dataclasses.replace(attn, wq=None, wk=None, wv=None, wqkv=wqkv)
        if isinstance(mlp, MLPParams) and mlp.w_gate_up is None:
            if isinstance(mlp.w_gate, ShardedWeight):
                gate_up = zip_parts(lambda g, u: _concat_rows([g, u]), mlp.w_gate, mlp.w_up,
                                    halves=True)
            else:
                gate_up = _concat_rows([mlp.w_gate, mlp.w_up])
            mlp = dataclasses.replace(mlp, w_gate=None, w_up=None, w_gate_up=gate_up)
        layers.append(dataclasses.replace(layer, attn=attn, mlp=mlp))
    return dataclasses.replace(params, layers=layers)


def convert_projection_layouts(params: Qwen3Params, layout: str = "pair_t") -> Qwen3Params:
    """The port's counterpart of the JAX function of this name, which
    repacks every per-layer projection into "pair_t" for the W4A8 tier.
    The port's single layout serves both tiers, so nothing is repacked:
    every per-layer 2-D projection and every W4 g128 stacked expert tensor
    is marked act="int8" and shares its tensors with the W4A16 weight (no
    extra device memory). The embedding, the LM head and the MoE router
    stay W4A16, as in the JAX package. A 2-D projection that is not W4 g128
    raises ValueError (the JAX package asserts there too)."""
    if layout != "pair_t":
        raise ValueError(f"layout {layout!r}: the port converts to 'pair_t' only")

    def mark(w: Weight | None, stacked: bool = False):
        if isinstance(w, ShardedWeight):
            return w.map_parts(lambda p: mark(p, stacked))
        if not isinstance(w, QuantizedTensor):
            return w  # None, or a dense weight (the JAX package leaves those too)
        if not w.is_w4g128:
            if stacked:
                return w  # the JAX package leaves such experts on their own kernel too
            raise ValueError(f"W4A8 needs W4 g128 projections, not bits={w.bits} "
                             f"group_size={w.group_size}")
        return dataclasses.replace(w, act="int8")

    layers = []
    for layer in params.layers:
        a, m = layer.attn, layer.mlp
        attn = dataclasses.replace(a, wq=mark(a.wq), wk=mark(a.wk), wv=mark(a.wv),
                                   wqkv=mark(a.wqkv), wo=mark(a.wo))
        if isinstance(m, MoEParams):
            m = dataclasses.replace(m, w_gate=mark(m.w_gate, True), w_up=mark(m.w_up, True),
                                    w_down=mark(m.w_down, True))
        else:
            m = dataclasses.replace(m, w_gate=mark(m.w_gate), w_up=mark(m.w_up),
                                    w_gate_up=mark(m.w_gate_up), w_down=mark(m.w_down))
        layers.append(dataclasses.replace(layer, attn=attn, mlp=m))
    return dataclasses.replace(params, layers=layers)


def _write_rows(buf: torch.Tensor, layer: int, offsets: list[int], rows: torch.Tensor) -> None:
    """buf[layer, b, :, offsets[b] : offsets[b] + L] = rows[b], IN PLACE —
    the slab is preallocated, so writing the new rows where they belong
    saves a copy of the slab per layer and step."""
    L = rows.shape[2]
    if len(set(offsets)) == 1:
        o = offsets[0]
        buf[layer, :, :, o : o + L] = rows
        return
    for b, o in enumerate(offsets):
        buf[layer, b, :, o : o + L] = rows[b]


def _offsets_tensor(offsets: list[int], device) -> torch.Tensor:
    # A uniform offset is a device fill (no host-to-device copy, no sync).
    if len(set(offsets)) == 1:
        return torch.full((len(offsets),), offsets[0], dtype=torch.int32, device=device)
    return torch.tensor(offsets, dtype=torch.int32, device=device)


def forward_step(
    params: Qwen3Params,
    cfg: Qwen3Config,
    rope_tabs: tuple[torch.Tensor, torch.Tensor],
    tokens: torch.Tensor,  # [B, L] int on the model's device
    offsets: list[int],  # per row: context length before this chunk
    keys: torch.Tensor,  # [layers, B, Hkv, S, D] — written in place
    values: torch.Tensor,
    *,
    logits_to_keep: int | None,
    impl: str | None = None,
    attn_impl=None,
) -> torch.Tensor:
    """One cached step (prompt chunk or decode step): writes this chunk's
    k/v into the slab at `offsets` and returns logits [B, L_keep, V].
    `attn_impl`: an attention strategy (with .flash), or None for `impl`'s
    kernels."""
    h = forward_layers(params.layers, cfg, rope_tabs, _embed(params, tokens), offsets, keys,
                       values, impl=impl, attn_impl=attn_impl)
    if logits_to_keep is not None:
        h = h[:, -logits_to_keep:, :]
    h = rms_norm(h, params.final_norm, cfg.rms_norm_eps)
    return _lm_head(params, h, impl)


def forward_layers(
    layers,  # a range of the model's fused BlockParams
    cfg: Qwen3Config,
    rope_tabs: tuple[torch.Tensor, torch.Tensor],
    h: torch.Tensor,  # [B, L, D] the residual stream entering the range
    offsets: list[int],  # per row: context length before this chunk
    keys: torch.Tensor,  # [len(layers), B, Hkv, S, D] — written in place
    values: torch.Tensor,
    *,
    impl: str | None = None,
    attn_impl=None,
) -> torch.Tensor:
    """Run `layers` on the residual `h`: each layer writes its k/v into the
    slab at `offsets` (slab layer i is layers[i]) and attends, K2 at L == 1,
    K3 above (or the strategy `attn_impl`). Returns the residual after the
    range. forward_step runs every layer through it; a pipeline stage runs
    its own range."""
    B, L, _ = h.shape
    dev = h.device
    scale = cfg.head_dim**-0.5
    eps = cfg.rms_norm_eps
    hkv = cfg.num_key_value_heads
    n_rep = cfg.num_attention_heads // hkv
    offs = _offsets_tensor(offsets, dev)
    decode = L == 1 and attn_impl is None  # the fused decode route: K2 per layer
    if decode:
        # The RoPE rows are gathered once per step and shared by all layers.
        pos = offs.to(torch.long)
        cos_row, sin_row = rope_tabs[0][pos], rope_tabs[1][pos]
    else:
        positions = offs[:, None].to(torch.long) + torch.arange(L, device=dev)[None, :]
        lens = offs + L
    for i, layer in enumerate(layers):
        if decode:
            qkv = _norm_linear(h, layer.attn.wqkv, layer.input_layernorm, eps, impl)
            attn_rows, k_row, v_row = fused_decode_attention(
                qkv.reshape(B, hkv, n_rep + 2, cfg.head_dim), keys, values, offs,
                cos_row, sin_row, layer.attn.q_norm, layer.attn.k_norm,
                layer_idx=i, scale=scale, eps=eps, impl=impl,
            )
            _write_rows(keys, i, offsets, k_row)
            _write_rows(values, i, offsets, v_row)
            attn = attn_rows.reshape(B, 1, -1)
        else:
            q, k, v = _qkv(cfg, layer.attn, h, positions, rope_tabs,
                           norm_w=layer.input_layernorm, impl=impl)
            _write_rows(keys, i, offsets, k)
            _write_rows(values, i, offsets, v)
            attn = flash_attention(q.contiguous(), keys[i], values[i], lens, scale=scale,
                                   impl=impl if attn_impl is None else attn_impl)
            attn = attn.transpose(1, 2).reshape(B, L, -1)
        h = _linear(attn, layer.attn.wo, residual=h, impl=impl)
        h = _mlp(cfg, layer.mlp, h, norm_w=layer.post_attention_layernorm,
                 residual=h, impl=impl)
    return h


def forward_full(params: Qwen3Params, cfg: Qwen3Config, tokens: torch.Tensor,
                 impl: str | None = None) -> torch.Tensor:
    """No-cache full-prefix forward: tokens [B, L] (on the params' device)
    -> logits [B, L, V], the whole prefix as one chunk into a scratch slab
    of its length (Qwen3Model's no-cache call)."""
    params = fuse_projections(params)
    B, L = tokens.shape
    dev = tokens.device
    dtype = act_dtype(params)
    shape = (cfg.num_hidden_layers, B, cfg.num_key_value_heads, L, cfg.head_dim)
    keys = torch.empty(shape, dtype=dtype, device=dev)
    values = torch.empty(shape, dtype=dtype, device=dev)
    rope = rope_tables(cfg.head_dim, L, base=cfg.rope_theta, device=dev)
    return forward_step(params, cfg, rope, tokens, [0] * B, keys, values, logits_to_keep=None,
                        impl=impl)


def forward_decode_burst_dense(
    params: Qwen3Params,
    cfg: Qwen3Config,
    rope_tabs,
    tokens0: torch.Tensor,  # [B] int on the device
    offset: int,
    keys: torch.Tensor,
    values: torch.Tensor,
    *,
    steps: int,
    impl: str | None = None,
    attn_impl=None,
    temp: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """`steps` decode steps from `tokens0` at `offset`; returns the emitted
    tokens [steps, B] on the device. Greedy when temp == 0, else
    temperature / top-k / top-p sampling on the device with `generator`.
    Nothing here waits for the device."""
    B = tokens0.shape[0]
    return _decode_loop(
        lambda tokens, s: forward_step(
            params, cfg, rope_tabs, tokens[:, None], [offset + s] * B, keys, values,
            logits_to_keep=1, impl=impl, attn_impl=attn_impl,
        ),
        tokens0, steps, temp, top_k, top_p, generator,
    )


def _decode_loop(step, tokens0, steps, temp, top_k, top_p, generator) -> torch.Tensor:
    """`steps` decode steps: step(tokens [B], s) gives step s's logits and
    the chosen tokens feed the next step on the device. Returns [steps, B]."""
    sample = make_sampler(temp, top_p, top_k)
    tokens, out = tokens0, []
    for s in range(steps):
        lp = step(tokens, s)[:, -1, :].to(torch.float32)
        if temp != 0:
            lp = torch.log_softmax(lp, dim=-1)
        tokens = sample(lp, generator)
        out.append(tokens)
    return torch.stack(out)


# Offset > 0 chunks of at least this many tokens take the split paged
# prefill in the JAX package (models/qwen3.py split_prefill_min_chunk).
SPLIT_PREFILL_MIN_CHUNK = 1024


def _page_targets(block_table: torch.Tensor, positions: torch.Tensor, ps: int):
    """(page, slot) of each appended position, [B, L] each. -1 entries land
    on the trash page 0; a position past the table's width lands in its
    last column, as the JAX package's clamped gather does (only burst steps
    past max_seq_len, whose tokens the scheduler discards, get there)."""
    col = torch.clamp(positions // ps, max=block_table.shape[1] - 1)
    page = torch.gather(block_table.to(torch.long), 1, col).clamp(min=0)
    return page, positions % ps


def _write_pages(pages: torch.Tensor, layer: int, page_idx, slot, rows: torch.Tensor) -> None:
    """pages[layer, page_idx[b, t], :, slot[b, t]] = rows[b, :, t] IN PLACE:
    replaces the JAX package's scatter into donated page buffers."""
    pages[layer][page_idx, :, slot, :] = rows.transpose(1, 2)


def _paged_decode_rows(cfg, attn_p: AttentionParams, layer: int, qkv_rows, key_pages,
                       value_pages, block_table, offsets, cos_row, sin_row, page_idx, slot, *,
                       impl, fused_one: bool) -> torch.Tensor:
    """One layer's attention for B decode rows (the fused qkv rows
    [B, Hkv, n_rep + 2, D] at `offsets`) over the page pool, their k/v rows
    written into it at (page_idx, slot); returns [B, Hq * D]. `fused_one`:
    the fused paged step, the write after it; else the prep kernel, which
    writes the k/v rows into the pages itself, then paged attention over
    the pages (the pool's scatter-then-read order)."""
    B, D = qkv_rows.shape[0], cfg.head_dim
    scale, eps = D**-0.5, cfg.rms_norm_eps
    if not fused_one:
        q = fused_qkv_prep(qkv_rows, offsets, cos_row, sin_row, attn_p.q_norm, attn_p.k_norm,
                           eps=eps, impl=impl,
                           pages=(key_pages[layer], value_pages[layer], page_idx, slot))
        attn = paged_attention(q.reshape(B, -1, 1, D), key_pages[layer], value_pages[layer],
                               block_table, offsets + 1, scale=scale, impl=impl)
        return attn.reshape(B, -1)
    attn, k_row, v_row = fused_paged_decode_attention(
        qkv_rows, key_pages[layer], value_pages[layer], block_table, offsets, cos_row,
        sin_row, attn_p.q_norm, attn_p.k_norm, scale=scale, eps=eps, impl=impl,
    )
    _write_pages(key_pages, layer, page_idx, slot, k_row)
    _write_pages(value_pages, layer, page_idx, slot, v_row)
    return attn.reshape(B, -1)


def forward_step_paged(
    params: Qwen3Params,
    cfg: Qwen3Config,
    rope_tabs: tuple[torch.Tensor, torch.Tensor],
    tokens: torch.Tensor,  # [B, L] int on the model's device
    offsets: torch.Tensor,  # [B] int32 on the device: context length before the chunk
    key_pages: torch.Tensor,  # [layers, P, Hkv, ps, D] — written in place
    value_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32 on the device, -1 padded
    *,
    logits_to_keep: int | None,
    impl: str | None = None,
    attn_impl=None,
    local_attention: bool = False,
    split_attention: bool = False,
    fused_one: bool = True,
) -> torch.Tensor:
    """One model step over the page pool (prompt chunk or decode step):
    writes this chunk's k/v into the pages the block table names and
    returns logits [B, L_keep, V].

    A decode step (L == 1) runs the fused paged kernel and writes the k/v
    rows after it; with `fused_one` False, the prep kernel, which writes
    the k/v rows, then paged attention over the pages (the pool's
    scatter-then-read order). A chunk writes its k/v first, then attends:
    `local_attention` (every offset 0, so the chunk is the whole context)
    runs K3 on the chunk's own k/v; `split_attention` runs the split paged
    prefill (the chunk's own k/v causally, the prefix pages before it
    non-causally, combined); otherwise paged attention reads the pages.
    `attn_impl`: an attention strategy (with .flash and .paged) that runs
    the attention of every step, decode steps unfused; None for `impl`'s
    kernels."""
    B, L = tokens.shape
    dev = tokens.device
    ps = key_pages.shape[3]
    scale = cfg.head_dim**-0.5
    eps = cfg.rms_norm_eps
    hkv = cfg.num_key_value_heads
    n_rep = cfg.num_attention_heads // hkv
    positions = offsets[:, None].to(torch.long) + torch.arange(L, device=dev)[None, :]
    page_idx, slot = _page_targets(block_table, positions, ps)
    # RoPE rows past the table exist only in discarded burst steps (see
    # _page_targets); clamp rather than index out of range.
    rope_pos = positions.clamp(max=rope_tabs[0].shape[0] - 1)
    h = _embed(params, tokens)
    decode = L == 1 and attn_impl is None  # the fused paged decode route
    attn_with = impl if attn_impl is None else attn_impl
    if decode:
        cos_row, sin_row = rope_tabs[0][rope_pos[:, 0]], rope_tabs[1][rope_pos[:, 0]]
    else:
        lens = offsets + L
    for i, layer in enumerate(params.layers):
        if decode:
            qkv = _norm_linear(h, layer.attn.wqkv, layer.input_layernorm, eps, impl)
            attn = _paged_decode_rows(
                cfg, layer.attn, i, qkv.reshape(B, hkv, n_rep + 2, cfg.head_dim), key_pages,
                value_pages, block_table, offsets, cos_row, sin_row, page_idx, slot, impl=impl,
                fused_one=fused_one,
            )[:, None]
        else:
            q, k, v = _qkv(cfg, layer.attn, h, rope_pos, rope_tabs,
                           norm_w=layer.input_layernorm, impl=impl)
            _write_pages(key_pages, i, page_idx, slot, k)
            _write_pages(value_pages, i, page_idx, slot, v)
            if local_attention:
                attn = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), lens,
                                       scale=scale, impl=attn_with)
            elif split_attention:
                attn = split_paged_prefill(q.contiguous(), k.contiguous(), v.contiguous(),
                                           key_pages[i], value_pages[i], block_table, offsets,
                                           scale=scale, impl=impl)
            else:
                attn = paged_attention(q.contiguous(), key_pages[i], value_pages[i],
                                       block_table, lens, scale=scale, impl=attn_with)
            attn = attn.transpose(1, 2).reshape(B, L, -1)
        h = _linear(attn, layer.attn.wo, residual=h, impl=impl)
        h = _mlp(cfg, layer.mlp, h, norm_w=layer.post_attention_layernorm,
                 residual=h, impl=impl)
    if logits_to_keep is not None:
        h = h[:, -logits_to_keep:, :]
    h = rms_norm(h, params.final_norm, eps)
    return _lm_head(params, h, impl)


def forward_decode_burst_paged(
    params: Qwen3Params,
    cfg: Qwen3Config,
    rope_tabs,
    tokens0: torch.Tensor,  # [B] int on the device
    offsets0: torch.Tensor,  # [B] int32 on the device
    key_pages: torch.Tensor,
    value_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, width] — must cover offsets0 + steps
    *,
    steps: int,
    impl: str | None = None,
    attn_impl=None,
    temp: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    generator: torch.Generator | None = None,
    fused_one: bool = True,
) -> torch.Tensor:
    """`steps` paged decode steps for every row; returns the emitted tokens
    [steps, B] on the device. Greedy when temp == 0, else sampled on the
    device with `generator`. Nothing here waits for the device. Rows that
    hit EOS keep decoding until the host reads the burst: their tokens are
    discarded and their pages need `steps` tokens of slack."""
    return _decode_loop(
        lambda tokens, s: forward_step_paged(
            params, cfg, rope_tabs, tokens[:, None], offsets0 + s, key_pages, value_pages,
            block_table, logits_to_keep=1, impl=impl, attn_impl=attn_impl, fused_one=fused_one,
        ),
        tokens0, steps, temp, top_k, top_p, generator,
    )


@dataclasses.dataclass
class MixedStep:
    """One scheduled prefill sub-chunk of a mixed burst step
    (Qwen3Model.mixed_burst): `cache` owns the request's pages, `tokens`
    are its 1..c real prompt tokens starting at context length `offset` (a
    multiple of the mixed chunk), `generator` draws the completion token
    when the sub-chunk ends the prompt under temp > 0 (the request's own)."""

    cache: Any
    tokens: Any
    offset: int
    generator: torch.Generator | None = None


def forward_mixed_burst_paged(
    params: Qwen3Params,
    cfg: Qwen3Config,
    rope_tabs,
    tokens0: torch.Tensor,  # [B] int on the device — first decode token per slot
    offsets0: torch.Tensor,  # [B] int32 on the device
    key_pages: torch.Tensor,  # [layers, P, Hkv, ps, D] — written in place
    value_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, W] — decode slots; must cover offsets0 + steps
    p_chunks: torch.Tensor,  # [steps, c] int — per-step prefill sub-chunks
    p_offsets: torch.Tensor,  # [steps] int32 — context length before each sub-chunk
    p_tables: torch.Tensor,  # [steps, W] int32 — per-step table row (-1 rows: idle)
    p_last: torch.Tensor,  # [steps] int — index of the last real token per sub-chunk
    p_generators: list | None = None,  # [steps] completion generators (None: argmax)
    *,
    steps: int,
    impl: str | None = None,
    temp: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    generator: torch.Generator | None = None,
    fused_one: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`steps` decode steps for every row AND one prefill sub-chunk per step,
    through the same projections: each step's activation is [1, B + c, D],
    so every weight matrix streams once for decode and prefill together.

    The per-step arrays form a schedule: step t prefills c tokens of the
    request whose pages p_tables[t] names; a sub-chunk whose prompt ends
    mid-chunk carries padding, p_last[t] marks its last real token, and the
    padding's k/v land in the request's own last page at slots its decode
    overwrites before any read. Steps with nothing to prefill carry an all
    -1 table row (the trash page). Each step: the sub-chunk's split,
    QK-norm and RoPE at its own positions, its k/v written into its pages,
    then paged attention over its own table row (kernels/paged_attention);
    the decode rows through the fused paged step, their k/v rows written
    after it (`fused_one` False: the prep kernel writing them, then paged
    attention; _paged_decode_rows); the LM head over the decode rows
    and the sub-chunk's last real row only (M = B + 1); the argmax (or the
    samplers) on the device.

    Returns (decode tokens [steps, B], completion tokens [steps]: step t's
    draw at its sub-chunk's last real row, valid where that step completes
    a prompt), on the device; nothing here waits for it. Completions draw
    from p_generators[t] under temp > 0 where given, else take the argmax."""
    B = tokens0.shape[0]
    c = p_chunks.shape[1]
    ps = key_pages.shape[3]
    scale = cfg.head_dim**-0.5
    eps = cfg.rms_norm_eps
    hkv = cfg.num_key_value_heads
    n_rep = cfg.num_attention_heads // hkv
    dev = tokens0.device
    sample = make_sampler(temp, top_p, top_k)
    rope_max = rope_tabs[0].shape[0] - 1
    ar = torch.arange(c, device=dev)
    tokens, offsets = tokens0, offsets0
    out, comp = [], []
    for t in range(steps):
        d_pos = offsets[:, None].to(torch.long)  # [B, 1]
        d_page, d_slot = _page_targets(block_table, d_pos, ps)
        d_rope = d_pos[:, 0].clamp(max=rope_max)
        cos_row, sin_row = rope_tabs[0][d_rope], rope_tabs[1][d_rope]
        p_pos = p_offsets[t].to(torch.long) + ar[None, :]  # [1, c]
        p_tab = p_tables[t : t + 1]  # [1, W]
        p_page, p_slot = _page_targets(p_tab, p_pos, ps)
        p_len = p_offsets[t : t + 1] + c
        h = torch.cat([_embed(params, tokens[None, :]), _embed(params, p_chunks[t][None, :])],
                      dim=1)  # [1, B + c, D]
        for i, layer in enumerate(params.layers):
            qkv = _norm_linear(h, layer.attn.wqkv, layer.input_layernorm, eps, impl)
            # The sub-chunk: its k/v go into its pages before it attends.
            q_p, k_p, v_p = _split_qkv_rope(cfg, layer.attn, qkv[:, B:],
                                            p_pos.clamp(max=rope_max), rope_tabs)
            _write_pages(key_pages, i, p_page, p_slot, k_p)
            _write_pages(value_pages, i, p_page, p_slot, v_p)
            attn_d = _paged_decode_rows(
                cfg, layer.attn, i, qkv[0, :B].reshape(B, hkv, n_rep + 2, cfg.head_dim),
                key_pages, value_pages, block_table, offsets, cos_row, sin_row, d_page, d_slot,
                impl=impl, fused_one=fused_one,
            )
            attn_p = paged_attention(q_p.contiguous(), key_pages[i], value_pages[i], p_tab,
                                     p_len, scale=scale, impl=impl)  # [1, Hq, c, D]
            attn = torch.cat([attn_d[None],
                              attn_p.transpose(1, 2).reshape(1, c, -1)], dim=1)
            h = _linear(attn, layer.attn.wo, residual=h, impl=impl)
            h = _mlp(cfg, layer.mlp, h, norm_w=layer.post_attention_layernorm,
                     residual=h, impl=impl)
        h_sel = torch.cat([h[0, :B], h[0].index_select(0, B + p_last[t : t + 1])], dim=0)
        logits = _lm_head(params, rms_norm(h_sel, params.final_norm, eps)[None], impl)[0]
        lp, cp = logits[:B].to(torch.float32), logits[B:].to(torch.float32)
        if temp != 0:
            lp = torch.log_softmax(lp, dim=-1)
        tokens = sample(lp, generator)
        gen = p_generators[t] if p_generators is not None else None
        if temp != 0 and gen is not None:
            comp.append(sample(torch.log_softmax(cp, dim=-1), gen))
        else:
            comp.append(cp.argmax(dim=-1).to(torch.int32))
        out.append(tokens)
        offsets = offsets + 1
    return torch.stack(out), torch.cat(comp)


class Qwen3Model:
    """Host-side wrapper owning the (fused) params, the RoPE tables and,
    once enable_paged_attention() attached one, the page pool.

    API of the JAX package's Qwen3Model for the dense and paged paths:
    __call__(inputs, offset, cache, logits_to_keep), create_kv_cache(),
    create_batching_kv_cache(), decode_burst_dense(), enable_paged_attention(),
    decode_burst(), supports_mixed, mixed_burst(), forward_full(). `impl`
    plays the role of JAX's string `attn_impl`: None runs the kernels on the card and their
    plain versions on the CPU, "torch" runs the plain versions on either
    device. `attn_impl` takes JAX's strategy objects: None, or one with
    `.flash` and `.paged` (parallel.SPAttention), which then runs every
    attention while the matmuls keep `impl`.
    `act_quant` "int8" is the W4A8 tier (convert_projection_layouts after
    fuse_projections, as in the JAX package); None or "bf16" keeps W4A16.
    The port reads no environment default for it.
    `paged_fused_one` (None: TLT_PAGED_FUSED_ONE, "1" unless set, read here
    once, as the JAX package reads it at construction): False takes paged
    decode steps through the JAX package's three-launch route (here the
    prep kernel, which writes the page rows, then paged attention) instead
    of the fused paged step."""

    def __init__(
        self,
        params: Qwen3Params,
        cfg: Qwen3Config,
        max_seq_len: int | None = None,
        impl: str | None = None,
        device: str | torch.device = "cuda",
        act_quant: str | None = None,
        attn_impl=None,
        paged_fused_one: bool | None = None,
    ):
        self.device = check_device(device)
        if attn_impl is not None and not (hasattr(attn_impl, "flash")
                                          and hasattr(attn_impl, "paged")):
            raise TypeError("attn_impl must be None or a strategy with .flash and .paged")
        self.attn_impl = attn_impl
        if params.embedding.device.type != self.device.type:
            raise ValueError(
                f"params live on {params.embedding.device}, model device is {self.device}"
            )
        self.act_quant = act_quant or "bf16"
        if self.act_quant not in ("bf16", "int8"):
            raise ValueError(f"act_quant {act_quant!r}: expected None, 'bf16' or 'int8'")
        self.params = fuse_projections(params)
        if self.act_quant == "int8":
            self.params = convert_projection_layouts(self.params, "pair_t")
        self.cfg = cfg
        self.impl = impl
        self.num_hidden_layers = cfg.num_hidden_layers
        self.vocab_size = cfg.vocab_size
        self.max_seq_len = max_seq_len or cfg.max_position_embeddings
        self.dtype = act_dtype(params)
        if self.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"dense weights of {self.dtype}: expected bf16 or f32")
        if self.device.type == "cuda" and self.dtype != torch.bfloat16:
            raise ValueError(f"a {self.dtype} model runs on the CPU only: the CUDA kernels "
                             "take bf16 (load the weights in bf16, or pass device='cpu')")
        self._rope_tables = rope_tables(
            cfg.head_dim, self.max_seq_len, base=cfg.rope_theta, device=self.device
        )
        self.page_pool: PagePool | None = None
        if paged_fused_one is None:
            paged_fused_one = os.environ.get("TLT_PAGED_FUSED_ONE", "1") == "1"
        self.paged_fused_one = bool(paged_fused_one)

    def enable_paged_attention(self, num_pages: int | None = None, page_size: int = 128):
        """Attach a page pool: create_kv_cache() and create_batching_kv_cache()
        then return paged handles."""
        if num_pages is None:
            num_pages = max(self.max_seq_len // page_size * 4, 8) + 1
        self.page_pool = PagePool(
            num_layers=self.cfg.num_hidden_layers,
            num_pages=num_pages,
            num_kv_heads=self.cfg.num_key_value_heads,
            page_size=page_size,
            head_dim=self.cfg.head_dim,
            dtype=self.dtype,
            device=self.device,
        )
        # One fixed block-table width for every step, as in the JAX package.
        self._paged_width = bucket_for(-(-self.max_seq_len // page_size), minimum=2)
        return self

    @property
    def supports_mixed(self) -> bool:
        """True when mixed prefill+decode bursts are available: a paged pool,
        no attention strategy, and fused qkv weights on every layer (the
        shared projection matmul is the point of the mixed step)."""
        return self.page_pool is not None and self.attn_impl is None and all(
            layer.attn.wqkv is not None for layer in self.params.layers
        )

    def mixed_burst(
        self,
        cache: PagedBatchingKVCache,  # the decode slots
        first_tokens,  # [B] int — next token per slot
        steps: int,
        schedule: list,  # [steps] of MixedStep | None
        chunk: int,  # c — prefill tokens per step (must divide the page size)
        *,
        temp: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        generator: torch.Generator | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """`steps` decode tokens for every slot AND up to steps * chunk
        prefill tokens of the scheduled requests, with one host sync at the
        end (forward_mixed_burst_paged). schedule[t] names the sub-chunk
        step t prefills (None: an idle prefill row). Returns (decode tokens
        [steps, B] int32, completion tokens [steps] int32, valid at steps
        whose sub-chunk ends its prompt). Slots advance by `steps`; each
        scheduled cache advances by its real token count."""
        if not isinstance(cache, PagedBatchingKVCache):
            raise TypeError("mixed_burst runs over a PagedBatchingKVCache")
        if not self.supports_mixed:
            raise ValueError("this model has no mixed bursts (see supports_mixed)")
        if temp != 0 and generator is None:
            raise ValueError("a sampled burst needs a torch.Generator")
        if steps <= 0 or len(schedule) != steps:
            raise ValueError(f"a schedule of {len(schedule)} entries for {steps} steps")
        ps = cache.pool.page_size
        # A sub-chunk stays inside one page: c divides the page size and
        # offsets are c-aligned (the scheduler keeps both).
        if not (0 < chunk <= ps and ps % chunk == 0):
            raise ValueError(f"mixed chunk {chunk} must divide the page size {ps}")
        for c in cache.slots:
            if c is not None:
                c.ensure_capacity(c.offset + steps)
        width = self._paged_width
        table = cache.block_table(width)
        p_chunks = np.zeros((steps, chunk), np.int64)
        p_offsets = np.zeros((steps,), np.int32)
        p_tables = np.full((steps, width), -1, np.int32)
        p_last = np.zeros((steps,), np.int64)
        p_gens = [None] * steps
        for t, entry in enumerate(schedule):
            if entry is None:
                continue
            r = len(entry.tokens)
            if not 0 < r <= chunk or entry.offset % chunk:
                raise ValueError(f"sub-chunk of {r} tokens at offset {entry.offset}")
            if entry.cache.pool is not cache.pool:
                raise ValueError("the schedule must share the page pool")
            entry.cache.ensure_capacity(entry.offset + r)
            p_chunks[t, :r] = entry.tokens
            p_offsets[t] = entry.offset
            p_tables[t] = entry.cache.block_table_row(width)
            p_last[t] = r - 1
            p_gens[t] = entry.generator
        dev = self.device
        toks, comp = forward_mixed_burst_paged(
            self.params, self.cfg, self._rope_tables, self._tokens(first_tokens).reshape(-1),
            torch.from_numpy(cache.offsets).to(dev), cache.pool.key_pages,
            cache.pool.value_pages, torch.from_numpy(table).to(dev),
            torch.from_numpy(p_chunks).to(dev), torch.from_numpy(p_offsets).to(dev),
            torch.from_numpy(p_tables).to(dev), torch.from_numpy(p_last).to(dev), p_gens,
            steps=steps, impl=self.impl, temp=temp, top_k=top_k, top_p=top_p,
            generator=generator, fused_one=self.paged_fused_one,
        )
        both = torch.cat([toks.reshape(-1), comp]).cpu().numpy().astype(np.int32)
        for c in cache.slots:
            if c is not None:
                c.advance(steps)
        for entry in schedule:
            if entry is not None:
                entry.cache.advance(len(entry.tokens))
        B = toks.shape[1]
        return both[: steps * B].reshape(steps, B), both[steps * B :]

    def create_kv_cache(
        self, batch_size: int = 1, max_seq_len: int | None = None
    ) -> DenseKVCache | PagedKVCache:
        if self.page_pool is not None:
            return PagedKVCache(self.page_pool)
        return DenseKVCache(
            num_layers=self.cfg.num_hidden_layers,
            batch_size=batch_size,
            num_kv_heads=self.cfg.num_key_value_heads,
            max_seq_len=max_seq_len or self.max_seq_len,
            head_dim=self.cfg.head_dim,
            dtype=self.dtype,
            device=self.device,
        )

    def create_batching_kv_cache(
        self, max_active_requests: int, max_seq_len: int | None = None
    ) -> BatchingKVCache | PagedBatchingKVCache:
        if self.page_pool is not None:
            return PagedBatchingKVCache(self.page_pool, max_active_requests)
        return BatchingKVCache(
            num_layers=self.cfg.num_hidden_layers,
            max_active_requests=max_active_requests,
            num_kv_heads=self.cfg.num_key_value_heads,
            max_seq_len=max_seq_len or self.max_seq_len,
            head_dim=self.cfg.head_dim,
            dtype=self.dtype,
            device=self.device,
        )

    def _tokens(self, inputs) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(inputs) if not torch.is_tensor(inputs) else inputs)
        t = t.to(device=self.device, dtype=torch.long)
        return t[None] if t.ndim == 1 else t

    def __call__(
        self,
        inputs,  # [B, L] token ids
        offset: int | list | None = None,
        cache=None,
        logits_to_keep: int | None = None,
    ) -> torch.Tensor:
        tokens = self._tokens(inputs)
        B, L = tokens.shape
        if isinstance(cache, (PagedKVCache, PagedBatchingKVCache)):
            return self._call_paged(tokens, offset, cache, logits_to_keep)
        if isinstance(cache, BatchingKVCache):
            return self._call_batching(tokens, offset, cache, logits_to_keep)
        if cache is None:
            # The no-cache forward: the whole prefix as one chunk into a
            # scratch dense cache of exactly its length.
            cache = DenseKVCache(
                num_layers=self.cfg.num_hidden_layers, batch_size=B,
                num_kv_heads=self.cfg.num_key_value_heads, max_seq_len=L,
                head_dim=self.cfg.head_dim, dtype=self.dtype, device=self.device,
            )
            offset = 0
        if offset is None:
            offset = cache.offset
        offsets = [int(offset)] * B if np.ndim(offset) == 0 else [int(o) for o in offset]
        if max(offsets) != cache.offset:
            raise ValueError(f"offset {offsets} disagrees with cache offset {cache.offset}")
        if cache.offset + L > cache.max_seq_len:
            raise ValueError(f"context {cache.offset + L} exceeds capacity {cache.max_seq_len}")
        logits = forward_step(
            self.params, self.cfg, self._rope_tables, tokens, offsets,
            cache.keys, cache.values, logits_to_keep=logits_to_keep, impl=self.impl,
            attn_impl=self.attn_impl,
        )
        cache.advance(L)
        return logits

    def forward_full(self, tokens) -> torch.Tensor:
        """No-cache full-prefix forward: tokens [B, L] -> logits [B, L, V]
        (the call without a cache)."""
        return self(tokens)

    @staticmethod
    def _slot_offsets(cache, B: int, offset) -> np.ndarray:
        """Each batching slot's offset: the caller's for active slots when
        given, the cache's own otherwise (idle slots keep theirs)."""
        if B != cache.max_active_requests:
            raise ValueError(f"batch {B} != {cache.max_active_requests} slots")
        if offset is None:
            return cache.offsets
        return np.where(cache.active, np.asarray(offset, np.int32).reshape(-1), cache.offsets)

    def _call_batching(self, tokens, offset, cache: BatchingKVCache, logits_to_keep):
        """A step over the dense batching slots at per-slot offsets; idle
        slots compute discarded rows and keep their offsets."""
        B, L = tokens.shape
        offs = self._slot_offsets(cache, B, offset)
        if int(offs.max(initial=0)) + L > cache.max_seq_len:
            raise ValueError(f"context {int(offs.max()) + L} exceeds {cache.max_seq_len}")
        logits = forward_step(
            self.params, self.cfg, self._rope_tables, tokens, [int(o) for o in offs],
            cache.keys, cache.values, logits_to_keep=logits_to_keep, impl=self.impl,
            attn_impl=self.attn_impl,
        )
        cache.offsets = np.where(cache.active, offs + L, cache.offsets).astype(np.int32)
        return logits

    def _call_paged(self, tokens, offset, cache, logits_to_keep):
        """A step over the page pool for one request (PagedKVCache) or for
        the batching slots (PagedBatchingKVCache)."""
        B, L = tokens.shape
        width = self._paged_width
        if isinstance(cache, PagedBatchingKVCache):
            offs = self._slot_offsets(cache, B, offset)
            for c in cache.slots:
                if c is not None:
                    c.ensure_capacity(c.offset + L)
            table = cache.block_table(width)
        else:
            if offset is None:
                offset = cache.offset
            offs = np.full((B,), int(np.max(offset)), np.int32)
            if int(offs[0]) != cache.offset:
                raise ValueError(f"offset {offs} disagrees with cache offset {cache.offset}")
            cache.ensure_capacity(cache.offset + L)
            table = np.asarray([cache.block_table_row(width)] * B, np.int32)
        logits = forward_step_paged(
            self.params, self.cfg, self._rope_tables, tokens,
            torch.from_numpy(offs).to(self.device), cache.pool.key_pages,
            cache.pool.value_pages, torch.from_numpy(table).to(self.device),
            logits_to_keep=logits_to_keep, impl=self.impl, attn_impl=self.attn_impl,
            # The first chunk is the whole context: no page walk (L > 1 keeps
            # decode steps on the fused paged kernel even at offset 0).
            local_attention=bool(L > 1 and np.all(offs == 0)),
            split_attention=bool(self.attn_impl is None and L >= SPLIT_PREFILL_MIN_CHUNK
                                 and np.any(offs > 0)),
            fused_one=self.paged_fused_one,
        )
        if isinstance(cache, PagedBatchingKVCache):
            for c in cache.slots:
                if c is not None:
                    c.advance(L)
        else:
            cache.advance(L)
        return logits

    def decode_burst_dense(
        self,
        cache: DenseKVCache,
        first_tokens,  # [B] int
        steps: int,
        *,
        temp: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        generator: torch.Generator | None = None,
    ) -> np.ndarray:
        """`steps` decode steps over a dense cache with one host sync at the
        end. Returns int32 [steps, B]."""
        if cache.offset + steps > cache.max_seq_len:
            raise ValueError(f"burst past capacity {cache.max_seq_len}")
        if temp != 0 and generator is None:
            raise ValueError("a sampled burst needs a torch.Generator")
        tokens0 = self._tokens(first_tokens).reshape(-1)
        toks = forward_decode_burst_dense(
            self.params, self.cfg, self._rope_tables, tokens0, cache.offset,
            cache.keys, cache.values, steps=steps, impl=self.impl, attn_impl=self.attn_impl,
            temp=temp, top_k=top_k, top_p=top_p, generator=generator,
        )
        cache.advance(steps)
        return toks.cpu().numpy().astype(np.int32)

    def decode_burst(
        self,
        cache: PagedBatchingKVCache,
        first_tokens,  # [B] int — next token per slot
        steps: int,
        *,
        temp: float = 0.0,
        top_k: int | None = None,
        top_p: float | None = None,
        generator: torch.Generator | None = None,
    ) -> np.ndarray:
        """`steps` decode steps for every slot of a paged batching cache with
        one host sync at the end. Returns int32 [steps, B]; idle slots give
        garbage. Every installed slot advances by `steps` (the scheduler
        truncates at EOS and evicts afterwards)."""
        if not isinstance(cache, PagedBatchingKVCache):
            raise TypeError("decode_burst runs over a PagedBatchingKVCache")
        if temp != 0 and generator is None:
            raise ValueError("a sampled burst needs a torch.Generator")
        offs = cache.offsets
        for c in cache.slots:
            if c is not None:
                c.ensure_capacity(c.offset + steps)
        table = cache.block_table(self._paged_width)
        toks = forward_decode_burst_paged(
            self.params, self.cfg, self._rope_tables, self._tokens(first_tokens).reshape(-1),
            torch.from_numpy(offs).to(self.device), cache.pool.key_pages,
            cache.pool.value_pages, torch.from_numpy(table).to(self.device), steps=steps,
            impl=self.impl, attn_impl=self.attn_impl, temp=temp, top_k=top_k, top_p=top_p,
            generator=generator, fused_one=self.paged_fused_one,
        )
        out = toks.cpu().numpy().astype(np.int32)
        for c in cache.slots:
            if c is not None:
                c.advance(steps)
        return out
