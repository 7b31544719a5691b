"""The port's tensor parallelism (tiny_llm_tpu_torch.parallel: param_shardings,
shard_params, shard_kv_cache, TPAttention, paged_pool_spec, on the CPU)
against the JAX package's (tests/test_sharding.py's cases on
tests/conftest.py's 8 virtual devices), on the JAX tests' `tp_config`: the
same numpy params and tokens through a JAX model under GSPMD and a port
model whose split weights run part by part on the mesh [cpu] * 8. Also the
in-feature split whose shards cut a quant group (tp = 8 at tp_config's
half-group shards and at Qwen3-4B's down, 9.5 groups a shard) against the
unsharded matmul, within the per-shard rounding it adds."""

from __future__ import annotations

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.models import Qwen3Config as JaxQwen3Config  # noqa: E402
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.ops.quantize import QuantizedTensor as JaxQT  # noqa: E402
from tiny_llm_tpu.parallel import ShardingConfig as JaxShardingConfig  # noqa: E402
from tiny_llm_tpu.parallel import TPAttention as JaxTPAttention  # noqa: E402
from tiny_llm_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tiny_llm_tpu.parallel import param_shardings as jax_param_shardings  # noqa: E402
from tiny_llm_tpu.parallel import shard_params as jax_shard_params  # noqa: E402
from tiny_llm_tpu.parallel.sharding import shard_kv_cache as jax_shard_kv_cache  # noqa: E402
from tiny_llm_tpu.parallel.tp_kernels import paged_pool_spec as jax_paged_pool_spec  # noqa: E402
from tiny_llm_tpu_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Config, Qwen3Model  # noqa: E402
from tiny_llm_tpu_torch.ops.quantize import QuantizedTensor, quantize  # noqa: E402
from tiny_llm_tpu_torch.ops.sharded import (  # noqa: E402
    ShardedWeight,
    shard_weight,
    sharded_linear,
)
from tiny_llm_tpu_torch.parallel import (  # noqa: E402
    ShardingConfig,
    TPAttention,
    kv_cache_spec,
    make_mesh,
    paged_pool_spec,
    param_shardings,
    shard_kv_cache,
    shard_params,
)

from .torch_port import f32, port_params  # noqa: E402
from .utils import assert_allclose  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

CPU8 = [torch.device("cpu")] * 8
TOKENS = [[5, 3, 8, 1, 9, 2]]
IDS = [5, 3, 8, 1, 9, 2, 7, 4]


def tp_config():
    """tests/test_sharding.py's tp_config: 8 heads of 64, 8 KV heads,
    intermediate 512, so tp = 8 gives o and down 64 columns a shard, half
    a quant group."""
    return JaxQwen3Config(
        num_hidden_layers=2, hidden_size=256, num_attention_heads=8, num_key_value_heads=8,
        head_dim=64, intermediate_size=512, vocab_size=512, rope_theta=10000.0,
        max_position_embeddings=128,
    )


def _port_cfg(jcfg) -> Qwen3Config:
    return Qwen3Config(**vars(jcfg))


@functools.cache
def _params(key: int, quantized: bool):
    jcfg = tp_config()
    jp = random_params(jcfg, key=key, quantized=quantized)
    return jcfg, jp, port_params(jp, _port_cfg(jcfg))


def _scfg(dp=1, tp=8):
    return ShardingConfig(make_mesh(dp=dp, tp=tp, devices=CPU8[: dp * tp]))


def _jax_scfg(dp=1, tp=8):
    return JaxShardingConfig(jax_make_mesh(dp=dp, tp=tp))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "quant"])
def test_tp_sharded_logits_match_single_device(quantized):
    """test_sharding.py:44 on the port: the tp = 8 model's logits against
    the JAX tp = 8 model's and the port's unsharded model's."""
    jcfg, jp, pp = _params(0, quantized)
    cfg = _port_cfg(jcfg)
    want = np.asarray(JaxQwen3Model(jax_shard_params(jp, _jax_scfg()), jcfg, max_seq_len=128,
                                    attn_impl="xla").forward_full(jnp.asarray(TOKENS)), np.float32)
    model = Qwen3Model(shard_params(pp, _scfg()), cfg, max_seq_len=128, device="cpu")
    got = f32(model(TOKENS))
    assert_allclose(got, want, jnp.bfloat16, atol=5e-2)
    single = f32(Qwen3Model(pp, cfg, max_seq_len=128, device="cpu")(TOKENS))
    if quantized:
        assert_allclose(got, single, jnp.bfloat16, atol=5e-2)
    else:  # dense: f32 partial products, one rounding: the unsharded values
        np.testing.assert_array_equal(got, single)


def _logical(spec, layout: str):
    """A JAX spec in the port's logical (N, K) order: "magic_t" and "pair_t"
    store [K, N] (scales [G, N])."""
    spec = tuple(spec)
    if layout in ("magic_t", "pair_t"):
        return spec[:-2] + spec[-2:][::-1]
    return spec


def _compare_leaf(got, want, where):
    if isinstance(want, JaxQT):
        assert isinstance(got, QuantizedTensor), where
        for leaf in ("packed", "scales", "biases"):
            assert getattr(got, leaf) == _logical(getattr(want, leaf), want.layout), (where, leaf)
    else:
        assert got == (None if want is None else tuple(want)), (where, got, want)


def _compare_specs(got, want, with_head: bool = True):
    _compare_leaf(got.embedding, want.embedding, "embedding")
    assert got.final_norm == tuple(want.final_norm)
    if with_head and got.lm_head is not None:
        _compare_leaf(got.lm_head, want.lm_head, "lm_head")
    for i, (g, w) in enumerate(zip(got.layers, want.layers)):
        assert g.input_layernorm == tuple(w.input_layernorm)
        assert g.post_attention_layernorm == tuple(w.post_attention_layernorm)
        for name in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"):
            _compare_leaf(getattr(g.attn, name), getattr(w.attn, name), (i, name))
        for f in dataclasses.fields(w.mlp):
            _compare_leaf(getattr(g.mlp, f.name), getattr(w.mlp, f.name), (i, f.name))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "quant"])
def test_tp_sharding_specs_cover_params(quantized):
    """test_sharding.py:59 on the port: every leaf has a spec, and each
    names the same logical axes as JAX's (its magic_t specs transposed)."""
    jcfg, jp, pp = _params(0, quantized)
    got = param_shardings(pp, _scfg())
    _compare_specs(got, jax_param_shardings(jp, _jax_scfg()))
    layer = got.layers[0]
    if quantized:
        assert layer.attn.wq.packed == ("tp", None)
        assert layer.attn.wo.packed == (None, "tp")
        assert layer.mlp.w_gate.scales == ("tp", None)
        assert layer.mlp.w_down.scales == (None, None)  # G replicated, as JAX's
    else:
        assert layer.attn.wq == ("tp", None) and layer.mlp.w_down == (None, "tp")


def test_tp_specs_of_fused_params():
    """The port's fused projections take the out-feature split too."""
    _, _, pp = _params(0, True)
    fused = Qwen3Model(pp, _port_cfg(tp_config()), device="cpu").params
    spec = param_shardings(fused, _scfg())
    assert spec.layers[0].attn.wqkv.packed == ("tp", None)
    assert spec.layers[0].mlp.w_gate_up.packed == ("tp", None)
    assert spec.layers[0].attn.wq is None


def test_tp_cached_decode_matches_single_device():
    """test_sharding.py:74 on the port: prefill 5 tokens, then one decode
    step (K2 on the gathered heads) through the tp = 8 model, against the
    JAX tp = 8 model with its KV sharded over heads."""
    jcfg, jp, pp = _params(1, False)
    cfg = _port_cfg(jcfg)
    jm = JaxQwen3Model(jax_shard_params(jp, _jax_scfg()), jcfg, max_seq_len=64, attn_impl="xla")
    jc = jax_shard_kv_cache(jm.create_kv_cache(), _jax_scfg())
    jm(jnp.asarray([IDS[:5]]), 0, jc)
    want = np.asarray(jm(jnp.asarray([IDS[5:6]]), 5, jc, logits_to_keep=1), np.float32)
    model = Qwen3Model(shard_params(pp, _scfg()), cfg, max_seq_len=64, device="cpu")
    cache = shard_kv_cache(model.create_kv_cache(), _scfg())
    assert cache.spec == kv_cache_spec(_scfg()) == (None, "dp", "tp", None, None)
    model([IDS[:5]], 0, cache)
    got = f32(model([IDS[5:6]], 5, cache, logits_to_keep=1))
    assert_allclose(got, want, jnp.bfloat16, atol=5e-2)


def test_shard_kv_cache_refuses_heads_that_do_not_divide():
    _, _, pp = _params(1, False)
    model = Qwen3Model(pp, _port_cfg(tp_config()), max_seq_len=64, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        shard_kv_cache(model.create_kv_cache(batch_size=3), _scfg(dp=2, tp=4))


def test_dp_mesh_batch_sharding():
    """test_sharding.py:101 on the port: dp = 2 x tp = 4, a batch of two
    rows through the sharded model, against the JAX model on that mesh."""
    jcfg, jp, pp = _params(2, False)
    toks = [[5, 3, 8], [1, 9, 2]]
    jm = JaxQwen3Model(jax_shard_params(jp, _jax_scfg(2, 4)), jcfg, max_seq_len=64,
                       attn_impl="xla")
    want = np.asarray(jm.forward_full(jnp.asarray(toks)), np.float32)
    model = Qwen3Model(shard_params(pp, _scfg(2, 4)), _port_cfg(jcfg), max_seq_len=64,
                       device="cpu")
    got = f32(model(toks))
    assert got.shape == (2, 3, jcfg.vocab_size)
    assert_allclose(got, want, jnp.bfloat16, atol=5e-2)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tp_attention_matches_single_device(paged):
    """test_sharding.py:317 and :345 on the port: TPAttention (the port's
    kernels' plain versions per head shard) under the tp = 8 model, a
    prefill and a cached decode step (dense slab or page pool), against
    JAX's TPAttention model and the port's unsharded model."""
    jcfg, jp, pp = _params(6 if not paged else 7, False)
    cfg = _port_cfg(jcfg)
    jm = JaxQwen3Model(jax_shard_params(jp, _jax_scfg()), jcfg, max_seq_len=64,
                       attn_impl=JaxTPAttention(_jax_scfg(), inner="xla"))
    model = Qwen3Model(shard_params(pp, _scfg()), cfg, max_seq_len=64, device="cpu",
                       attn_impl=TPAttention(_scfg()))
    single = Qwen3Model(pp, cfg, max_seq_len=64, device="cpu")
    if paged:
        for m in (jm, model, single):
            m.enable_paged_attention(num_pages=32, page_size=8)
    outs = []
    for m, j in ((jm, True), (model, False), (single, False)):
        c = m.create_kv_cache()
        if not paged and j:
            jax_shard_kv_cache(c, _jax_scfg())
        if j:
            m(jnp.asarray([IDS[:5]]), 0, c)
            outs.append(np.asarray(m(jnp.asarray([IDS[5:6]]), 5, c, logits_to_keep=1),
                                   np.float32))
        else:
            m([IDS[:5]], 0, c)
            outs.append(f32(m([IDS[5:6]], 5, c, logits_to_keep=1)))
    want, got, base = outs
    assert_allclose(got, want, jnp.bfloat16, atol=5e-2)
    np.testing.assert_array_equal(got, base)  # heads are independent: the same values


def test_tp_attention_per_shard_matches_unsharded_kernels():
    """TPAttention.flash and .paged at L = 1 and L = 8, B = 2, against the
    unsharded plain attention: each head's attention is its own."""
    from tiny_llm_tpu_torch.kernels.flash_attention import flash_attention
    from tiny_llm_tpu_torch.kernels.paged_attention import paged_attention

    g = torch.Generator().manual_seed(3)
    tpa = TPAttention(_scfg(tp=4))
    for L in (1, 8):
        q = torch.randn(2, 8, L, 64, generator=g).to(torch.bfloat16)
        k = torch.randn(2, 4, 32, 64, generator=g).to(torch.bfloat16)
        v = torch.randn(2, 4, 32, 64, generator=g).to(torch.bfloat16)
        lens = torch.tensor([20, 32], dtype=torch.int32)
        torch.testing.assert_close(tpa.flash(q, k, v, lens), flash_attention(q, k, v, lens),
                                   rtol=0, atol=0)
        kp = torch.randn(9, 4, 8, 64, generator=g).to(torch.bfloat16)
        vp = torch.randn(9, 4, 8, 64, generator=g).to(torch.bfloat16)
        bt = torch.tensor([[3, 1, 7, -1], [2, 5, 4, 8]], dtype=torch.int32)
        cl = torch.tensor([20, 30], dtype=torch.int32)
        torch.testing.assert_close(tpa.paged(q, kp, vp, bt, cl),
                                   paged_attention(q, kp, vp, bt, cl), rtol=0, atol=0)


def test_tp_attention_reads_head_shards_in_place(monkeypatch):
    """TPAttention hands each head shard's KV to the kernels as a view of
    the slab or the pool (the same storage, no copy), its heads' slice."""
    from tiny_llm_tpu_torch.parallel import tp_kernels

    g = torch.Generator().manual_seed(4)
    tpa = TPAttention(_scfg(tp=4))
    q = torch.randn(2, 8, 1, 64, generator=g).to(torch.bfloat16)
    k = torch.randn(2, 4, 32, 64, generator=g).to(torch.bfloat16)
    kp = torch.randn(9, 4, 8, 64, generator=g).to(torch.bfloat16)
    bt = torch.tensor([[3, 1, 7, -1], [2, 5, 4, 8]], dtype=torch.int32)
    lens = torch.tensor([20, 30], dtype=torch.int32)
    seen = []

    def spy(q_, k_, v_, *args, **kw):
        seen.append((k_, v_))
        return q_.clone()

    monkeypatch.setattr(tp_kernels, "flash_attention", spy)
    monkeypatch.setattr(tp_kernels, "paged_attention", spy)
    tpa.flash(q, k, k, lens)
    tpa.paged(q, kp, kp, bt, lens)
    assert len(seen) == 8
    for s, (kk, vv) in enumerate(seen):
        whole = k if s < 4 else kp
        h = s % 4
        assert kk.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()
        assert vv.untyped_storage().data_ptr() == whole.untyped_storage().data_ptr()
        assert torch.equal(kk, whole[:, h : h + 1])


def test_paged_pool_spec_matches_jax():
    assert paged_pool_spec(_scfg()) == tuple(jax_paged_pool_spec(_jax_scfg()))
    assert kv_cache_spec(_scfg()) == (None, "dp", "tp", None, None)


def test_shard_params_parts_are_copies_on_the_mesh():
    """Each split weight's parts are contiguous copies on their mesh
    devices; fused part-wise, the qkv parts are the unsharded fused
    weight's rows of their KV heads, and gate/up's part s is
    [gate_s; up_s]."""
    jcfg, _, pp = _params(0, True)
    cfg = _port_cfg(jcfg)
    unsharded = Qwen3Model(pp, cfg, device="cpu").params.layers[0]
    sharded = Qwen3Model(shard_params(pp, _scfg(tp=4)), cfg, device="cpu").params.layers[0]
    wqkv, gu = sharded.attn.wqkv, sharded.mlp.w_gate_up
    assert isinstance(wqkv, ShardedWeight) and wqkv.dim == "out" and len(wqkv.parts) == 4
    rows = wqkv.out_features // 4
    for s, p in enumerate(wqkv.parts):
        assert p.packed.is_contiguous()
        assert torch.equal(p.packed, unsharded.attn.wqkv.packed[s * rows : (s + 1) * rows])
    I = jcfg.intermediate_size
    for s, p in enumerate(gu.parts):
        want = torch.cat([unsharded.mlp.w_gate_up.packed[s * I // 4 : (s + 1) * I // 4],
                          unsharded.mlp.w_gate_up.packed[I + s * I // 4 : I + (s + 1) * I // 4]])
        assert torch.equal(p.packed, want)
    assert gu.halves and sharded.mlp.w_down.dim == "in"
    with pytest.raises(ValueError, match="sharded already"):
        shard_params(shard_params(pp, _scfg(tp=4)), _scfg(tp=4))


def _rounding_bound(parts, want):
    """Per element, how far the in-feature split may sit from the unsharded
    K1 output: each part's bf16 rounding (half an ulp of |part|, here one
    ulp), the final rounding and the unsharded one (one ulp of |want| each),
    and f32 sums in another order (2^-20 |want|)."""
    def ulp(v):
        _, e = torch.frexp(v.float())
        return torch.ldexp(torch.ones_like(v.float()), e - 8)

    return sum(ulp(p) for p in parts) + 2 * ulp(want) + 2.0**-20 * want.float().abs()


@pytest.mark.parametrize("shape", ["tp_config_down", "qwen3_4b_down"])
@pytest.mark.parametrize("M", [1, 4, 33])
def test_in_feature_split_across_quant_groups(shape, M):
    """tp = 8 in-feature shards that cut a quant group: tp_config's down
    (K 512: 64 columns a shard, half a group) and Qwen3-4B's down (K 9728,
    76 groups: 1216 columns a shard, 9.5 groups). Each part holds the whole
    groups its columns touch, x outside them zeroed; the sum is within the
    per-shard rounding of the unsharded matmul (residual added once), on
    each of K1's routes' plain versions (M = 1, 4, 33)."""
    N, K = {"tp_config_down": (256, 512), "qwen3_4b_down": (2560, 9728)}[shape]
    g = torch.Generator().manual_seed(K + M)
    w = quantize(torch.randn(N, K, generator=g) * 0.02)
    x = torch.randn(M, K, generator=g).to(torch.bfloat16)
    r = torch.randn(M, N, generator=g).to(torch.bfloat16)
    sw = shard_weight(w, "in", "tp", CPU8)
    assert any(k0 < lo for k0, (lo, _) in zip(sw.k0s, sw.bounds))  # a cut group
    got = sharded_linear(x, sw, residual=r)
    want = quant_matmul(x, w, residual=r)
    parts = []
    for (lo, hi) in sw.bounds:
        xs = torch.zeros_like(x)
        xs[:, lo:hi] = x[:, lo:hi]
        parts.append(quant_matmul(xs, w))
    bound = _rounding_bound(parts, want)
    assert bool(((got.float() - want.float()).abs() <= bound).all())
    # The control: without the zeroed columns a cut group's columns count
    # twice, and the sum misses the bound.
    unmasked = sum(quant_matmul(x[:, k0 : k0 + p.in_features], p).float()
                   for p, k0 in zip(sw.parts, sw.k0s)) + r.float()
    assert bool(((unmasked - want.float()).abs() > bound).any())


@pytest.mark.parametrize("dim", ["out", "in"])
def test_dense_split_is_exact(dim):
    """A dense weight split either way gives the unsharded product: an
    out-feature split is the same rows, an in-feature split sums f32
    partial products and rounds once."""
    g = torch.Generator().manual_seed(5)
    w = (torch.randn(96, 256, generator=g) * 0.05).to(torch.bfloat16)
    x = torch.randn(3, 256, generator=g).to(torch.bfloat16)
    r = torch.randn(3, 96, generator=g).to(torch.bfloat16)
    from tiny_llm_tpu_torch.ops.basics import dense_linear

    got = sharded_linear(x, shard_weight(w, dim, "tp", CPU8[:4]), residual=r)
    want = dense_linear(x, w) + r
    if dim == "out":
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=2.0**-7 * want.abs().max().item())
