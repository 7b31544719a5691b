"""The last names of the JAX package's API in the port, held against the
JAX package on the CPU: the op objects (RMSNorm, RoPE with its
interleaved pairs, Embedding, QuantizedEmbedding, quantized_linear), the
cache contract (KVCache; update_tensors, rewind, offset and materialize on
the dense, batching and paged caches and the pool) and the kernel entry
points under the JAX package's names (quantized_matmul,
grouped_quantized_matmul, flash_decode_attention, combine_state_pair,
split_paged_prefill, default_impl, set_default_impl)."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from tiny_llm_tpu import kernels as jax_kernels  # noqa: E402
from tiny_llm_tpu import ops as jax_ops  # noqa: E402
from tiny_llm_tpu.kv import BatchingKVCache as JaxBatching  # noqa: E402
from tiny_llm_tpu.kv import DenseKVCache as JaxDense  # noqa: E402
from tiny_llm_tpu.kv.paged import PagedBatchingKVCache as JaxPagedBatch  # noqa: E402
from tiny_llm_tpu.kv.paged import PagedKVCache as JaxPaged  # noqa: E402
from tiny_llm_tpu.kv.paged import PagePool as JaxPool  # noqa: E402

from tiny_llm_tpu_torch import kernels, ops  # noqa: E402
from tiny_llm_tpu_torch.kernels import dispatch  # noqa: E402
from tiny_llm_tpu_torch.kernels.flash_attention import flash_attention  # noqa: E402
from tiny_llm_tpu_torch.kernels.moe_matmul import grouped_quant_matmul  # noqa: E402
from tiny_llm_tpu_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from tiny_llm_tpu_torch.kernels.split_prefill import split_paged_prefill  # noqa: E402
from tiny_llm_tpu_torch.kv import (BatchingKVCache, DenseKVCache, KVCache,  # noqa: E402
                                   PagedBatchingKVCache, PagedKVCache, PagePool)
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402

from .torch_port import bf16_numpy, f32, qt_to_numpy, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _quantized(N, K, seed=0):
    """The same W4 g128 weight in both packages (JAX quantize, bridged)."""
    jq = jax_ops.quantize(jnp.asarray(_rand(N, K, seed=seed, scale=0.05)))
    return jq, quantized_from_numpy(qt_to_numpy(jq))


# ---------------------------------------------------------------------------
# Op objects.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_object_matches_jax(dtype):
    x, w = _rand(3, 5, 64, seed=1), _rand(64, seed=2)
    if dtype == "bf16":
        (jx, px), (jw, pw) = bf16_numpy(x), bf16_numpy(w)
    else:
        jx, px, jw, pw = jnp.asarray(x), torch.from_numpy(x), jnp.asarray(w), torch.from_numpy(w)
    got = ops.RMSNorm(64, pw, eps=1e-5)(px)
    want = jax_ops.RMSNorm(64, jw, eps=1e-5)(jx)
    assert got.dtype == px.dtype
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-6 if dtype == "f32" else 2 ** -7,
                               atol=1e-6)
    with pytest.raises(ValueError, match="weight shape"):
        ops.RMSNorm(32, pw)


OFFSETS = {
    "none": None,
    "int": 7,
    "slice": slice(7, 12),
    "list": [3, 11],
    "list_of_slices": [slice(3, 8), slice(0, 5)],
    "rows": np.array([2, 9], np.int32),
    "positions": np.array([[0, 4, 1, 9, 2], [5, 5, 5, 6, 60]], np.int32),
}


@pytest.mark.parametrize("traditional", [False, True], ids=["halves", "traditional"])
@pytest.mark.parametrize("offset", list(OFFSETS), ids=list(OFFSETS))
@pytest.mark.parametrize("dims", [64, 32], ids=["whole", "partial"])
def test_rope_object_matches_jax(traditional, offset, dims):
    """RoPE over [B, L, H, D] at every offset form of the JAX contract, the
    interleaved pairs (traditional) and a rotation of the first dims < D
    features, against the JAX package's RoPE (f32 tables, one rounding)."""
    x = _rand(2, 5, 3, 64, seed=3)
    off = OFFSETS[offset]
    jrope = jax_ops.RoPE(dims, 64, base=10000.0, traditional=traditional)
    prope = ops.RoPE(dims, 64, base=10000.0, traditional=traditional)
    want = jrope(jnp.asarray(x), jnp.asarray(off) if isinstance(off, np.ndarray) else off)
    got = prope(torch.from_numpy(x), torch.from_numpy(off) if isinstance(off, np.ndarray)
                else off)
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=2e-6)
    jb, pb = bf16_numpy(x)
    np.testing.assert_array_equal(
        f32(prope(pb, off if not isinstance(off, np.ndarray) else torch.from_numpy(off))),
        f32(jrope(jb, off if not isinstance(off, np.ndarray) else jnp.asarray(off))))


def test_rope_traditional_pairs_are_interleaved():
    """traditional rotates (x[2i], x[2i + 1]); the halves form (x[i],
    x[i + D/2]): one is the other on features permuted to halves."""
    x = torch.from_numpy(_rand(1, 4, 2, 16, seed=4))
    perm = torch.cat([torch.arange(0, 16, 2), torch.arange(1, 16, 2)])
    trad = ops.RoPE(16, 32, traditional=True)(x, 3)
    halves = ops.RoPE(16, 32)(x[..., perm], 3)
    torch.testing.assert_close(trad[..., perm], halves, rtol=0, atol=0)
    with pytest.raises(ValueError):
        ops.RoPE(16, 32)(x, slice(0, 3))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_embedding_object_matches_jax(dtype):
    w, x = _rand(50, 32, seed=5), _rand(2, 3, 32, seed=6)
    ids = np.array([[0, 7, 49], [3, 3, 12]], np.int32)
    if dtype == "bf16":
        (jw, pw), (jx, px) = bf16_numpy(w), bf16_numpy(x)
    else:
        jw, pw, jx, px = jnp.asarray(w), torch.from_numpy(w), jnp.asarray(x), torch.from_numpy(x)
    je, pe = jax_ops.Embedding(50, 32, jw), ops.Embedding(50, 32, pw)
    np.testing.assert_array_equal(f32(pe(torch.from_numpy(ids))), f32(je(jnp.asarray(ids))))
    got, want = pe.as_linear(px), je.as_linear(jx)
    assert got.dtype == px.dtype and got.shape == (2, 3, 50)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5 if dtype == "f32" else 2 ** -7,
                               atol=1e-5)


@pytest.mark.parametrize("rows", [3, 40], ids=["gemv_rows", "staged_rows"])
def test_quantized_embedding_object_matches_jax(rows):
    """The gather dequantizes bit-equal to JAX's; the tied head is the
    quantized matmul (K1's plain version for the card's route at `rows`)
    within tests/test_torch_k1_routes.py's 2e-2 (6e-2 from 33 rows, where
    JAX's XLA route and the staged tile round the product differently)."""
    jq, pq = _quantized(256, 128, seed=7)
    je, pe = jax_ops.QuantizedEmbedding(256, 128, jq), ops.QuantizedEmbedding(256, 128, pq)
    ids = np.array([[0, 255, 17], [4, 4, 100]], np.int32)
    np.testing.assert_array_equal(f32(pe(torch.from_numpy(ids))), f32(je(jnp.asarray(ids))))
    jx, px = bf16_numpy(_rand(rows, 128, seed=8))
    got, want = pe.as_linear(px), je.as_linear(jx)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, 256)
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=2e-2 if rows <= 32 else 6e-2)
    with pytest.raises(ValueError, match="weight shape"):
        ops.QuantizedEmbedding(128, 256, pq)


@pytest.mark.parametrize("extra", ["plain", "bias", "norm", "residual", "all"])
def test_quantized_linear_matches_jax(extra):
    """quantized_linear (and kernels.quantized_matmul, its body) with a bias,
    a pre-norm, a residual or all three against the JAX package's XLA route
    (2e-2 and one bf16 rounding of the output: the residual and the bias
    add after the kernel's own rounding)."""
    jq, pq = _quantized(96, 256, seed=9)
    (jx, px), (jb, pb) = bf16_numpy(_rand(2, 4, 256, seed=10)), bf16_numpy(_rand(96, seed=11))
    (jn, pn), (jr, pr) = bf16_numpy(1 + _rand(256, seed=12, scale=0.1)), \
        bf16_numpy(_rand(2, 4, 96, seed=13))
    kw_j, kw_p = {}, {}
    if extra in ("bias", "all"):
        kw_j["bias"], kw_p["bias"] = jb, pb
    if extra in ("norm", "all"):
        kw_j["norm_weight"], kw_p["norm_weight"] = jn, pn
    if extra in ("residual", "all"):
        kw_j["residual"], kw_p["residual"] = jr, pr
    want = jax_ops.quantized_linear(jx, jq, impl="xla", **kw_j)
    got = ops.quantized_linear(px, pq, **kw_p)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 4, 96)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2 ** -8, atol=2e-2)
    torch.testing.assert_close(kernels.quantized_matmul(px, pq, **kw_p), got, rtol=0, atol=0)
    torch.testing.assert_close(kernels.quantized_matmul(px, pq, interpret=True, **kw_p), got,
                               rtol=0, atol=0)
    if extra == "plain":
        torch.testing.assert_close(got, quant_matmul(px, pq), rtol=0, atol=0)


def test_quantized_matmul_act_overrides_the_weight_tier():
    """act="int8" runs the W4A8 tier on a W4A16 weight (at decode rows), as
    a weight bridged with act="int8" does."""
    import dataclasses

    _, pq = _quantized(64, 128, seed=14)
    px = torch.from_numpy(_rand(2, 128, seed=15)).to(torch.bfloat16)
    a8 = kernels.quantized_matmul(px, pq, act="int8")
    torch.testing.assert_close(a8, quant_matmul(px, dataclasses.replace(pq, act="int8")),
                               rtol=0, atol=0)
    assert not torch.equal(a8, kernels.quantized_matmul(px, pq))


def test_grouped_quantized_matmul_is_the_grouped_kernel_entry():
    from tiny_llm_tpu_torch.ops.quantize import quantize_stacked

    w = torch.from_numpy(_rand(4, 64, 128, seed=16, scale=0.05))
    qt = quantize_stacked(w)
    x = torch.from_numpy(_rand(9, 128, seed=17)).to(torch.bfloat16)
    sizes = torch.tensor([2, 0, 4, 3], dtype=torch.int32)
    want = grouped_quant_matmul(x, qt, sizes)
    torch.testing.assert_close(kernels.grouped_quantized_matmul(x, qt, sizes), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(kernels.grouped_quantized_matmul(x, qt, sizes, True), want,
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Kernel entry points.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [1, 4, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_decode_attention_matches_jax(L, dtype):
    """Causal attention of the last L positions of each row over `lens`
    against the JAX package's XLA route (f32: its arithmetic; bf16: the
    port rounds the probabilities to bf16, as the kernels do)."""
    B, Hq, Hkv, S, D = 3, 4, 2, 64, 64
    q, k, v = _rand(B, Hq, L, D, seed=18), _rand(B, Hkv, S, D, seed=19), _rand(B, Hkv, S, D,
                                                                              seed=20)
    lens = np.array([L, 33, 64], np.int32)
    if dtype == "bf16":
        (jq, pq), (jk, pk), (jv, pv) = bf16_numpy(q), bf16_numpy(k), bf16_numpy(v)
    else:
        jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
        pq, pk, pv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    want = jax_kernels.flash_decode_attention(jq, jk, jv, jnp.asarray(lens), impl="xla")
    got = kernels.flash_decode_attention(pq, pk, pv, torch.from_numpy(lens))
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=1e-5 if dtype == "f32" else 2e-2)
    torch.testing.assert_close(got, flash_attention(pq, pk, pv, torch.from_numpy(lens)),
                               rtol=0, atol=0)


def test_split_entry_points_are_the_ports():
    """combine_state_pair and split_paged_prefill at the package level are
    the port's; split_paged_prefill(interpret=True) is its impl="torch"."""
    from tiny_llm_tpu_torch.kernels import split_prefill

    assert kernels.combine_state_pair is split_prefill.combine_state_pair
    assert kernels.split_paged_prefill is split_paged_prefill
    B, Hq, Hkv, L, D, ps, P = 2, 4, 2, 8, 64, 8, 6
    q = torch.from_numpy(_rand(B, Hq, L, D, seed=21)).to(torch.bfloat16)
    kc, vc = (torch.from_numpy(_rand(B, Hkv, L, D, seed=s)).to(torch.bfloat16) for s in (22, 23))
    kp, vp = (torch.from_numpy(_rand(P, Hkv, ps, D, seed=s)).to(torch.bfloat16) for s in (24, 25))
    table = torch.tensor([[1, 2, -1], [3, 4, 5]], dtype=torch.int32)
    pre = torch.tensor([9, 20], dtype=torch.int32)
    args = (q, kc, vc, kp, vp, table, pre)
    torch.testing.assert_close(kernels.split_paged_prefill(*args, None, None, True),
                               split_paged_prefill(*args, impl="torch"), rtol=0, atol=0)


def test_default_impl_and_set_default_impl():
    """default_impl is "torch" on a host without a card ("cuda" with one);
    set_default_impl forces every impl=None call, an explicit impl still
    wins, None restores the choice by tensor, and an unknown impl raises."""
    cpu = torch.zeros(1)
    assert kernels.default_impl() == ("cuda" if torch.cuda.is_available() else "torch")
    try:
        kernels.set_default_impl("torch")
        assert kernels.default_impl() == "torch"
        assert dispatch.resolve(None, cpu) == "torch"
        kernels.set_default_impl("cuda")
        assert kernels.default_impl() == "cuda"
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            dispatch.resolve(None, cpu)
        assert dispatch.resolve("torch", cpu) == "torch"
        with pytest.raises(ValueError, match="unknown impl"):
            kernels.set_default_impl("pallas")
    finally:
        kernels.set_default_impl(None)
    assert dispatch.resolve(None, cpu) == "torch"
    assert kernels.default_impl() == ("cuda" if torch.cuda.is_available() else "torch")


# ---------------------------------------------------------------------------
# The cache contract.
# ---------------------------------------------------------------------------


def test_caches_are_kv_caches_and_materialize():
    pool = PagePool(2, 6, 1, 4, 8, device="cpu")
    caches = [DenseKVCache(2, 1, 1, 16, 8, device="cpu"),
              BatchingKVCache(2, 3, 1, 16, 8, device="cpu"),
              PagedKVCache(pool), PagedBatchingKVCache(pool, 2)]
    for c in caches:
        assert isinstance(c, KVCache)
        assert c.materialize() is None
    assert pool.materialize() is None
    with pytest.raises(TypeError):
        KVCache()


def test_dense_update_tensors_and_rewind_match_jax():
    j, p = JaxDense(2, 1, 1, 16, 8), DenseKVCache(2, 1, 1, 16, 8, device="cpu")
    keys, values = _rand(2, 1, 1, 16, 8, seed=26), _rand(2, 1, 1, 16, 8, seed=27)
    j.update_tensors(jnp.asarray(keys), jnp.asarray(values), 11)
    p.update_tensors(torch.from_numpy(keys), torch.from_numpy(values), 11)
    np.testing.assert_array_equal(f32(p.keys), f32(j.keys))
    np.testing.assert_array_equal(f32(p.values), f32(j.values))
    for n in (3, 0, 8):
        j.rewind(n)
        p.rewind(n)
        assert p.offset == j.offset
    with pytest.raises(ValueError, match="rewind"):
        p.rewind(1)


def test_batching_update_tensors_rewind_and_offset_match_jax():
    """Active slots agree with the JAX package's BatchingKVCache through
    update_tensors, rewind and offset. An idle slot keeps offset 0 where
    JAX's rewind takes it below 0 (the port's choice, pinned here: no step
    reads an idle slot's offset before a request is installed there)."""
    j, p = JaxBatching(2, 3, 1, 16, 8), BatchingKVCache(2, 3, 1, 16, 8, device="cpu")
    pre_j, pre_p = JaxDense(2, 1, 1, 16, 8), DenseKVCache(2, 1, 1, 16, 8, device="cpu")
    (jk, pk), (jv, pv) = bf16_numpy(_rand(2, 1, 1, 16, 8, seed=28)), \
        bf16_numpy(_rand(2, 1, 1, 16, 8, seed=29))
    pre_j.update_tensors(jk, jv, 9)
    pre_p.update_tensors(pk, pv, 9)
    for slot in (0, 2):
        j.add_request(pre_j, slot)
        p.add_request(pre_p, slot)
    np.testing.assert_array_equal(f32(p.keys), f32(j.keys))
    assert p.offset == j.offset == 9
    (jk, pk), (jv, pv) = bf16_numpy(_rand(2, 3, 1, 16, 8, seed=30)), \
        bf16_numpy(_rand(2, 3, 1, 16, 8, seed=31))
    j.update_tensors(jk, jv, np.array([12, 0, 10]))
    p.update_tensors(pk, pv, np.array([12, 0, 10]))
    np.testing.assert_array_equal(f32(p.values), f32(j.values))
    j.rewind(4)
    p.rewind(4)
    active = np.array([True, False, True])
    np.testing.assert_array_equal(p.offsets[active], j.offsets[active])
    assert p.offset == j.offset == 8
    assert p.offsets[1] == 0 and j.offsets[1] == -4
    with pytest.raises(ValueError, match="rewind"):
        p.rewind(7)
    p.remove_request(0)
    p.remove_request(2)
    assert p.offset == 0


def test_paged_rewind_matches_jax_and_frees_pages():
    """PagedKVCache.rewind and PagedBatchingKVCache.rewind free the same
    whole trailing pages as the JAX package's (native=False pool)."""
    kw = dict(num_layers=2, num_pages=12, num_kv_heads=1, page_size=4, head_dim=8)
    jp, pp = JaxPool(**kw, native=False), PagePool(**kw, device="cpu")
    jb, pb = JaxPagedBatch(jp, 3), PagedBatchingKVCache(pp, 3)
    for slot, n in ((0, 13), (2, 6)):
        jc, pc = JaxPaged(jp), PagedKVCache(pp)
        for c in (jc, pc):
            c.ensure_capacity(n)
            c.advance(n)
        jb.add_request(jc, slot)
        pb.add_request(pc, slot)
    assert pb.offset == jb.offset == 13
    for n in (1, 4):
        jb.rewind(n)
        pb.rewind(n)
        np.testing.assert_array_equal(pb.offsets, jb.offsets)
        np.testing.assert_array_equal(pb.block_table(4), jb.block_table(4))
        assert pp.free_pages == jp.free_pages
    single_j, single_p = jb.slots[0], pb.slots[0]
    single_j.rewind(5)
    single_p.rewind(5)
    assert single_p.offset == single_j.offset == 3
    assert single_p.page_ids == single_j.page_ids and pp.free_pages == jp.free_pages


def test_page_pool_update_tensors_installs_stacked_or_per_layer_pools():
    kw = dict(num_layers=2, num_pages=4, num_kv_heads=1, page_size=4, head_dim=8)
    jp, pp = JaxPool(**kw, native=False), PagePool(**kw, device="cpu")
    k, v = _rand(2, 4, 1, 4, 8, seed=32), _rand(2, 4, 1, 4, 8, seed=33)
    jp.update_tensors([jnp.asarray(x) for x in k], [jnp.asarray(x) for x in v])
    pp.update_tensors([torch.from_numpy(x) for x in k], [torch.from_numpy(x) for x in v])
    for layer in range(2):
        np.testing.assert_array_equal(f32(pp.key_pages[layer]), f32(jp.key_pages[layer]))
        np.testing.assert_array_equal(f32(pp.value_pages[layer]), f32(jp.value_pages[layer]))
    stacked = torch.from_numpy(k[::-1].copy())
    pp.update_tensors(stacked, torch.from_numpy(v))
    assert pp.key_pages is stacked
