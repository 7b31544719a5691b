"""The port's plain ops against the JAX package's, on the same numpy inputs."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kv.cache import bucket_for as jax_bucket_for  # noqa: E402
from tiny_llm_tpu.ops import attention as jax_attention  # noqa: E402
from tiny_llm_tpu.ops import basics as jax_basics  # noqa: E402
from tiny_llm_tpu.ops.embedding import quantized_embedding_gather as jax_gather  # noqa: E402
from tiny_llm_tpu.ops.norm import rms_norm as jax_rms_norm  # noqa: E402
from tiny_llm_tpu.ops.quantize import convert_layout, quantize  # noqa: E402
from tiny_llm_tpu.ops.quantize import dequantize as jax_dequantize  # noqa: E402
from tiny_llm_tpu.ops.rope import apply_rope as jax_apply_rope  # noqa: E402
from tiny_llm_tpu.ops.rope import rope_tables as jax_rope_tables  # noqa: E402
from tiny_llm_tpu.ops.sampler import apply_top_k as jax_top_k  # noqa: E402
from tiny_llm_tpu.ops.sampler import apply_top_p as jax_top_p  # noqa: E402
from tiny_llm_tpu.tokenizer import ByteTokenizer as JaxByteTokenizer  # noqa: E402
from tiny_llm_tpu.tokenizer import StreamingDetokenizer as JaxDetok  # noqa: E402
from tiny_llm_tpu_torch.kv.cache import DenseKVCache, bucket_for  # noqa: E402
from tiny_llm_tpu_torch.models.bridge import quantized_from_numpy  # noqa: E402
from tiny_llm_tpu_torch.ops import (  # noqa: E402
    apply_rope,
    concat_out_features,
    dequantize,
    permute_out_features,
    quantized_embedding_gather,
    rms_norm,
    rope_tables,
    scaled_dot_product_attention_grouped,
    scaled_dot_product_attention_simple,
    softmax,
    swiglu,
)
from tiny_llm_tpu_torch.ops.quantize import pack_codes, unpack_codes  # noqa: E402
from tiny_llm_tpu_torch.ops.sampler import apply_top_k, apply_top_p, make_sampler  # noqa: E402
from tiny_llm_tpu_torch.tokenizer import ByteTokenizer, StreamingDetokenizer  # noqa: E402

from .torch_port import bf16_numpy, f32, qt_to_numpy  # noqa: E402
from .utils import assert_allclose  # noqa: E402

BF16_ULP = 2**-7  # one bf16 ulp, relative, at the top of a binade


def _bit_equal(a, b):
    np.testing.assert_array_equal(f32(a), f32(b))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    xj, xt = bf16_numpy(rng.standard_normal((3, 5, 128)) * 3)
    wj, wt = bf16_numpy(rng.standard_normal(128) * 0.2 + 1)
    # Same rounding points (bf16 before the weight multiply); rsqrt may
    # differ by an f32 ulp between libraries, which flips at most one bf16 ulp.
    np.testing.assert_allclose(
        f32(rms_norm(xt, wt, 1e-6)), f32(jax_rms_norm(xj, wj, 1e-6)), rtol=BF16_ULP, atol=0
    )


def test_rope_tables_and_apply_match_jax():
    D, S = 64, 256
    cj, sj = jax_rope_tables(D, S, base=10000.0)
    ct, st = rope_tables(D, S, base=10000.0, device="cpu")
    # f32 ladder, absolute: cos/sin of arguments up to 255 rad from two libms.
    assert_allclose(f32(ct), f32(cj), precision=jnp.float32, atol=2e-6)
    assert_allclose(f32(st), f32(sj), precision=jnp.float32, atol=2e-6)
    rng = np.random.default_rng(1)
    xj, xt = bf16_numpy(rng.standard_normal((2, 7, 3, D)))
    pos = rng.integers(0, S, size=(2, 7))
    got = apply_rope(xt, ct, st, torch.from_numpy(pos), D)
    want = jax_apply_rope(xj, cj, sj, jnp.asarray(pos, jnp.int32), D)
    # f32 rotate, one bf16 round: tables within 2e-6 flip at most one ulp.
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_ULP, atol=BF16_ULP * 2**-6)


def test_swiglu_softmax_match_jax():
    rng = np.random.default_rng(2)
    gj, gt = bf16_numpy(rng.standard_normal((4, 96)) * 4)
    uj, ut = bf16_numpy(rng.standard_normal((4, 96)))
    # Two bf16 ulps: XLA's logistic on the CPU and torch's sigmoid round
    # differently, and each elementwise op rounds to bf16 in between.
    np.testing.assert_allclose(
        f32(swiglu(gt, ut)), f32(jax_basics.swiglu(gj, uj)), rtol=2 * BF16_ULP, atol=1e-6
    )
    x = rng.standard_normal((3, 50)).astype(np.float32) * 5
    assert_allclose(
        f32(softmax(torch.from_numpy(x))), f32(jax_basics.softmax(jnp.asarray(x))),
        precision=jnp.float32,
    )


@pytest.mark.parametrize("mask", [None, "causal"])
def test_grouped_and_simple_sdpa_match_jax(mask):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 6, 32)).astype(np.float32)
    k = rng.standard_normal((2, 2, 9, 32)).astype(np.float32)
    v = rng.standard_normal((2, 2, 9, 32)).astype(np.float32)
    got = scaled_dot_product_attention_grouped(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), mask=mask
    )
    want = jax_attention.scaled_dot_product_attention_grouped(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=mask
    )
    # f32 ladder, with atol for the sums of 9 products in another order.
    assert_allclose(f32(got), f32(want), precision=jnp.float32, atol=1e-5)
    kk = np.repeat(k, 2, axis=1)
    vv = np.repeat(v, 2, axis=1)
    got_s = scaled_dot_product_attention_simple(
        torch.from_numpy(q), torch.from_numpy(kk), torch.from_numpy(vv)
    )
    want_s = jax_attention.scaled_dot_product_attention_simple(
        jnp.asarray(q), jnp.asarray(kk), jnp.asarray(vv)
    )
    assert_allclose(f32(got_s), f32(want_s), precision=jnp.float32, atol=1e-5)


@pytest.mark.parametrize("layout,bits,gs", [
    pytest.param("magic_t", 4, 128, id="magic_t"),
    pytest.param("sg", 4, 128, id="sg"),
    pytest.param("pair_t", 4, 128, id="pair_t"),
    pytest.param("sg", 2, 64, id="sg-W2g64"),
    pytest.param("sg", 8, 64, id="sg-W8g64"),
    pytest.param("sg", 4, 32, id="sg-W4g32"),
])
def test_dequantize_bit_equal_through_bridge(layout, bits, gs):
    """q*s is exact in f32, so the f32 multiply-add rounds once on both sides."""
    rng = np.random.default_rng(4)
    w = rng.standard_normal((96, 640)).astype(np.float32) * 0.05
    qt = quantize(jnp.asarray(w), group_size=gs, bits=bits, layout=layout)
    port = quantized_from_numpy(qt_to_numpy(qt))
    assert port.k_padded == 640 and port.packed.shape == (96, 640 * bits // 32)
    assert (port.bits, port.group_size) == (bits, gs)
    assert port.act == ("int8" if layout == "pair_t" else "bf16")
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
        _bit_equal(dequantize(port, dtype), jax_dequantize(qt, jdtype))


def test_quantized_embedding_gather_bit_equal():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((300, 256)).astype(np.float32) * 0.05
    qt = quantize(jnp.asarray(w), layout="sg")
    port = quantized_from_numpy(qt_to_numpy(qt))
    ids = rng.integers(0, 300, size=(2, 9))
    _bit_equal(
        quantized_embedding_gather(port, torch.from_numpy(ids)),
        jax_gather(qt, jnp.asarray(ids, jnp.int32)),
    )
    # The JAX package's magic_t copy of the same codes (its tied LM head)
    # bridges to the very same port tensor.
    same = quantized_from_numpy(qt_to_numpy(convert_layout(qt, "magic_t")))
    assert torch.equal(same.packed, port.packed) and torch.equal(same.scales, port.scales)


def test_pack_roundtrip_concat_permute_exact():
    rng = np.random.default_rng(6)
    codes = torch.from_numpy(rng.integers(0, 16, size=(10, 256)).astype(np.int32))
    assert torch.equal(unpack_codes(pack_codes(codes)), codes)
    qts = [
        quantized_from_numpy(qt_to_numpy(quantize(jnp.asarray(
            rng.standard_normal((n, 256)).astype(np.float32)))))
        for n in (32, 64)
    ]
    cat = concat_out_features(qts)
    assert torch.equal(dequantize(cat), torch.cat([dequantize(q) for q in qts]))
    perm = rng.permutation(96)
    assert torch.equal(dequantize(permute_out_features(cat, perm)), dequantize(cat)[perm])


def test_samplers_match_jax_masks():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((3, 40)).astype(np.float32) * 3
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lpt, lpj = torch.from_numpy(lp), jnp.asarray(lp)
    np.testing.assert_array_equal(f32(apply_top_k(lpt, 5)), f32(jax_top_k(lpj, 5)))
    np.testing.assert_array_equal(f32(apply_top_p(lpt, 0.7)), f32(jax_top_p(lpj, 0.7)))
    greedy = make_sampler(0.0)(lpt)
    np.testing.assert_array_equal(greedy.numpy(), np.argmax(lp, -1))
    gen = torch.Generator().manual_seed(0)
    drawn = make_sampler(1.0, top_k=1)(lpt, gen)
    np.testing.assert_array_equal(drawn.numpy(), np.argmax(lp, -1))  # top-1 is forced


def test_bucket_for_and_dense_cache():
    for n in (1, 127, 128, 129, 700, 5000):
        assert bucket_for(n) == jax_bucket_for(n)
        assert bucket_for(n, maximum=1024) == jax_bucket_for(n, maximum=1024)
    c = DenseKVCache(2, 1, 1, 16, 8, device="cpu")
    assert c.keys.shape == (2, 1, 1, 16, 8) and c.keys.dtype == torch.bfloat16
    c.advance(5)
    c.rewind(2)
    assert c.offset == 3
    with pytest.raises(ValueError):
        c.rewind(4)
    with pytest.raises(ValueError):
        c.advance(14)


def test_tokenizers_match_jax():
    text = "naïve café — 你好 🌍"
    jt, pt = JaxByteTokenizer(), ByteTokenizer()
    ids = jt.encode(text)
    assert pt.encode(text) == ids and pt.decode(ids) == jt.decode(ids)
    jd, pd = JaxDetok(jt), StreamingDetokenizer(pt)
    segs = [(pd.add_token(i), jd.add_token(i)) for i in ids]
    assert all(a == b for a, b in segs)
    assert pd.finalize() == jd.finalize() and pd.text == jd.text == text

