"""The port's paged KV cache, paged kernels (plain versions, on the CPU)
and paged model path against the JAX package: the page bookkeeping against
PagePool(native=False), the kernels' plain versions against the Pallas
kernels in interpret mode and the XLA oracle, and the 2-layer paged model
against JAX's paged Qwen3Model, all on the same numpy inputs."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.fused_decode_attention import (  # noqa: E402
    fused_paged_decode_attention as jax_fused_paged,
)
from tiny_llm_tpu.kernels.paged_attention import paged_attention as jax_paged_attention  # noqa: E402
from tiny_llm_tpu.kernels.paged_attention_pallas import (  # noqa: E402
    paged_flash_decode_gather,
    paged_flash_prefill,
)
from tiny_llm_tpu.kv.paged import PagedBatchingKVCache as JaxBatch  # noqa: E402
from tiny_llm_tpu.kv.paged import PagedKVCache as JaxCache  # noqa: E402
from tiny_llm_tpu.kv.paged import PagePool as JaxPool  # noqa: E402
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu.ops.rope import rope_tables as jax_rope_tables  # noqa: E402
from tiny_llm_tpu_torch.kernels.fused_decode_attention import (  # noqa: E402
    fused_paged_decode_attention,
)
from tiny_llm_tpu_torch.kernels.paged_attention import paged_attention  # noqa: E402
from tiny_llm_tpu_torch.kv import PagedBatchingKVCache, PagedKVCache, PagePool  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Model, from_jax_numpy, tiny_test_config  # noqa: E402

from .torch_port import bf16_numpy, f32, params_to_numpy  # noqa: E402
from .utils import assert_allclose  # noqa: E402

# Logit tolerance (bf16 ladder, absolute), as tests/test_torch_model.py.
LOGIT_ATOL = 3e-2


# ---------------------------------------------------------------------------
# Page bookkeeping
# ---------------------------------------------------------------------------


def test_pool_bookkeeping_matches_jax_pure_python_pool():
    """One operation sequence on both pools: the same page ids, block
    tables, free and live counts and reuse counter after every step."""
    kw = dict(num_layers=1, num_pages=12, num_kv_heads=1, page_size=4, head_dim=8)
    jp, tp = JaxPool(**kw, native=False), PagePool(**kw, device="cpu")
    jb, tb = JaxBatch(jp, 3), PagedBatchingKVCache(tp, 3)
    caches = {}

    def check():
        assert (tp.free_pages, tp.live_pages, tp.reused_page_allocations) == (
            jp.free_pages, jp.live_pages, jp.reused_page_allocations)
        np.testing.assert_array_equal(tb.block_table(8), jb.block_table(8))
        np.testing.assert_array_equal(tb.offsets, jb.offsets)
        np.testing.assert_array_equal(tb.active, jb.active)
        for j, t in caches.values():
            assert (t.page_ids, t.offset, t.num_pages) == (j.page_ids, j.offset, j.num_pages)
            assert t.block_table_row(6) == j.block_table_row(6)

    for name, slot, n in (("a", 0, 9), ("b", 2, 3), ("c", 1, 14)):
        j, t = JaxCache(jp), PagedKVCache(tp)
        j.ensure_capacity(n)
        t.ensure_capacity(n)
        j.advance(n)
        t.advance(n)
        jb.add_request(j, slot)
        tb.add_request(t, slot)
        caches[name] = (j, t)
        check()
    for j, t in caches.values():
        j.ensure_capacity(j.offset + 5)
        t.ensure_capacity(t.offset + 5)
        j.advance(5)
        t.advance(5)
    check()
    for j, t in caches.values():
        j.rewind(6)
        t.rewind(6)
    check()
    jb.remove_request(2)
    tb.remove_request(2)
    del caches["b"]
    check()
    # Freed pages come back first (last in, first out) and count as reused.
    j, t = JaxCache(jp), PagedKVCache(tp)
    j.ensure_capacity(10)
    t.ensure_capacity(10)
    caches["d"] = (j, t)
    check()
    assert tp.reused_page_allocations > 0
    jb.release()
    tb.release()
    for j, t in caches.values():
        j.release()
        t.release()
    check()
    assert tp.live_pages == 0 and tp.free_pages == 11


def test_pool_exhaustion_and_cache_misuse_raise():
    from tiny_llm_tpu_torch.kv import PoolExhausted

    pool = PagePool(1, 3, 1, 4, 8, device="cpu")
    c = PagedKVCache(pool)
    with pytest.raises(PoolExhausted):
        c.ensure_capacity(9)  # 3 pages; 2 allocatable
    assert c.num_pages == 2
    with pytest.raises(ValueError):
        c.advance(9)
    with pytest.raises(ValueError):
        c.rewind(1)
    c.release()
    assert pool.free_pages == 2


# ---------------------------------------------------------------------------
# Kernels: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

HKV, N_REP, D, PS = 2, 2, 128, 16


def _shuffled_pool(rng, lens, maxp):
    """Pages of B rows scattered over a shuffled pool; -1-padded tables.
    Page 0 (trash) and the free pages hold noise, so a kernel reading a
    page it should not would disagree."""
    B = len(lens)
    used = [-(-n // PS) for n in lens]
    P = sum(used) + 4
    perm = rng.permutation(np.arange(1, P))
    bt = np.full((B, maxp), -1, np.int32)
    k = 0
    for b, n in enumerate(used):
        bt[b, :n] = perm[k : k + n]
        k += n
    kp = rng.standard_normal((P, HKV, PS, D))
    vp = rng.standard_normal((P, HKV, PS, D))
    return bt, kp, vp


@pytest.mark.parametrize("L", [4, 32], ids=["decode_L4", "prefill_L32"])
def test_paged_attention_plain_matches_pallas_and_xla(L):
    """L = 4 takes the paged decode gather kernel, L = 32 the paged prefill
    kernel: each row's context is its own; row 1 ends mid-page."""
    rng = np.random.default_rng(L)
    lens = np.asarray([L + 37, L + 6], np.int32)
    maxp = 6
    bt, kp, vp = _shuffled_pool(rng, lens, maxp)
    q_j, q_t = bf16_numpy(rng.standard_normal((2, HKV * N_REP, L, D)))
    kp_j, kp_t = bf16_numpy(kp)
    vp_j, vp_t = bf16_numpy(vp)
    scale = D**-0.5
    args_j = (q_j, kp_j, vp_j, jnp.asarray(bt), jnp.asarray(lens))
    if L <= 16:
        want = paged_flash_decode_gather(*args_j, scale=scale, pages_per_tile=2, interpret=True)
    else:
        want = paged_flash_prefill(*args_j, scale=scale, bq=16, interpret=True)
    oracle = jax_paged_attention(*args_j, scale=scale, impl="xla")
    got = paged_attention(q_t, kp_t, vp_t, torch.from_numpy(bt), torch.from_numpy(lens), scale)
    assert got.dtype == torch.bfloat16 and got.shape == q_t.shape
    # bf16 ladder: one softmax where the kernels rescale per tile, and bf16
    # probabilities (kernels, plain) against the oracle's f32 ones.
    assert_allclose(f32(got), f32(want), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)
    assert_allclose(f32(got), f32(oracle), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("offs", [[5, 60], [0, 33]], ids=["mid_page", "empty_row"])
def test_fused_paged_decode_attention_plain_matches_pallas(offs):
    rng = np.random.default_rng(sum(offs))
    B, maxp = len(offs), 5
    bt, kp, vp = _shuffled_pool(rng, [o + 1 for o in offs], maxp)
    qkv_j, qkv_t = bf16_numpy(rng.standard_normal((B, HKV, N_REP + 2, D)))
    kp_j, kp_t = bf16_numpy(kp)
    vp_j, vp_t = bf16_numpy(vp)
    qw_j, qw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    kw_j, kw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    cos, sin = (np.asarray(t) for t in jax_rope_tables(D, maxp * PS))
    off = np.asarray(offs, np.int32)
    scale, eps = D**-0.5, 1e-6
    want = jax_fused_paged(
        qkv_j, kp_j, vp_j, jnp.asarray(bt), jnp.asarray(off), jnp.asarray(cos[off]),
        jnp.asarray(sin[off]), qw_j, kw_j, scale=scale, eps=eps, interpret=True,
    )
    got = fused_paged_decode_attention(
        qkv_t, kp_t, vp_t, torch.from_numpy(bt), torch.from_numpy(off),
        torch.from_numpy(cos[off]), torch.from_numpy(sin[off]), qw_t, kw_t, scale=scale, eps=eps,
    )
    # As K2 (tests/test_torch_kernels.py): attention on the bf16 ladder, the
    # k row within one bf16 ulp, the v row bit for bit.
    assert_allclose(f32(got[0]), f32(want[0]), precision=jnp.bfloat16, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(f32(got[1]), f32(want[1]), rtol=2**-7, atol=2**-7)
    np.testing.assert_array_equal(f32(got[2]), f32(want[2]))


def test_paged_attention_plain_idle_row_is_finite():
    """An idle batch row (table all -1, context = L) reads the trash page
    and gives finite values, which the model discards."""
    rng = np.random.default_rng(0)
    bt = np.asarray([[1, 2], [-1, -1]], np.int32)
    kp = torch.from_numpy(rng.standard_normal((3, 1, 4, 64))).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 2, 2, 64))).to(torch.bfloat16)
    out = paged_attention(q, kp, kp.clone(), torch.from_numpy(bt), torch.tensor([7, 2]))
    assert torch.isfinite(out.float()).all()


# ---------------------------------------------------------------------------
# The paged model against JAX's paged Qwen3Model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def paged_pair():
    cfg_kw = dict(num_hidden_layers=2)
    jcfg, pcfg = jax_tiny_config(**cfg_kw), tiny_test_config(**cfg_kw)
    params = random_params(jcfg, key=3)
    jm = JaxQwen3Model(params, jcfg, max_seq_len=128).enable_paged_attention(
        num_pages=40, page_size=8)
    port_params = from_jax_numpy(params_to_numpy(params), pcfg, device="cpu")
    pm = Qwen3Model(port_params, pcfg, max_seq_len=128, device="cpu").enable_paged_attention(
        num_pages=40, page_size=8)
    dense = Qwen3Model(port_params, pcfg, max_seq_len=128, device="cpu")
    return jm, pm, dense


def _assert_logits(got, want):
    got, want = f32(got), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


def test_paged_model_matches_jax_chunks_then_burst(paged_pair):
    """Chunks at offset 0 (local attention, L = 20), at offset > 0 with
    L = 32 (paged prefill) and L = 4 (paged decode), a single decode step
    (fused paged), then a decode burst over a batching cache with an idle
    slot: logits within the ladder, burst tokens equal."""
    jm, pm, _ = paged_pair
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(0, 128, size=57)]
    cj, cp = jm.create_kv_cache(), pm.create_kv_cache()
    off = 0
    for L in (20, 32, 4):
        chunk = [prompt[off : off + L]]
        _assert_logits(pm(chunk, off, cp), jm(jnp.asarray(chunk, jnp.int32), off, cj))
        off += L
    tok = int(np.argmax(np.asarray(jm(jnp.asarray([[prompt[off]]], jnp.int32), off, cj),
                                   np.float32)[0, -1]))
    step = pm([[prompt[off]]], off, cp)
    assert int(f32(step)[0, -1].argmax()) == tok
    off += 1
    bj, bp = jm.create_batching_kv_cache(max_active_requests=2), pm.create_batching_kv_cache(2)
    bj.add_request(cj, 1)
    bp.add_request(cp, 1)
    want = jm.decode_burst(bj, np.asarray([0, tok], np.int32), 6)
    got = pm.decode_burst(bp, np.asarray([0, tok], np.int32), 6)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])  # slot 0 is idle: garbage
    assert cp.offset == cj.offset == off + 6
    bj.release()
    bp.release()
    assert pm.page_pool.live_pages == 0


def test_paged_and_dense_port_models_agree(paged_pair):
    """The same chunks and decode steps over the page pool and over the
    dense slab give the same logits (plain versions on the CPU: the paged
    ones gather the pages and run the dense ones' arithmetic)."""
    _, pm, dense = paged_pair
    rng = np.random.default_rng(8)
    prompt = [int(t) for t in rng.integers(0, 128, size=45)]
    cp, cd = pm.create_kv_cache(), dense.create_kv_cache()
    off = 0
    for L in (16, 24, 2, 1, 1, 1):
        chunk = [prompt[off : off + L]]
        torch.testing.assert_close(pm(chunk, off, cp), dense(chunk, off, cd),
                                   rtol=1e-5, atol=1e-5)
        off += L
    cp.release()
    assert pm.page_pool.live_pages == 0


def test_split_size_chunk_and_mixed_raise(monkeypatch):
    """An offset > 0 chunk of >= 1024 tokens takes the split paged prefill
    (it raised before the split was ported) and gives the unsplit route's
    logits; the paged model supports mixed bursts."""
    import tiny_llm_tpu_torch.models.qwen3 as port_qwen3
    from tiny_llm_tpu_torch.models import synthetic_quantized_params

    cfg = tiny_test_config(num_hidden_layers=1)
    m = Qwen3Model(synthetic_quantized_params(cfg, device="cpu"), cfg, max_seq_len=2048,
                   device="cpu").enable_paged_attention(num_pages=12, page_size=128)
    calls = []
    orig = port_qwen3.split_paged_prefill
    monkeypatch.setattr(port_qwen3, "split_paged_prefill",
                        lambda *a, **k: calls.append(a[0].shape[2]) or orig(*a, **k))
    c = m.create_kv_cache()
    m([[1]], 0, c)
    got = m([[2] * 1024], 1, c)
    assert calls == [1024]
    table = torch.tensor([c.block_table_row(m._paged_width)], dtype=torch.int32)
    c.rewind(1024)
    want = port_qwen3.forward_step_paged(
        m.params, cfg, m._rope_tables, torch.full((1, 1024), 2), torch.tensor([1], dtype=torch.int32),
        m.page_pool.key_pages, m.page_pool.value_pages, table, logits_to_keep=None,
    )
    torch.testing.assert_close(got, want, rtol=0, atol=LOGIT_ATOL)
    assert m.supports_mixed is True
    c.release()
