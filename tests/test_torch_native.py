"""The port's native page index (tiny_llm_tpu_torch.native over its own
csrc/page_allocator.cpp, built with g++ into build/) against the JAX
package's Python pool, PagePool(native=False): tests/test_native.py's cases
on the port's default pool, and a serving campaign's recorded bookkeeping
(kv/trace.py) replayed on the native and the Python backends of the port,
which must read the same page ids, block tables, offsets, free pages and
reuse counts at every step; the campaign's texts are the same on both."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tiny_llm_tpu.kv.paged import PagedBatchingKVCache as JaxBatch  # noqa: E402
from tiny_llm_tpu.kv.paged import PagedKVCache as JaxCache  # noqa: E402
from tiny_llm_tpu.kv.paged import PagePool as JaxPool  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu_torch.kv import PagedBatchingKVCache, PagedKVCache, PagePool  # noqa: E402
from tiny_llm_tpu_torch.kv.paged import PoolExhausted  # noqa: E402
from tiny_llm_tpu_torch.kv.trace import PoolRecorder, replay  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Model, from_jax_numpy, tiny_test_config  # noqa: E402
from tiny_llm_tpu_torch.native import NativePageIndex, native_available  # noqa: E402
from tiny_llm_tpu_torch.serving import batch_generate  # noqa: E402

from .torch_port import params_to_numpy  # noqa: E402
from .utils import FakeTokenizer  # noqa: E402

KW = dict(num_layers=1, num_kv_heads=1, page_size=8, head_dim=64)


def _pools(n=10):
    """The port's default pool and the JAX package's Python pool."""
    return PagePool(num_pages=n, device="cpu", **KW), JaxPool(num_pages=n, native=False, **KW)


def test_native_index_builds_and_is_the_default():
    assert native_available()
    assert isinstance(PagePool(num_pages=4, device="cpu", **KW).native_index, NativePageIndex)
    assert PagePool(num_pages=4, device="cpu", native=False, **KW).native_index is None
    # Striped and pinned pools keep their bookkeeping in Python, as in the JAX package.
    assert PagePool(num_pages=8, device="cpu", stripe_shards=2, **KW).native_index is None
    assert PagePool(num_pages=8, device="cpu", dp_shards=2, **KW).native_index is None
    with pytest.raises(ValueError, match="Python"):
        PagePool(num_pages=8, device="cpu", dp_shards=2, native=True, **KW)


def test_failed_build_raises_naming_the_python_pool(monkeypatch):
    """No silent fallback: a pool whose index cannot build raises."""
    from tiny_llm_tpu_torch.native import page_allocator

    def broken(name):
        raise RuntimeError("g++: not found")

    monkeypatch.setattr(page_allocator, "load_library", broken)
    with pytest.raises(RuntimeError, match="native=False"):
        PagePool(num_pages=4, device="cpu", **KW)
    assert PagePool(num_pages=4, device="cpu", native=False, **KW).native_index is None


def test_allocation_order_matches_python():
    nat, py = _pools()
    seq_n = [nat.allocate_page() for _ in range(9)]
    assert seq_n == [py.allocate_page() for _ in range(9)]
    assert 0 not in seq_n  # the trash page is reserved in both
    with pytest.raises(PoolExhausted):
        nat.allocate_page()
    with pytest.raises(RuntimeError):
        py.allocate_page()


def test_free_reuse_parity():
    for pool in _pools():
        a, b = pool.allocate_page(), pool.allocate_page()
        pool.free_page(a)
        pool.free_page(b)
        assert pool.allocate_page() == b  # last in, first out
        assert (pool.reused_page_allocations, pool.free_pages, pool.live_pages) == (1, 8, 1)


def test_request_lifecycle_parity():
    nat, py = _pools(n=20)
    rows = []
    for pool, cache in ((nat, PagedKVCache), (py, JaxCache)):
        c = cache(pool)
        c.ensure_capacity(20)  # 3 pages of 8
        c.advance(20)
        assert (c.num_pages, c.offset) == (3, 20)
        c.rewind(13)  # 7 tokens: 1 page
        assert (c.num_pages, c.offset) == (1, 7)
        rows.append(list(c.block_table_row(4)))
        c.release()
        assert pool.live_pages == 0
    assert rows[0] == rows[1] and rows[0][1:] == [-1, -1, -1]


def test_python_side_checks_kept():
    """The C++ checks nothing; the wrapper keeps the Python pool's errors."""
    nat, _ = _pools()
    c = PagedKVCache(nat)
    c.ensure_capacity(8)
    with pytest.raises(ValueError, match="ensured"):
        c.advance(9)
    c.advance(5)
    with pytest.raises(ValueError, match="past offset"):
        c.rewind(6)
    c.release()
    assert c.offset == 5 and c.page_ids == [] and nat.free_pages == 9


def test_batch_block_table_parity():
    nat, py = _pools(n=20)
    tables = []
    for pool, batch, cache in ((nat, PagedBatchingKVCache, PagedKVCache),
                               (py, JaxBatch, JaxCache)):
        b = batch(pool, 3)
        for slot, n in ((0, 10), (2, 3)):
            c = cache(pool)
            c.ensure_capacity(n)
            c.advance(n)
            b.add_request(c, slot)
        tables.append(b.block_table(4))
    np.testing.assert_array_equal(tables[0], tables[1])
    assert tables[0][1].tolist() == [-1, -1, -1, -1]  # the idle slot


def test_reset_keeps_the_ledger():
    """reset frees every page and keeps the reuse count, in both backends."""
    nat = PagePool(num_pages=6, device="cpu", **KW)
    py = PagePool(num_pages=6, device="cpu", native=False, **KW)
    for pool in (nat, py):
        pages = [pool.allocate_page() for _ in range(3)]
        pool.free_page(pages[-1])
        pool.allocate_page()
        pool.reset()
        assert (pool.free_pages, pool.reused_page_allocations) == (5, 1)
        assert pool.allocate_page() == 1 and pool.reused_page_allocations == 2


@pytest.fixture(scope="module")
def campaign():
    """A serving campaign of 6 prompts over a 24-page pool (pages are
    reused), recorded on the native pool, and its texts on both backends."""
    jcfg, cfg = jax_tiny_config(num_hidden_layers=2), tiny_test_config(num_hidden_layers=2)
    params = from_jax_numpy(params_to_numpy(random_params(jcfg, key=4)), cfg, device="cpu")
    prompts = [f"request {i} " * (1 + i % 3) for i in range(6)]
    kw = dict(max_seq_len=64, batch_size=3, prefill_step=8, max_output_tokens=12,
              decode_burst=4)
    texts, ops = {}, None
    for native in (None, False):
        m = Qwen3Model(params, cfg, max_seq_len=64, device="cpu").enable_paged_attention(
            num_pages=24, page_size=8)
        m.page_pool = PagePool(num_pages=24, device="cpu", native=native, dtype=m.dtype,
                               num_layers=2, num_kv_heads=cfg.num_key_value_heads, page_size=8,
                               head_dim=cfg.head_dim)
        with PoolRecorder() as rec:
            texts[native] = batch_generate(m, FakeTokenizer(), prompts, **kw)
        if native is None:
            assert m.page_pool.native_index is not None and m.page_pool.live_pages == 0
            ops = rec.ops_of(m.page_pool)
    return texts, ops


def test_campaign_texts_equal_on_both_backends(campaign):
    texts, _ = campaign
    assert texts[None] == texts[False] and len(texts[None]) == 6


def test_campaign_bookkeeping_replays_equal(campaign):
    """The recorded sequence (ensure, advance, rewind, release, slots, block
    tables, offsets) replayed on the native and the Python backends: every
    read equal, with the pool's free pages and reuse count beside it."""
    _, ops = campaign
    kinds = {op[0] for op in ops}
    assert {"new", "ensure", "advance", "release", "add", "table", "offsets"} <= kinds
    got = replay(ops, PagePool(num_pages=24, device="cpu", **KW))
    want = replay(ops, PagePool(num_pages=24, device="cpu", native=False, **KW))
    assert len(got) == len(want) > 10
    for i, ((a, fa, ra), (b, fb, rb)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"read {i}")
        assert (fa, ra) == (fb, rb), i
    assert want[-1][2] > 0  # pages were reused
