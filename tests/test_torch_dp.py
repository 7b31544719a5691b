"""The port's data parallelism (tiny_llm_tpu_torch.parallel: DPServing,
DPPagedAttention, DPPagedBatchingKVCache, the dp-striped PagePool, and the
scheduler's admission veto, on the CPU) against the JAX package's
(tests/test_sharding.py's DP cases on tests/conftest.py's 8 virtual
devices): the striped pool's page ids, both attention regimes, the
stripe-local page writes, and dense and paged batch_generate runs at
dp = 2 x tp = 4, whose texts must equal JAX's exactly."""

from __future__ import annotations

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kv.paged import PagedKVCache as JaxPagedKVCache  # noqa: E402
from tiny_llm_tpu.kv.paged import PagePool as JaxPagePool  # noqa: E402
from tiny_llm_tpu.models import Qwen3Config as JaxQwen3Config  # noqa: E402
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.parallel import DPPagedAttention as JaxDPPagedAttention  # noqa: E402
from tiny_llm_tpu.parallel import DPServing as JaxDPServing  # noqa: E402
from tiny_llm_tpu.parallel import ShardingConfig as JaxShardingConfig  # noqa: E402
from tiny_llm_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from tiny_llm_tpu.parallel import shard_params as jax_shard_params  # noqa: E402
from tiny_llm_tpu.parallel.dp import dp_paged_pool_spec as jax_dp_pool_spec  # noqa: E402
from tiny_llm_tpu.serving.batch import batch_generate as jax_batch_generate  # noqa: E402
from tiny_llm_tpu_torch.kernels.paged_attention import paged_attention  # noqa: E402
from tiny_llm_tpu_torch.kv.paged import PagedKVCache, PagePool, PoolExhausted  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Config, Qwen3Model  # noqa: E402
from tiny_llm_tpu_torch.parallel import (  # noqa: E402
    DPPagedAttention,
    DPPagedBatchingKVCache,
    DPServing,
    ShardingConfig,
    dp_paged_pool_spec,
    make_mesh,
    shard_params,
)
from tiny_llm_tpu_torch.serving import batch_generate  # noqa: E402

from .torch_port import f32, port_params  # noqa: E402
from .utils import FakeTokenizer  # noqa: E402

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

CPU8 = [torch.device("cpu")] * 8
PROMPTS = [f"prompt number {i} padding" for i in range(6)]
SERVE = dict(max_seq_len=64, batch_size=4, prefill_step=8, max_output_tokens=5)


def tp_config():
    """tests/test_sharding.py's tp_config."""
    return JaxQwen3Config(
        num_hidden_layers=2, hidden_size=256, num_attention_heads=8, num_key_value_heads=8,
        head_dim=64, intermediate_size=512, vocab_size=512, rope_theta=10000.0,
        max_position_embeddings=128,
    )


@functools.cache
def _params():
    jcfg = tp_config()
    jp = random_params(jcfg, key=0, quantized=False)
    return jcfg, jp, port_params(jp, Qwen3Config(**vars(jcfg)))


def _scfg():
    return ShardingConfig(make_mesh(dp=2, tp=4, devices=CPU8))


def _jax_scfg():
    return JaxShardingConfig(jax_make_mesh(dp=2, tp=4))


def _port_model(paged: bool, pages: int = 34):
    jcfg, _, pp = _params()
    model = Qwen3Model(shard_params(pp, _scfg()), Qwen3Config(**vars(jcfg)), max_seq_len=64,
                       device="cpu", attn_impl=DPPagedAttention(_scfg()) if paged else None)
    if paged:
        model.enable_paged_attention(num_pages=pages, page_size=8)
    return model


@functools.cache
def _jax_texts(paged: bool):
    """The JAX package's DP run at dp = 2 x tp = 4 (test_sharding.py:613 and
    :791), sorted by prompt."""
    jcfg, jp, _ = _params()
    model = JaxQwen3Model(jax_shard_params(jp, _jax_scfg()), jcfg, max_seq_len=64,
                          attn_impl=JaxDPPagedAttention(_jax_scfg(), inner="xla") if paged
                          else "xla")
    if paged:
        model.enable_paged_attention(num_pages=34, page_size=8)
    return sorted(jax_batch_generate(JaxDPServing(model, _jax_scfg()), FakeTokenizer(),
                                     list(PROMPTS), **SERVE))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_dp_batch_generate_matches_jax(paged):
    """test_sharding.py:613 (dense) and :791 (paged) on the port: the texts
    of a continuous-batching run at dp = 2 x tp = 4 equal JAX's exactly;
    the paged run leaves no page allocated."""
    model = _port_model(paged)
    dp_model = DPServing(model, _scfg())
    got = sorted(batch_generate(dp_model, FakeTokenizer(), list(PROMPTS), **SERVE))
    assert got == _jax_texts(paged)
    if paged:
        assert model.page_pool.live_pages == 0
        assert model.page_pool.free_pages == 34 - 2


@pytest.mark.parametrize("rows", [2, 3], ids=["splits", "does_not_split"])
def test_dp_replicas_serve_their_rows(rows, monkeypatch):
    """shard_params over dp = 2 x tp = 4 replicates every matmul weight (one
    copy a replica, each split over its replica's tp devices), and a batch
    runs each replica's block of rows on its copy: every tp part sees
    B / dp rows (all B on replica 0 where B does not divide), each
    replica's parts once a matmul; the logits are the unsharded model's."""
    from tiny_llm_tpu_torch.ops import sharded

    jcfg, _, pp = _params()
    cfg = Qwen3Config(**vars(jcfg))
    params = shard_params(pp, _scfg())
    w = params.layers[0].attn.wq
    assert w.dim == "batch" and w.axis == "dp" and len(w.parts) == 2
    assert all(p.dim == "out" and p.axis == "tp" and len(p.parts) == 4 for p in w.parts)
    assert params.lm_head is None or params.lm_head.dim == "batch"
    seen = []
    real = sharded.dense_linear
    monkeypatch.setattr(sharded, "dense_linear",
                        lambda x, w_, **kw: seen.append(x.shape[0]) or real(x, w_, **kw))
    toks = [[5, 3, 8], [1, 9, 2], [4, 4, 6]][:rows]
    got = f32(Qwen3Model(params, cfg, max_seq_len=64, device="cpu")(toks))
    monkeypatch.setattr(sharded, "dense_linear", real)
    want = f32(Qwen3Model(pp, cfg, max_seq_len=64, device="cpu")(toks))
    per = rows // 2 if rows % 2 == 0 else rows
    # 4 parts a matmul (qkv, o, gate/up, down) a layer, per replica that runs.
    assert seen == [per] * (4 * 4 * jcfg.num_hidden_layers * (rows // per))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_dp_batching_cache_is_sharded_over_dp():
    """test_sharding.py:645 on the port."""
    dp_model = DPServing(_port_model(False), _scfg())
    cache = dp_model.create_batching_kv_cache(max_active_requests=4)
    assert cache.spec[1] == "dp" and cache.spec[2] == "tp"
    assert dp_model.slot_replica(0, 4) == 0
    assert dp_model.slot_replica(3, 4) == 1
    with pytest.raises(ValueError, match="divisible"):
        dp_model.create_batching_kv_cache(max_active_requests=3)


def test_dp_paged_requires_strategy_attn():
    """test_sharding.py:661 on the port."""
    jcfg, _, pp = _params()
    model = Qwen3Model(pp, Qwen3Config(**vars(jcfg)), max_seq_len=64, device="cpu")
    model.enable_paged_attention(num_pages=8, page_size=8)
    with pytest.raises(ValueError, match="DPPagedAttention"):
        DPServing(model, _scfg())


def test_dp_striped_pool_allocation_pinning():
    """test_sharding.py:676 on the port, page for page against JAX's pool."""
    pool = PagePool(num_layers=1, num_pages=16, num_kv_heads=2, page_size=8, head_dim=16,
                    dp_shards=2, device="cpu")
    jpool = JaxPagePool(num_layers=1, num_pages=16, num_kv_heads=2, page_size=8, head_dim=16,
                        dp_shards=2, native=False)
    assert pool.reserved_pages == jpool.reserved_pages == 2
    assert pool.free_pages == jpool.free_pages == 14
    c0, c1 = PagedKVCache(pool, shard=0), PagedKVCache(pool, shard=1)
    j0, j1 = JaxPagedKVCache(jpool, shard=0), JaxPagedKVCache(jpool, shard=1)
    for c, j, n in ((c0, j0, 30), (c1, j1, 20)):
        c.ensure_capacity(n)
        j.ensure_capacity(n)
        assert c.page_ids == j.page_ids
    assert all(1 <= p <= 7 for p in c0.page_ids) and all(9 <= p <= 15 for p in c1.page_ids)
    c0.ensure_capacity(7 * 8)
    with pytest.raises(PoolExhausted, match="stripe 0"):
        c0.ensure_capacity(8 * 8)
    assert PagedKVCache(pool).shard == JaxPagedKVCache(jpool).shard == 1
    c0.release()
    c1.release()
    assert pool.free_pages == 14
    with pytest.raises(ValueError, match="exclusive"):
        PagePool(1, 16, 2, 8, 16, device="cpu", dp_shards=2, stripe_shards=2)


def _dp_paged_setup(B, P_pages=16, Hq=8, Hkv=4, ps=8, D=64, L=1, seed=0):
    """test_sharding.py:705's inputs: block tables obeying the pinning for
    dp = 2 (the first half of the batch in pages [1, 8), the second in
    [9, 16))."""
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(P_pages, Hkv, ps, D)).astype(np.float32)
    vp = rng.normal(size=(P_pages, Hkv, ps, D)).astype(np.float32)
    q = rng.normal(size=(B, Hq, L, D)).astype(np.float32)
    maxp, P_loc = 3, P_pages // 2
    table = np.full((B, maxp), -1, np.int32)
    lens = np.zeros((B,), np.int32)
    for b in range(B):
        base = 1 if b < B // 2 or B == 1 else P_loc + 1
        n = int(rng.integers(-(-L // ps), maxp + 1))
        table[b, :n] = rng.choice(np.arange(base, base + P_loc - 1), size=n, replace=False)
        lens[b] = int(rng.integers(max((n - 1) * ps + 1, L), n * ps + 1))
    return q, kp, vp, table, lens


@pytest.mark.parametrize("L", [1, 20])
@pytest.mark.parametrize("B", [4, 1])
def test_dp_paged_attention_matches_single_pool(B, L):
    """test_sharding.py:720 on the port, both regimes (batched decode over
    each replica's stripe; the B = 1 chunk over every stripe, merged), and
    a 20-token chunk: against JAX's DPPagedAttention and the port's
    attention over the whole pool."""
    q, kp, vp, table, lens = _dp_paged_setup(B, L=L)
    t = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    got = DPPagedAttention(_scfg()).paged(*t)
    ref = paged_attention(*t)
    want = JaxDPPagedAttention(_jax_scfg(), inner="xla").paged(
        *(jnp.asarray(a) for a in (q, kp, vp, table, lens)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_dp_paged_update_is_stripe_local():
    """test_sharding.py:760 on the port: writes land in the owning
    replica's stripe; a foreign or idle position lands in that replica's
    trash page, never a live page of another replica."""
    dpa = DPPagedAttention(_scfg())
    P_pages, Hkv, ps, D, B, L = 8, 4, 4, 16, 4, 1
    kp = torch.zeros((P_pages, Hkv, ps, D))
    vp = torch.zeros_like(kp)
    k = torch.ones((B, Hkv, L, D)) * torch.arange(1, B + 1, dtype=torch.float32).reshape(B, 1, 1, 1)
    v = -k
    idx = torch.tensor([[1], [2], [5], [-1]])
    slot = torch.tensor([[0], [1], [2], [3]])
    dpa.paged_update(kp, vp, k, v, idx, slot)
    assert kp[1, 0, 0, 0] == 1.0 and kp[2, 0, 1, 0] == 2.0 and kp[5, 0, 2, 0] == 3.0
    assert kp[4, 0, 3, 0] == 4.0  # the idle row (replica 1): its own trash page 4
    assert vp[4, 0, 3, 0] == -4.0
    assert kp[0].sum() == 0  # replica 0's trash page untouched
    assert kp[3].sum() == 0 and kp[6].sum() == 0 and kp[7].sum() == 0


def test_dp_pool_spec_matches_jax():
    assert dp_paged_pool_spec(_scfg()) == tuple(jax_dp_pool_spec(_jax_scfg()))


def test_admission_never_takes_another_replicas_slot():
    """The scheduler asks the cache for a slot (choose_slot): a request
    pinned to replica 1 stalls while only replica 0's slots are free, and
    over a whole paged run every installed request sits in a slot of its
    own replica (add_request would raise otherwise: recorded here)."""
    jcfg, _, pp = _params()
    pool = PagePool(1, 16, 2, 8, 16, device="cpu", dp_shards=2)
    cache = DPPagedBatchingKVCache(pool, 4, 2)
    assert cache.choose_slot(PagedKVCache(pool, shard=1), [0, 1]) is None
    assert cache.choose_slot(PagedKVCache(pool, shard=1), [1, 3]) == 3
    with pytest.raises(ValueError, match="cannot occupy"):
        cache.add_request(PagedKVCache(pool, shard=0), 2)

    placed = []

    class Recording(DPPagedBatchingKVCache):
        def add_request(self, prefilled, slot):
            placed.append((prefilled.shard, self.slot_shard(slot)))
            super().add_request(prefilled, slot)

    dp_model = DPServing(_port_model(True), _scfg())
    dp_model.create_batching_kv_cache = lambda max_active_requests, max_seq_len=None: \
        Recording(dp_model.page_pool, max_active_requests, 2)
    out = batch_generate(dp_model, FakeTokenizer(), [f"request {i} " * (1 + i % 3)
                                                     for i in range(8)], **SERVE)
    assert len(out) == 8 and len(placed) == 8
    assert all(a == b for a, b in placed)
    assert {a for a, _ in placed} == {0, 1}
