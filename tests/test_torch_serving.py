"""The port's continuous-batching scheduler (tiny_llm_tpu_torch.serving, on
the CPU) against the JAX package's batch_generate: the same tiny params,
prompts and settings give the same (prompt_idx, text) list under greedy
decoding and the same deterministic metrics."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu.serving import ServingMetrics as JaxMetrics  # noqa: E402
from tiny_llm_tpu.serving import batch_generate as jax_batch_generate  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Model, from_jax_numpy, tiny_test_config  # noqa: E402
from tiny_llm_tpu_torch.serving import ServingMetrics, batch_generate  # noqa: E402

from .torch_port import params_to_numpy  # noqa: E402
from .utils import FakeTokenizer  # noqa: E402

# ServingMetrics fields that depend on the schedule only, not on the clock.
DETERMINISTIC = (
    "requests_completed", "prefill_tokens", "output_tokens", "decode_steps",
    "batched_decode_slots", "peak_active_requests", "peak_live_pages",
    "pool_capacity_pages", "page_size", "reused_page_allocations", "mean_batch_occupancy",
)


@pytest.fixture(scope="module")
def params():
    return random_params(jax_tiny_config(num_hidden_layers=2), key=4)


def _models(params, num_pages=None, page_size=8, max_seq_len=64):
    """The JAX and the port model on the same weights; paged when num_pages."""
    jcfg, pcfg = jax_tiny_config(num_hidden_layers=2), tiny_test_config(num_hidden_layers=2)
    jm = JaxQwen3Model(params, jcfg, max_seq_len=max_seq_len)
    pm = Qwen3Model(from_jax_numpy(params_to_numpy(params), pcfg, device="cpu"), pcfg,
                    max_seq_len=max_seq_len, device="cpu")
    if num_pages:
        jm.enable_paged_attention(num_pages=num_pages, page_size=page_size)
        pm.enable_paged_attention(num_pages=num_pages, page_size=page_size)
    return jm, pm


# One dense and one paged pair for the campaigns that run both packages, so
# the JAX steps compile once per module. The paged pool holds 5 usable pages
# of 8 tokens (~1.5 requests): admission backs off whenever it fills.
@pytest.fixture(scope="module")
def dense_pair(params):
    return _models(params)


@pytest.fixture(scope="module")
def paged_pair(params):
    return _models(params, num_pages=6)


def _serve_both(jm, pm, prompts, **kw):
    jmet, pmet = JaxMetrics(), ServingMetrics()
    if jm.page_pool is not None:
        for m in (jmet, pmet):
            m.pool_capacity_pages, m.page_size = jm.page_pool.num_pages, jm.page_pool.page_size
    tok = FakeTokenizer()
    want = jax_batch_generate(jm, tok, prompts, metrics=jmet, **kw)
    got = batch_generate(pm, tok, prompts, metrics=pmet, **kw)
    assert got == want
    jd, pd = jmet.as_dict(), pmet.as_dict()
    assert {k: pd.get(k) for k in DETERMINISTIC} == {k: jd.get(k) for k in DETERMINISTIC}
    return got, pmet


@pytest.mark.parametrize("pair", ["dense_pair", "paged_pair"])
def test_more_prompts_than_slots_match_jax(pair, request):
    """7 prompts over 2 slots: paged decode in bursts of 4, dense in single
    steps; every prompt returns once and the pool is empty again."""
    jm, pm = request.getfixturevalue(pair)
    prompts = [f"prompt {i} {'ab' * i}" for i in range(7)]
    got, met = _serve_both(jm, pm, prompts, max_seq_len=48, batch_size=2, prefill_step=8,
                           max_output_tokens=5, decode_burst=4)
    assert sorted(i for i, _ in got) == list(range(7))
    assert met.peak_active_requests <= 2
    if pm.page_pool is not None:
        assert pm.page_pool.live_pages == 0


def test_pool_backpressure_matches_jax(paged_pair):
    """4 prompts of 3-4 pages each over the 5-page pool: admission waits
    for retirements, nothing leaks."""
    jm, pm = paged_pair
    prompts = [
        "hello world this is request A",
        "abc def ghi jkl mno pqr stu",
        "xyz uvw rst opq lmn ijk fgh",
        "one two three four five six!",
    ]
    got, met = _serve_both(jm, pm, prompts, max_seq_len=48, batch_size=2, prefill_step=8,
                           max_output_tokens=4)
    assert len(got) == 4 and met.peak_active_requests == 1
    assert pm.page_pool.live_pages == 0


@pytest.mark.parametrize("pair", ["dense_pair", "paged_pair"])
def test_eviction_at_max_seq_matches_jax(pair, request):
    """A 5-token prompt with max_seq_len 10: evicted once its offset reaches
    10, mid-burst on the paged path."""
    jm, pm = request.getfixturevalue(pair)
    got, _ = _serve_both(jm, pm, ["hello"], max_seq_len=10, batch_size=1, prefill_step=8)
    assert len(got[0][1]) == 6


def test_open_loop_arrivals_and_unported_options_raise(params):
    _, pm = _models(params, num_pages=16)
    tok = FakeTokenizer()
    with pytest.raises(ValueError, match="match prompts"):
        batch_generate(pm, tok, ["a", "b"], arrival_times=[0.0])
    with pytest.raises(ValueError, match="non-decreasing"):
        batch_generate(pm, tok, ["a", "b"], arrival_times=[1.0, 0.5])
    # Arrivals in the past admit at once: the same texts as offline.
    offline = batch_generate(pm, tok, ["hello world", "abc"], max_seq_len=48, batch_size=2,
                             prefill_step=8, max_output_tokens=3)
    open_loop = batch_generate(pm, tok, ["hello world", "abc"], max_seq_len=48, batch_size=2,
                               prefill_step=8, max_output_tokens=3, arrival_times=[0.0, 0.0])
    assert open_loop == offline
    # Mixed prefill+decode bursts (once unported, they raised) give the
    # classic run's texts on the same prompts.
    mixed = batch_generate(pm, tok, ["hello world", "abc"], max_seq_len=48, batch_size=2,
                           prefill_step=8, max_output_tokens=3, mixed_prefill=True,
                           mixed_chunk=4)
    assert dict(mixed) == dict(offline)


def test_pool_too_small_for_any_prompt_raises(params):
    _, pm = _models(params, num_pages=2)  # 1 usable page = 8 tokens
    with pytest.raises(RuntimeError, match="size the pool"):
        batch_generate(pm, FakeTokenizer(), ["this prompt needs more than one page for sure"],
                       max_seq_len=48, batch_size=2, prefill_step=8, max_output_tokens=4)
    assert pm.page_pool.live_pages == 0


def test_sampled_serving_is_reproducible(params):
    """temp > 0: the same seed gives the same texts; top-k 1 gives greedy's."""
    _, pm = _models(params, num_pages=24)
    tok = FakeTokenizer()
    kw = dict(max_seq_len=48, batch_size=2, prefill_step=8, max_output_tokens=5,
              decode_burst=4)
    prompts = ["sample me", "and me too", "x"]
    a = batch_generate(pm, tok, prompts, temp=0.8, seed=3, **kw)
    assert a == batch_generate(pm, tok, prompts, temp=0.8, seed=3, **kw)
    greedy = batch_generate(pm, tok, prompts, **kw)
    assert batch_generate(pm, tok, prompts, temp=0.8, top_k=1, seed=5, **kw) == greedy
    assert np.all([len(t) > 0 for _, t in a])
