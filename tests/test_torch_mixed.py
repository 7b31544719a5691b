"""The port's mixed prefill+decode bursts (Qwen3Model.mixed_burst and the
mixed schedule of batch_generate, on the CPU) against the JAX package's:
the same tiny params, decode slots and prefill schedules give the same
decode and completion tokens, the mixed burst equals the serialized
schedule inside the port, and batch_generate(mixed_prefill=True) gives the
same (prompt_idx, text) lists in both packages, dense and MoE."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu.models.qwen3 import MixedStep as JaxMixedStep  # noqa: E402
from tiny_llm_tpu.serving import batch_generate as jax_batch_generate  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Model, from_jax_numpy, tiny_test_config  # noqa: E402
from tiny_llm_tpu_torch.models.qwen3 import MixedStep  # noqa: E402
from tiny_llm_tpu_torch.serving import batch_generate  # noqa: E402

from .test_torch_moe import moe_params_to_numpy  # noqa: E402
from .utils import FakeTokenizer  # noqa: E402

CONFIGS = {
    "dense": dict(num_hidden_layers=2),
    # layer 0 dense, layer 1 sparse (tests/test_torch_moe.py's tiny MoE)
    "moe": dict(num_hidden_layers=2, num_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=128, norm_topk_prob=True, mlp_only_layers=(0,)),
}


def _pair(name="dense", key=11, num_pages=64, page_size=8):
    """The JAX and the port paged model on the same weights."""
    over = CONFIGS[name]
    jcfg, pcfg = jax_tiny_config(**over), tiny_test_config(**over)
    params = random_params(jcfg, key=key)
    jm = JaxQwen3Model(params, jcfg, max_seq_len=128)
    pm = Qwen3Model(from_jax_numpy(moe_params_to_numpy(params), pcfg, device="cpu"), pcfg,
                    max_seq_len=128, device="cpu")
    jm.enable_paged_attention(num_pages=num_pages, page_size=page_size)
    pm.enable_paged_attention(num_pages=num_pages, page_size=page_size)
    return jm, pm


def _chunk_schedule(step_cls, cache, tokens, chunk, steps, start_step=0, sched=None):
    """Schedule `tokens` as consecutive `chunk`-sized sub-chunks from burst
    step `start_step` (the last may be short), as
    tests/test_mixed_prefill.py does. Returns (schedule, completing step)."""
    sched = [None] * steps if sched is None else sched
    off, t = 0, start_step
    while off < len(tokens):
        r = min(chunk, len(tokens) - off)
        sched[t] = step_cls(cache=cache, tokens=tokens[off : off + r], offset=off)
        off += r
        t += 1
    return sched, t - 1


def _install(m, prompts, tokens_of):
    """A batching cache with each prompt prefilled into its own slot;
    returns (batch, first tokens)."""
    batch = m.create_batching_kv_cache(max_active_requests=len(prompts))
    first = []
    for slot, p in enumerate(prompts):
        c = m.create_kv_cache()
        first.append(tokens_of(m(jnp.asarray([p], jnp.int32) if isinstance(m, JaxQwen3Model)
                                 else [p], 0, c, logits_to_keep=1)))
        batch.add_request(c, slot)
    return batch, np.asarray(first, np.int32)


def _argmax(logits) -> int:
    return int(np.asarray(logits if not hasattr(logits, "detach") else logits.float(),
                          np.float32)[0, -1].argmax())


SLOTS = ([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [9, 8, 7, 6, 5, 4, 3, 2])
PROMPT_A = [1, 2, 3, 4, 5, 6]  # ends mid-chunk: 4 + 2
PROMPT_B = [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5, 9, 0, 4, 5]  # four full sub-chunks


@pytest.mark.parametrize("layout", ["one_prompt", "two_prompts_idle_step"])
def test_mixed_burst_matches_jax(layout):
    """Two installed decode slots and a 6-step burst of 4-token sub-chunks:
    one 16-token prompt over steps 0-3, or a 6-token prompt (ending
    mid-chunk) then, after an idle step, an 8-token one. The decode tokens
    of every step and the completion tokens are the JAX package's; each
    scheduled cache advances by its real token count."""
    jm, pm = _pair()
    steps, c = 6, 4
    prompts = [PROMPT_B] if layout == "one_prompt" else [PROMPT_A, PROMPT_B[:8]]
    starts = [0] if layout == "one_prompt" else [0, 3]
    out = {}
    for m, step_cls in ((jm, JaxMixedStep), (pm, MixedStep)):
        batch, first = _install(m, SLOTS, _argmax)
        caches = [m.create_kv_cache() for _ in prompts]
        sched, lasts = [None] * steps, []
        for cache, p, t0 in zip(caches, prompts, starts):
            sched, last = _chunk_schedule(step_cls, cache, p, c, steps, t0, sched)
            lasts.append(last)
        toks, comp = m.mixed_burst(batch, first, steps, sched, c)
        assert [cc.offset for cc in caches] == [len(p) for p in prompts]
        out[m is pm] = (np.asarray(toks), [int(comp[t]) for t in lasts])
    np.testing.assert_array_equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]


def test_mixed_burst_equals_serialized_in_port():
    """Inside the port: one mixed burst gives the decode slots the tokens of
    a plain decode burst, and the scheduled prompt the greedy token of its
    chunked prefill run separately; its pages then decode the same
    continuation."""
    _, pm = _pair(key=3)
    steps, c = 4, 4

    def run(mixed: bool):
        batch, first = _install(pm, SLOTS[:1], _argmax)
        batch2 = pm.create_batching_kv_cache(max_active_requests=2)
        batch2.add_request(batch.slots[0], 0)
        first = np.asarray([first[0], 0], np.int32)
        cache = pm.create_kv_cache()
        if mixed:
            sched, last = _chunk_schedule(MixedStep, cache, PROMPT_B, c, steps)
            toks, comp = pm.mixed_burst(batch2, first, steps, sched, c)
            nxt = int(comp[last])
        else:
            toks = pm.decode_burst(batch2, first, steps)
            for off in range(0, len(PROMPT_B), 8):
                lg = pm([PROMPT_B[off : off + 8]], off, cache, logits_to_keep=1)
            nxt = _argmax(lg)
        cont, off = [nxt], len(PROMPT_B)
        for _ in range(3):
            cont.append(_argmax(pm([[cont[-1]]], off, cache)))
            off += 1
        batch2.release()
        cache.release()
        return np.asarray(toks)[:, 0].tolist(), cont

    assert run(mixed=True) == run(mixed=False)
    assert pm.page_pool.live_pages == 0


PROMPTS = [
    "the quick brown fox jumps over the lazy dog again and again!",
    "pack my box with five dozen liquor jugs or more, said nobody",
    "sphinx of black quartz judge my vow while the band plays on..",
    "a very long prompt that keeps going and going for the mixer!!",
    "how vexingly quick daft zebras jump when the serving mixes up",
]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_mixed_batch_generate_matches_jax_and_classic(name):
    """batch_generate(mixed_prefill=True) over 2 slots, bursts of 2 and
    4-token sub-chunks (tests/test_mixed_prefill.py's campaign): the same
    (prompt_idx, text) list as the JAX package's mixed run and as the
    port's classic run; the mixed path engaged and nothing leaked."""
    jm, pm = _pair(name, key=5)
    tok = FakeTokenizer()
    kw = dict(max_seq_len=96, batch_size=2, prefill_step=8, max_output_tokens=6,
              decode_burst=2)
    calls = []
    orig = pm.mixed_burst
    pm.mixed_burst = lambda *a, **k: calls.append(a[3]) or orig(*a, **k)
    got = batch_generate(pm, tok, PROMPTS, mixed_prefill=True, mixed_chunk=4, **kw)
    assert calls and all(0 < sum(len(e.tokens) for e in s if e) <= 8 for s in calls)
    assert got == jax_batch_generate(jm, tok, PROMPTS, mixed_prefill=True, mixed_chunk=4, **kw)
    assert dict(got) == dict(batch_generate(pm, tok, PROMPTS, **kw))
    assert pm.page_pool.live_pages == 0


def test_mixed_sampled_serving_is_reproducible():
    """temp > 0: two mixed runs with one seed agree, and top-k 1 gives the
    greedy mixed run's texts (decode rows from the burst's generator,
    completions from each request's own)."""
    _, pm = _pair(key=13)
    tok = FakeTokenizer()
    kw = dict(max_seq_len=96, batch_size=2, prefill_step=8, max_output_tokens=5,
              decode_burst=2, mixed_prefill=True, mixed_chunk=4)
    a = batch_generate(pm, tok, PROMPTS[:3], temp=0.8, top_k=8, seed=7, **kw)
    assert a == batch_generate(pm, tok, PROMPTS[:3], temp=0.8, top_k=8, seed=7, **kw)
    greedy = batch_generate(pm, tok, PROMPTS[:3], **kw)
    assert batch_generate(pm, tok, PROMPTS[:3], temp=0.8, top_k=1, seed=1, **kw) == greedy
    assert pm.page_pool.live_pages == 0


def test_mixed_needs_a_pool_and_a_dividing_chunk():
    """Without a pool supports_mixed is False and mixed_prefill keeps the
    classic schedule; mixed_burst refuses a chunk that does not divide the
    page size."""
    cfg = tiny_test_config(num_hidden_layers=1)
    from tiny_llm_tpu_torch.models import synthetic_quantized_params

    params = synthetic_quantized_params(cfg, device="cpu")
    dense = Qwen3Model(params, cfg, max_seq_len=64, device="cpu")
    assert dense.supports_mixed is False
    tok = FakeTokenizer()
    kw = dict(max_seq_len=64, batch_size=2, prefill_step=8, max_output_tokens=3)
    assert batch_generate(dense, tok, PROMPTS[:2], mixed_prefill=True, mixed_chunk=4, **kw) \
        == batch_generate(dense, tok, PROMPTS[:2], **kw)
    paged = Qwen3Model(params, cfg, max_seq_len=64, device="cpu").enable_paged_attention(
        num_pages=8, page_size=8)
    assert paged.supports_mixed is True
    batch = paged.create_batching_kv_cache(1)
    with pytest.raises(ValueError, match="divide"):
        paged.mixed_burst(batch, [0], 1, [None], 3)
