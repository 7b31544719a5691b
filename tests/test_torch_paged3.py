"""The port's three-launch paged decode (Qwen3Model(paged_fused_one=False),
on the CPU) against the JAX package: the prep kernel's plain version
against the Pallas `fused_qkv_prep` in interpret mode, and a 2-layer paged
model with the option off against JAX's paged model. On the CPU the JAX
paged model never runs its fused or three-launch route (its kernels resolve
to "xla"): it computes the unfused chain, whose values the prep reproduces.
Also: the option read once from TLT_PAGED_FUSED_ONE at construction, the
route's calls per step, and mixed bursts and batch_generate giving the
fused route's tokens."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tiny_llm_tpu.kernels.fused_decode_attention import (  # noqa: E402
    fused_qkv_prep as jax_fused_qkv_prep,
)
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu.ops.rope import rope_tables as jax_rope_tables  # noqa: E402
from tiny_llm_tpu_torch.kernels.fused_decode_attention import fused_qkv_prep  # noqa: E402
from tiny_llm_tpu_torch.models import Qwen3Model, from_jax_numpy, tiny_test_config  # noqa: E402
from tiny_llm_tpu_torch.models import qwen3 as port_qwen3  # noqa: E402
from tiny_llm_tpu_torch.models.qwen3 import MixedStep  # noqa: E402
from tiny_llm_tpu_torch.serving import batch_generate  # noqa: E402

from .torch_port import bf16_numpy, f32, params_to_numpy  # noqa: E402
from .utils import FakeTokenizer  # noqa: E402

LOGIT_ATOL = 3e-2  # bf16 ladder, absolute, as tests/test_torch_paged.py


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
def test_qkv_prep_plain_matches_pallas(n_rep, D):
    """B = 3 rows at offsets 0, 5 and 61 (distinct RoPE rows), Hkv 2,
    non-unit norm weights: q and the k row within one bf16 ulp (the JAX
    kernel and the plain version norm in f32 and round at the same points;
    a last-bit difference in rsqrt may move one rounding), v bit for bit."""
    rng = np.random.default_rng(n_rep * 1000 + D)
    B, Hkv, eps = 3, 2, 1e-6
    qkv_j, qkv_t = bf16_numpy(rng.standard_normal((B, Hkv, n_rep + 2, D)) * 3.0)
    qw_j, qw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    kw_j, kw_t = bf16_numpy(rng.standard_normal(D) * 0.1 + 1.0)
    cos, sin = (np.asarray(t) for t in jax_rope_tables(D, 64))
    off = np.asarray([0, 5, 61], np.int32)
    want = jax_fused_qkv_prep(qkv_j, jnp.asarray(off), jnp.asarray(cos[off]),
                              jnp.asarray(sin[off]), qw_j, kw_j, eps=eps, interpret=True)
    got = fused_qkv_prep(qkv_t, torch.from_numpy(off), torch.from_numpy(cos[off]),
                         torch.from_numpy(sin[off]), qw_t, kw_t, eps=eps)
    assert [tuple(t.shape) for t in got] == [(B, Hkv, n_rep, D), (B, Hkv, 1, D), (B, Hkv, 1, D)]
    assert all(t.dtype == torch.bfloat16 for t in got)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(f32(g), f32(w), rtol=2**-7, atol=2**-7)
    np.testing.assert_array_equal(f32(got[2]), f32(want[2]))


@pytest.fixture(scope="module")
def three_launch():
    """JAX's paged model and the port's with paged_fused_one False and True,
    on the same 2-layer weights."""
    cfg_kw = dict(num_hidden_layers=2)
    jcfg, pcfg = jax_tiny_config(**cfg_kw), tiny_test_config(**cfg_kw)
    params = random_params(jcfg, key=3)
    jm = JaxQwen3Model(params, jcfg, max_seq_len=128).enable_paged_attention(
        num_pages=40, page_size=8)
    port_params = from_jax_numpy(params_to_numpy(params), pcfg, device="cpu")
    off, on = (Qwen3Model(port_params, pcfg, max_seq_len=128, device="cpu",
                          paged_fused_one=fused).enable_paged_attention(num_pages=40, page_size=8)
               for fused in (False, True))
    return jm, off, on


def _assert_logits(got, want):
    got, want = f32(got), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > 2 * LOGIT_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


def test_three_launch_model_matches_jax(three_launch):
    """Chunks of 20 and 12, then 5 teacher-forced decode steps (the JAX
    model's tokens), then a 6-step burst over a batching cache beside an
    idle slot: logits within the ladder, the installed slot's burst tokens
    equal (idle slots give garbage that differs between routes)."""
    jm, pm, _ = three_launch
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(0, 128, size=32)]
    cj, cp = jm.create_kv_cache(), pm.create_kv_cache()
    off = 0
    for L in (20, 12):
        chunk = [prompt[off : off + L]]
        _assert_logits(pm(chunk, off, cp), jm(jnp.asarray(chunk, jnp.int32), off, cj))
        off += L
    tok = int(prompt[-1])
    for _ in range(5):
        want = jm(jnp.asarray([[tok]], jnp.int32), off, cj)
        _assert_logits(pm([[tok]], off, cp), want)
        tok = int(np.asarray(want, np.float32)[0, -1].argmax())
        off += 1
    bj, bp = jm.create_batching_kv_cache(max_active_requests=2), pm.create_batching_kv_cache(2)
    bj.add_request(cj, 1)
    bp.add_request(cp, 1)
    want = jm.decode_burst(bj, np.asarray([0, tok], np.int32), 6)
    got = pm.decode_burst(bp, np.asarray([0, tok], np.int32), 6)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    bj.release()
    bp.release()
    assert pm.page_pool.live_pages == 0


def test_three_launch_calls_per_decode_step(three_launch, monkeypatch):
    """A paged decode step with the option off calls, per layer, the prep
    and paged attention (L = 1: the paged decode kernel on the card) and
    never the fused paged step; with it on, the reverse."""
    _, off, on = three_launch
    calls = []
    for name in ("fused_qkv_prep", "paged_attention", "fused_paged_decode_attention"):
        fn = getattr(port_qwen3, name)
        monkeypatch.setattr(port_qwen3, name,
                            lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    for m, want in ((off, ["fused_qkv_prep", "paged_attention"] * 2),
                    (on, ["fused_paged_decode_attention"] * 2)):
        c = m.create_kv_cache()
        m([[1, 2, 3]], 0, c)
        calls.clear()
        m([[4]], 3, c)
        assert calls == want
        c.release()


def test_option_read_once_at_construction(monkeypatch):
    """None reads TLT_PAGED_FUSED_ONE when the model is built ("1" unless
    set), never at step time; an explicit value wins."""
    cfg = tiny_test_config(num_hidden_layers=1)
    from tiny_llm_tpu_torch.models import synthetic_quantized_params

    params = synthetic_quantized_params(cfg, device="cpu")

    def build(**kw):
        return Qwen3Model(params, cfg, max_seq_len=32, device="cpu", **kw)

    monkeypatch.delenv("TLT_PAGED_FUSED_ONE", raising=False)
    assert build().paged_fused_one is True
    monkeypatch.setenv("TLT_PAGED_FUSED_ONE", "0")
    m = build()
    assert m.paged_fused_one is False
    assert build(paged_fused_one=True).paged_fused_one is True
    monkeypatch.setenv("TLT_PAGED_FUSED_ONE", "1")
    assert m.paged_fused_one is False  # read at construction only
    assert build().paged_fused_one is True
    monkeypatch.setenv("TLT_PAGED_FUSED_ONE", "0")
    assert build(paged_fused_one=False).enable_paged_attention(8, 8).paged_fused_one is False


def test_mixed_burst_three_launch_gives_fused_tokens(three_launch):
    """Two installed slots and a 6-step mixed burst prefilling a 16-token
    prompt in 4-token sub-chunks: the decode rows' unfused route gives the
    fused route's decode and completion tokens."""
    _, off, on = three_launch
    out = []
    for m in (off, on):
        batch = m.create_batching_kv_cache(max_active_requests=2)
        first = []
        for slot, p in enumerate(([3, 1, 4, 1, 5, 9, 2, 6], [9, 8, 7, 6, 5])):
            c = m.create_kv_cache()
            first.append(int(f32(m([p], 0, c, logits_to_keep=1))[0, -1].argmax()))
            batch.add_request(c, slot)
        c = m.create_kv_cache()
        prompt = list(range(2, 18))
        sched = [MixedStep(cache=c, tokens=prompt[4 * t : 4 * t + 4], offset=4 * t)
                 for t in range(4)] + [None, None]
        toks, comp = m.mixed_burst(batch, np.asarray(first, np.int32), 6, sched, 4)
        out.append((np.asarray(toks), int(comp[3])))
        c.release()
        batch.release()
        assert m.page_pool.live_pages == 0
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]


@pytest.mark.parametrize("mixed", [False, True], ids=["classic", "mixed"])
def test_batch_generate_three_launch_gives_fused_texts(three_launch, mixed):
    """batch_generate over 2 slots, bursts of 3 (classic, and the mixed
    schedule with 4-token sub-chunks): the option off gives the fused
    route's (prompt_idx, text) list."""
    _, off, on = three_launch
    tok = FakeTokenizer()
    prompts = ["the quick brown fox", "jumps over", "the lazy dog again and again", "ok"]
    kw = dict(max_seq_len=96, batch_size=2, prefill_step=8, max_output_tokens=6,
              decode_burst=3)
    if mixed:
        kw.update(mixed_prefill=True, mixed_chunk=4)
    got = batch_generate(off, tok, prompts, **kw)
    assert sorted(i for i, _ in got) == list(range(len(prompts)))
    assert got == batch_generate(on, tok, prompts, **kw)
    assert off.page_pool.live_pages == 0
