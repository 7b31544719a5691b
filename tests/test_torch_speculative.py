"""Speculative decoding on the port (generate.speculative_generate, the
host loop over cache objects; speculative.py, the rounds over slabs):
tests/test_speculative.py's and tests/test_speculative_device.py's cases,
run on the port with the JAX package's random weights bridged across, and
the port against the JAX functions on the same weights: the same token
streams, and the same dispatch counts under forced acceptance."""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from tiny_llm_tpu import speculative as jax_spec  # noqa: E402
from tiny_llm_tpu.generate import speculative_generate as jax_speculative_generate  # noqa: E402
from tiny_llm_tpu.models import Qwen3Model as JaxQwen3Model  # noqa: E402
from tiny_llm_tpu.models import random_params  # noqa: E402
from tiny_llm_tpu.models import tiny_test_config as jax_tiny_config  # noqa: E402
from tiny_llm_tpu_torch.generate import (  # noqa: E402
    simple_generate_with_kv_cache,
    speculative_generate,
    speculative_max_speedup,
)
from tiny_llm_tpu_torch.models import Qwen3Model, from_jax_numpy, tiny_test_config  # noqa: E402
from tiny_llm_tpu_torch.speculative import (  # noqa: E402
    SpecModel,
    _greedy_last,
    _prefill,
    greedy_continuation,
    speculative_decode_device,
    speculative_rounds,
)

from .torch_port import params_to_numpy, torch_one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("torch_one_thread")
from .utils import FakeTokenizer  # noqa: E402

_PARAMS: dict = {}


def _jax_params(layers: int, key: int):
    if (layers, key) not in _PARAMS:
        _PARAMS[layers, key] = random_params(jax_tiny_config(num_hidden_layers=layers), key=key)
    return _PARAMS[layers, key]


def _port_params(layers: int, key: int):
    cfg = tiny_test_config(num_hidden_layers=layers)
    return from_jax_numpy(params_to_numpy(_jax_params(layers, key)), cfg, device="cpu"), cfg


def _model(layers: int, key: int, paged: bool = False) -> Qwen3Model:
    params, cfg = _port_params(layers, key)
    m = Qwen3Model(params, cfg, max_seq_len=128, device="cpu")
    return m.enable_paged_attention(num_pages=65, page_size=8) if paged else m


@pytest.fixture(scope="module")
def target():
    return _model(2, 0)


@pytest.fixture(scope="module")
def draft_different():
    return _model(1, 7)


# ---------------------------------------------------------------------------
# tests/test_speculative.py's cases: the host loop
# ---------------------------------------------------------------------------


def test_spec_decode_lossless_with_perfect_draft(target):
    tok = FakeTokenizer()
    expected = simple_generate_with_kv_cache(target, tok, "hello", max_tokens=8)
    got = speculative_generate(target, target, tok, tok, "hello", proposal_length=4,
                               max_tokens=8, auto_disable=False)
    assert got == expected


def test_spec_decode_lossless_with_bad_draft(target, draft_different):
    tok = FakeTokenizer()
    expected = simple_generate_with_kv_cache(target, tok, "abc xyz", max_tokens=8)
    got = speculative_generate(draft_different, target, tok, tok, "abc xyz",
                               proposal_length=3, max_tokens=8, auto_disable=False)
    assert got == expected


def test_spec_decode_stats_count_acceptance(target, draft_different):
    """`stats`: each round emits its accepted proposals plus one token, so
    rounds + accepted covers max_tokens with less than a round to spare;
    the target as its own draft has every proposal accepted."""
    tok = FakeTokenizer()
    for draft, k in ((target, 4), (draft_different, 3)):
        st = {}
        speculative_generate(draft, target, tok, tok, "abc xyz", proposal_length=k,
                             max_tokens=8, auto_disable=False, stats=st)
        assert st["rounds"] >= 1 and st["accepted"] <= st["proposed"] <= k * st["rounds"]
        assert 8 <= st["rounds"] + st["accepted"] < 8 + k + 1
        if draft is target:
            assert st["accepted"] == st["proposed"]


def test_spec_decode_proposal_zero_is_target_only(target, draft_different):
    tok = FakeTokenizer()
    expected = simple_generate_with_kv_cache(target, tok, "zq", max_tokens=6)
    got = speculative_generate(draft_different, target, tok, tok, "zq", proposal_length=0,
                               max_tokens=6, auto_disable=False)
    assert got == expected


def test_spec_decode_validates_proposal_length(target):
    tok = FakeTokenizer()
    with pytest.raises(ValueError):
        speculative_generate(target, target, tok, tok, "x", proposal_length=-1)
    with pytest.raises(ValueError):
        speculative_generate(target, target, tok, tok, "x", proposal_length=True)


def test_spec_decode_rejects_mismatched_tokenizers(target):
    class OtherTok(FakeTokenizer):
        def encode(self, s):
            return [(ord(c) + 1) % 90 for c in s]

    with pytest.raises(ValueError):
        speculative_generate(target, target, OtherTok(), FakeTokenizer(), "abc")

    class OtherEos(FakeTokenizer):
        def __init__(self):
            super().__init__(eos_token_id=5)

    with pytest.raises(ValueError):
        speculative_generate(target, target, OtherEos(), FakeTokenizer(), "abc")

    class NoVocab:
        eos_token_id = 99
        encode, decode = FakeTokenizer.encode, FakeTokenizer.decode
        vocab = 128

    with pytest.raises(ValueError, match="get_vocab"):
        speculative_generate(target, target, NoVocab(), FakeTokenizer(), "abc")


def test_speculative_max_speedup_bound():
    assert speculative_max_speedup(1.0, 1.0, 1.0, 4) < 1.0
    assert speculative_max_speedup(13.0, 2.0, 13.0, 4) > 2.0
    assert 0.5 < speculative_max_speedup(3.4, 1.3, 3.4, 4) < 2.0


def test_spec_guard_falls_back_losslessly(target, monkeypatch):
    """With every probe interval pinned to 1 s the bound is < 1: the guard
    warns, and the output is still the greedy one."""
    import time as _time

    tok = FakeTokenizer()
    expected = simple_generate_with_kv_cache(target, tok, "guarded", max_tokens=6)
    counter = iter(range(10_000))
    monkeypatch.setattr(_time, "perf_counter", lambda: float(next(counter)))
    with pytest.warns(UserWarning, match="speculative decoding disabled"):
        got = speculative_generate(target, target, tok, tok, "guarded", proposal_length=4,
                                   max_tokens=6, auto_disable=True)
    assert got == expected


def test_spec_guard_keeps_fast_draft(target, draft_different):
    tok = FakeTokenizer()
    expected = simple_generate_with_kv_cache(target, tok, "keep", max_tokens=6)
    got = speculative_generate(draft_different, target, tok, tok, "keep", proposal_length=3,
                               max_tokens=6, auto_disable=False)
    assert got == expected


def test_spec_decode_on_paged_caches():
    """Rewind over paged caches (freeing trailing pages) stays lossless and
    leaks no page."""
    paged, draft = _model(2, 0, paged=True), _model(1, 7)
    tok = FakeTokenizer()
    expected = simple_generate_with_kv_cache(paged, tok, "hello", max_tokens=8)
    got = speculative_generate(draft, paged, tok, tok, "hello", proposal_length=3,
                               max_tokens=8, auto_disable=False)
    assert got == expected
    assert paged.page_pool.live_pages == 0


@pytest.mark.parametrize("prompt,k", [("abc xyz", 3), ("hello world", 4), ("q", 2)])
def test_host_loop_matches_jax(prompt, k):
    """The port's host loop and the JAX package's on the same weights: the
    same text."""
    tok = FakeTokenizer()
    jcfg, dcfg = jax_tiny_config(num_hidden_layers=2), jax_tiny_config(num_hidden_layers=1)
    jt = JaxQwen3Model(_jax_params(2, 0), jcfg, max_seq_len=128)
    jd = JaxQwen3Model(_jax_params(1, 7), dcfg, max_seq_len=128)
    want = jax_speculative_generate(jd, jt, tok, tok, prompt, proposal_length=k, max_tokens=10,
                                    auto_disable=False)
    got = speculative_generate(_model(1, 7), _model(2, 0), tok, tok, prompt, proposal_length=k,
                               max_tokens=10, auto_disable=False)
    assert got == want


# ---------------------------------------------------------------------------
# tests/test_speculative_device.py's cases: the rounds over slabs
# ---------------------------------------------------------------------------

MAX_SEQ = 128
PROMPT = [3, 14, 15, 9, 2, 6]


def _pair():
    (tp, tcfg), (dp, dcfg) = _port_params(3, 7), _port_params(2, 11)
    return SpecModel.build(dp, dcfg, MAX_SEQ), SpecModel.build(tp, tcfg, MAX_SEQ)


def _jax_pair():
    tcfg, dcfg = jax_tiny_config(num_hidden_layers=3), jax_tiny_config(num_hidden_layers=2)
    return (jax_spec.SpecModel.build(_jax_params(2, 11), dcfg, MAX_SEQ),
            jax_spec.SpecModel.build(_jax_params(3, 7), tcfg, MAX_SEQ))


@pytest.mark.parametrize("k,rounds", [(3, 2), (4, 1), (1, 4)])
def test_device_speculative_is_lossless(k, rounds):
    draft, target = _pair()
    want = greedy_continuation(target, PROMPT, 24, MAX_SEQ)
    got = speculative_decode_device(draft, target, PROMPT, max_tokens=24, proposal_length=k,
                                    rounds_per_dispatch=rounds, max_seq=MAX_SEQ)
    assert got == want[:24]


@pytest.mark.parametrize("alpha", [0.0, 1.0, 0.6])
def test_forced_acceptance_emits_budget(alpha):
    draft, target = _pair()
    stats = {}
    got = speculative_decode_device(draft, target, PROMPT, max_tokens=20, proposal_length=4,
                                    rounds_per_dispatch=2, max_seq=MAX_SEQ, forced_alpha=alpha,
                                    stats=stats)
    assert len(got) == 20
    assert all(0 <= t < target.cfg.vocab_size for t in got)
    assert stats["dispatches"] >= 1
    if alpha == 1.0:
        assert got[0] == greedy_continuation(target, PROMPT, 20, MAX_SEQ)[0]


def test_acceptance_rate_controls_dispatch_count():
    draft, target = _pair()
    counts = {}
    for alpha in (0.0, 1.0):
        stats = {}
        speculative_decode_device(draft, target, PROMPT, max_tokens=21, proposal_length=4,
                                  rounds_per_dispatch=2, max_seq=MAX_SEQ, forced_alpha=alpha,
                                  stats=stats)
        counts[alpha] = stats["dispatches"]
    assert counts[1.0] == 2
    assert counts[0.0] == 10


def test_eos_stops_emission():
    draft, target = _pair()
    want = greedy_continuation(target, PROMPT, 24, MAX_SEQ)
    eos = want[10]
    got = speculative_decode_device(draft, target, PROMPT, max_tokens=24, proposal_length=3,
                                    rounds_per_dispatch=2, max_seq=MAX_SEQ,
                                    eos_ids=frozenset({eos}))
    assert got == want[: want.index(eos)]


def test_greedy_continuation_matches_jax():
    jd, jt = _jax_pair()
    _, target = _pair()
    assert greedy_continuation(target, PROMPT, 24, MAX_SEQ) == jax_spec.greedy_continuation(
        jt, PROMPT, 24, MAX_SEQ)


@pytest.mark.parametrize("alpha,k,rounds", [(None, 3, 2), (0.0, 4, 2), (1.0, 4, 2),
                                            (0.6, 4, 2), (0.6, 2, 3)])
def test_rounds_match_jax(alpha, k, rounds):
    """The port's rounds and the JAX package's on the same weights: the same
    stream (under forced acceptance the verifier's own predictions), the
    same dispatch and emitted counts. The port's draft catches up after a
    full accept where JAX's leaves the slot stale; these tiny models'
    proposals do not move with that slot."""
    jd, jt = _jax_pair()
    draft, target = _pair()
    kw = dict(max_tokens=20, proposal_length=k, rounds_per_dispatch=rounds, max_seq=MAX_SEQ,
              forced_alpha=alpha, forced_seed=3)
    sj, sp = {}, {}
    want = jax_spec.speculative_decode_device(jd, jt, PROMPT, stats=sj, **kw)
    got = speculative_decode_device(draft, target, PROMPT, stats=sp, **kw)
    assert got == want
    assert {k: sp[k] for k in sj} == sj


def test_full_accept_catches_up_the_draft_slab():
    """After a full accept the draft's slab holds its last proposal, as the
    target's slab does from the verify forward: the target as its own
    draft, one round, both slabs equal over the whole context."""
    _, target = _pair()
    K, P = 4, len(PROMPT)
    dk, dv = target.empty_slabs(MAX_SEQ)
    tk, tv = target.empty_slabs(MAX_SEQ)
    last = _greedy_last(_prefill(target, PROMPT, tk, tv))
    _prefill(target, PROMPT, dk, dv)
    _, n_emits, _, off = speculative_rounds(target, target, last, P, dk, dv, tk, tv,
                                            proposal_length=K, rounds=1)
    assert n_emits == [K + 1] and off == P + K + 1
    assert bool(dk[..., P + K, :].abs().sum() > 0)
    for d, t in ((dk, tk), (dv, tv)):
        torch.testing.assert_close(d[..., :off, :].float(), t[..., :off, :].float(),
                                   rtol=2e-2, atol=2e-2)
    stats = {}
    speculative_decode_device(target, target, PROMPT, max_tokens=20, proposal_length=K,
                              rounds_per_dispatch=2, max_seq=MAX_SEQ, stats=stats)
    assert stats["catch_ups"] == 2 * stats["dispatches"]
