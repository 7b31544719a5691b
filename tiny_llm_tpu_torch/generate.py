"""Generation loops — counterpart of tiny_llm_tpu/generate.py: simple,
KV-cached and speculative. The tokenizer contract is encode / decode /
eos_token_id[s] (speculative decoding also needs get_vocab). The host syncs
once per emitted token, at the `int()` of the chosen id (once per forward
in the speculative loop). Sampling draws from an explicit torch.Generator
seeded with `seed`."""

from __future__ import annotations

import time
import warnings
from typing import Callable, Iterable

import torch

from .tokenizer import StreamingDetokenizer


class _Stream:
    """Binds a StreamingDetokenizer to the cumulative on_token contract."""

    def __init__(self, tokenizer, on_token):
        self._detok = StreamingDetokenizer(tokenizer)
        self._on_token = on_token
        self._last_sent: str | None = None

    def feed(self, token_ids) -> None:
        changed = False
        for tid in token_ids:
            if self._detok.add_token(tid):
                changed = True
        if changed and self._on_token is not None:
            self._last_sent = self._detok.text
            self._on_token(self._last_sent)

    def close(self, final_text: str) -> None:
        self._detok.finalize()
        if self._on_token is not None and final_text != self._last_sent:
            self._on_token(final_text)


def _eos_ids(tokenizer) -> set[int]:
    eos = getattr(tokenizer, "eos_token_ids", None)
    if eos is None:
        eos = {tokenizer.eos_token_id}
    return {int(t) for t in eos}


def _logprobs(logits: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


def _next_token(logits, sampler, generator) -> int:
    lp = _logprobs(logits[:, -1, :])
    tok = torch.argmax(lp, dim=-1) if sampler is None else sampler(lp, generator)
    return int(tok[0])


def _generator(model, seed: int) -> torch.Generator:
    return torch.Generator(device=model.device).manual_seed(seed)


def simple_generate(
    model,
    tokenizer,
    prompt: str,
    sampler: Callable | None = None,
    max_tokens: int = 512,
    on_token: Callable[[str], None] | None = None,
    seed: int = 0,
) -> str:
    """No cache: the whole prefix runs again for every token."""
    tokens = list(tokenizer.encode(prompt))
    eos = _eos_ids(tokenizer)
    gen = _generator(model, seed)
    out_ids: list[int] = []
    stream = _Stream(tokenizer, on_token)
    for _ in range(max_tokens):
        tok = _next_token(model([tokens], logits_to_keep=1), sampler, gen)
        if tok in eos:
            break
        tokens.append(tok)
        out_ids.append(tok)
        stream.feed([tok])
    text = tokenizer.decode(out_ids)
    stream.close(text)
    return text


def simple_generate_with_kv_cache(
    model,
    tokenizer,
    prompt: str,
    sampler: Callable | None = None,
    max_tokens: int = 512,
    on_token: Callable[[str], None] | None = None,
    seed: int = 0,
) -> str:
    """Prefill once, then single-token decode steps over the dense cache."""
    kv_cache = model.create_kv_cache()
    eos = _eos_ids(tokenizer)
    gen = _generator(model, seed)
    out_ids: list[int] = []
    stream = _Stream(tokenizer, on_token)
    try:
        tokens = [tokenizer.encode(prompt)]
        offset = 0
        while len(out_ids) < max_tokens:
            tok = _next_token(model(tokens, offset, kv_cache, logits_to_keep=1), sampler, gen)
            if tok in eos:
                break
            out_ids.append(tok)
            stream.feed([tok])
            offset += len(tokens[0])
            tokens = [[tok]]
        text = tokenizer.decode(out_ids)
        stream.close(text)
        return text
    finally:
        kv_cache.release()


def speculative_max_speedup(
    t_target: float, t_draft: float, t_verify: float, proposal_length: int
) -> float:
    """Upper bound on the speculative speedup, reached at perfect acceptance:
    one fully accepted round emits K + 1 tokens for K proposal steps, one
    draft catch-up step and one verify forward, where plain greedy decode
    takes K + 1 target steps. Below 1, speculation cannot win at any
    acceptance rate."""
    k = proposal_length
    return ((k + 1) * t_target) / ((k + 1) * t_draft + t_verify)


def _greedy_ids(m, ids: list[int], offset: int, cache, n_keep: int = 1) -> list[int]:
    logits = m([ids], offset, cache, logits_to_keep=n_keep)
    return torch.argmax(logits[0].to(torch.float32), dim=-1).tolist()


def _time_step(m, cache, token_id: int, off: int) -> float:
    """Best of two timed single-token steps at `off` after a warm-up, each
    rewound so the cache the main loop sees is untouched."""
    _greedy_ids(m, [token_id], off, cache)
    cache.rewind(1)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        _greedy_ids(m, [token_id], off, cache)
        best = min(best, time.perf_counter() - t0)
        cache.rewind(1)
    return best


def speculative_generate(
    draft_model,
    model,
    draft_tokenizer,
    tokenizer,
    prompt: str,
    proposal_length: int = 4,
    max_tokens: int = 512,
    on_token: Callable[[str], None] | None = None,
    auto_disable: bool = True,
    stats: dict | None = None,
) -> str:
    """Draft/target speculative decoding with cache rewind (the JAX
    package's host loop): the same tokenizer gates, greedy draft proposals,
    one target verify forward with logits_to_keep = K + 1, longest-prefix
    acceptance, both caches rewound past a rejection, the bonus token and a
    draft catch-up step on full acceptance. Lossless: the text is the
    target's own greedy continuation.

    With `auto_disable`, warm decode steps of both models are timed after
    the prefill; if even perfect acceptance could not beat plain greedy
    decode (`speculative_max_speedup` < 1), the guard warns and the
    target decodes alone. The probe steps are rewound, so the guard never
    changes the output.

    `stats`, where given, gets "rounds" (verify forwards), "proposed"
    (draft tokens verified) and "accepted" (those the target's greedy
    predictions agreed with, the leading run of each round)."""
    bad_type = not isinstance(proposal_length, int) or isinstance(proposal_length, bool)
    if bad_type or proposal_length < 0:
        raise ValueError("proposal_length must be a non-negative integer")
    target_prompt = [int(t) for t in tokenizer.encode(prompt)]
    draft_prompt = [int(t) for t in draft_tokenizer.encode(prompt)]
    if not target_prompt:
        raise ValueError("prompt produced no tokens under the target tokenizer")
    if target_prompt != draft_prompt:
        raise ValueError(
            "speculative decoding needs identical prompt ids from both "
            "tokenizers, but the draft tokenizer produced a different encoding"
        )
    if _eos_ids(tokenizer) != _eos_ids(draft_tokenizer):
        raise ValueError("EOS token ids differ between the draft and target tokenizers")
    tgv = getattr(tokenizer, "get_vocab", None)
    dgv = getattr(draft_tokenizer, "get_vocab", None)
    if not callable(tgv) or not callable(dgv):
        raise ValueError(
            "both tokenizers must implement get_vocab() so their id spaces "
            "can be verified to match"
        )
    if tgv() != dgv():
        raise ValueError("the draft and target vocabularies assign different ids")

    target_eos = _eos_ids(tokenizer)
    draft_eos = _eos_ids(draft_tokenizer)
    emitted: list[int] = []
    counts = stats if stats is not None else {}
    counts.update(rounds=0, proposed=0, accepted=0)
    stream = _Stream(tokenizer, on_token)
    kv_cache = model.create_kv_cache()
    draft_kv_cache = None

    def _emit(ids: Iterable[int]) -> None:
        ids = list(ids)
        room = max_tokens - len(emitted)  # tokens past the cap are truncated
        emitted.extend(ids)
        if room > 0:
            stream.feed(ids[:room])

    def _finish() -> str:
        del emitted[max_tokens:]  # acceptance can overshoot by < one proposal
        text = tokenizer.decode(emitted)
        stream.close(text)
        return text

    def _target_only(token_id: int, offset: int) -> str:
        for _ in range(max_tokens - len(emitted)):
            if token_id in target_eos:
                return _finish()
            _emit([token_id])
            token_id = _greedy_ids(model, [token_id], offset, kv_cache)[0]
            offset += 1
        return _finish()

    def _draft_generate(last_id: int, off: int, n: int) -> tuple[list[int], int]:
        out = []
        for _ in range(n):
            last_id = _greedy_ids(draft_model, [last_id], off, draft_kv_cache)[0]
            out.append(last_id)
            off += 1
            if last_id in draft_eos:
                break
        return out, off

    def _rewind_both(n_target: int, n_draft: int) -> None:
        if n_target:
            kv_cache.rewind(n_target)
        if n_draft:
            draft_kv_cache.rewind(n_draft)

    try:
        token_id = _greedy_ids(model, target_prompt, 0, kv_cache)[0]
        offset = len(target_prompt)
        if token_id in target_eos:
            return _finish()
        if proposal_length == 0:
            return _target_only(token_id, offset)
        draft_kv_cache = draft_model.create_kv_cache()
        draft_token = _greedy_ids(draft_model, draft_prompt, 0, draft_kv_cache)[0]
        draft_offset = len(draft_prompt)
        if draft_token in draft_eos:
            return _target_only(token_id, offset)
        if auto_disable:
            t_target = _time_step(model, kv_cache, token_id, offset)
            t_draft = _time_step(draft_model, draft_kv_cache, token_id, draft_offset)
            # The verify forward streams the same weights as one step, so
            # t_target stands for it too (no verify-shape warm-up is wasted
            # if the guard disables speculation).
            bound = speculative_max_speedup(t_target, t_draft, t_target, proposal_length)
            if bound < 1.0:
                warnings.warn(
                    "speculative decoding disabled: the draft step is not fast enough to "
                    f"break even (measured target step {t_target * 1e3:.2f} ms, draft "
                    f"{t_draft * 1e3:.2f} ms; best-case speedup {bound:.2f}x < 1). "
                    "Continuing with plain greedy decode on the target model.",
                    stacklevel=2,
                )
                return _target_only(token_id, offset)

        while len(emitted) < max_tokens:
            draft_tokens, draft_offset = _draft_generate(token_id, draft_offset, proposal_length)
            verification = [token_id, *draft_tokens]
            predictions = _greedy_ids(model, verification, offset, kv_cache,
                                      n_keep=len(verification))
            offset += len(verification)
            counts["rounds"] += 1
            counts["proposed"] += len(draft_tokens)
            counts["accepted"] += next((j for j, (p, d) in enumerate(zip(predictions, draft_tokens))
                                        if p != d), len(draft_tokens))
            aligned = [token_id, *predictions[:-1]]
            mismatch = terminal = None
            for i, (tgt, drafted) in enumerate(zip(aligned, verification)):
                if tgt != drafted:
                    mismatch = i
                    break
                if tgt in target_eos:
                    terminal = i
                    break
            cut = terminal if terminal is not None else mismatch
            if cut is not None:
                _emit(aligned[:cut])
                _rewind_both(len(verification) - cut, len(draft_tokens) - cut)
                offset -= len(verification) - cut
                draft_offset -= len(draft_tokens) - cut
                if terminal is not None:
                    return _finish()
                token_id = aligned[cut]
                if token_id in target_eos:
                    return _finish()
                continue
            _emit(aligned)
            bonus = predictions[-1]
            if bonus in target_eos:
                return _finish()
            _, draft_offset = _draft_generate(verification[-1], draft_offset, 1)
            token_id = bonus
        return _finish()
    finally:
        for c in (draft_kv_cache, kv_cache):
            if c is not None:
                c.release()
