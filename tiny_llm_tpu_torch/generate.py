"""Generation loops — counterpart of tiny_llm_tpu/generate.py (simple and
KV-cached). The tokenizer contract is encode / decode / eos_token_id[s].
The host syncs once per emitted token, at the `int()` of the chosen id.
Sampling draws from an explicit torch.Generator seeded with `seed`."""

from __future__ import annotations

from typing import Callable

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
