"""Generation sessions: KV-cache prefix reuse across agent turns, on the
port's model and caches (counterpart of tiny_llm_tpu/agent/generation.py).

Each turn re-encodes the full conversation, computes the common token
prefix with what the KV cache already holds, REWINDS the divergent
suffix, prefills only the new tokens in chunks, and greedy-decodes.
Includes the replay-last-token trick (when the cache covers the whole
prompt we must still run one token to obtain logits) and full cache
reset + retry on any reuse error: the model's offset check turns a cache
whose rows and id ledger went out of step into such an error. Emits
GenerationStats for observability.

The cache is the model's own (`create_kv_cache()`): a dense slab, or a
PagedKVCache once the model has a page pool, whose rewind frees whole
trailing pages. Token ids go to the model as a tensor on its device; the
argmax of the kept logits row runs there too, and one integer a token
comes back to the host.
"""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class GenerationStats:
    input_tokens: int = 0
    reused_tokens: int = 0
    rewound_tokens: int = 0
    prefilled_tokens: int = 0
    output_tokens: int = 0
    cold_start: bool = False
    latency_s: float = 0.0


def render_messages(messages: list[dict], add_generation_prompt: bool = True) -> str:
    """Deterministic chat rendering used when the tokenizer has no chat
    template (synthetic/byte tokenizers)."""
    parts = []
    for m in messages:
        parts.append(f"<|{m['role']}|>\n{m['content']}\n")
    if add_generation_prompt:
        parts.append("<|assistant|>\n")
    return "".join(parts)


class GenerationSession:
    def __init__(
        self,
        model,
        tokenizer,
        max_tokens: int = 512,
        prefill_chunk: int = 256,
    ):
        self.model = model
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.prefill_chunk = prefill_chunk
        self._cache = None
        self._cached_ids: list[int] = []
        eos = getattr(tokenizer, "eos_token_ids", None)
        self._eos = (
            {int(t) for t in eos} if eos is not None else {int(tokenizer.eos_token_id)}
        )

    # -- encoding ------------------------------------------------------------
    def encode_messages(self, messages: list[dict]) -> list[int]:
        apply = getattr(self.tokenizer, "apply_chat_template", None)
        if callable(apply):
            try:
                ids = apply(messages, tokenize=True, add_generation_prompt=True)
                return [int(t) for t in ids]
            except Exception:
                pass
        return [int(t) for t in self.tokenizer.encode(render_messages(messages))]

    # -- cache management ----------------------------------------------------
    def reset(self) -> None:
        if self._cache is not None:
            self._cache.release()
        self._cache = None
        self._cached_ids = []

    def _common_prefix(self, prompt_ids: list[int]) -> int:
        n = 0
        for a, b in zip(self._cached_ids, prompt_ids):
            if a != b:
                break
            n += 1
        return n

    def _ids(self, ids: list[int]) -> torch.Tensor:
        """[1, len(ids)] token ids on the model's device."""
        return torch.tensor([ids], dtype=torch.long, device=self.model.device)

    @staticmethod
    def _argmax(logits: torch.Tensor) -> int:
        """Greedy token of the last kept row (f32, as the JAX package's)."""
        return int(torch.argmax(logits[0, -1].to(torch.float32)))

    def _prefill(self, ids: list[int], offset: int):
        """Chunked prefill; returns logits of the final row."""
        logits = None
        pos = 0
        while pos < len(ids):
            chunk = ids[pos : pos + self.prefill_chunk]
            logits = self.model(
                self._ids(chunk), offset + pos, self._cache, logits_to_keep=1,
            )
            pos += len(chunk)
        return logits

    # -- main entry ----------------------------------------------------------
    def __call__(
        self, messages: list[dict], max_tokens: int | None = None
    ) -> tuple[str, GenerationStats]:
        t0 = time.monotonic()
        max_tokens = max_tokens or self.max_tokens
        prompt_ids = self.encode_messages(messages)
        stats = GenerationStats(input_tokens=len(prompt_ids))
        try:
            text = self._generate(prompt_ids, max_tokens, stats)
        except Exception:
            # Any reuse error invalidates the cache: reset and retry cold
            # (reference generation.py: full reset on reuse failure).
            self.reset()
            stats.cold_start = True
            stats.reused_tokens = 0
            stats.rewound_tokens = 0
            text = self._generate(prompt_ids, max_tokens, stats)
        stats.latency_s = time.monotonic() - t0
        return text, stats

    def _generate(
        self, prompt_ids: list[int], max_tokens: int, stats: GenerationStats
    ) -> str:
        if self._cache is None:
            self._cache = self.model.create_kv_cache()
            self._cached_ids = []
            stats.cold_start = True

        common = self._common_prefix(prompt_ids)
        if common == len(prompt_ids):
            # Cache covers the entire prompt; replay the last token to get
            # its logits (generation.py:214-227).
            common -= 1
        rewind_n = len(self._cached_ids) - common
        if rewind_n:
            self._cache.rewind(rewind_n)
            del self._cached_ids[common:]
        stats.reused_tokens = common
        stats.rewound_tokens = rewind_n

        suffix = prompt_ids[common:]
        stats.prefilled_tokens = len(suffix)
        logits = self._prefill(suffix, common)
        self._cached_ids.extend(suffix)

        out_ids: list[int] = []
        tok = self._argmax(logits)
        offset = len(self._cached_ids)
        for _ in range(max_tokens):
            if tok in self._eos:
                break
            out_ids.append(tok)
            self._cached_ids.append(tok)
            logits = self.model(self._ids([tok]), offset, self._cache, logits_to_keep=1)
            offset += 1
            tok = self._argmax(logits)
        stats.output_tokens = len(out_ids)
        return self.tokenizer.decode(out_ids)
