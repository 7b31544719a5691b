"""Tokenizers — copies of ByteTokenizer and StreamingDetokenizer from
tiny_llm_tpu/tokenizer.py (pure Python; importing that package would pull
in JAX), and `load_tokenizer`, the HF tokenizer adapter, which imports
`transformers` when called and raises where it is absent."""

from __future__ import annotations


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: ids 0..255, EOS 256."""

    vocab_size = 257
    eos_token_id = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8")) or [0]

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", "replace")

    def get_vocab(self):
        return {str(i): i for i in range(self.vocab_size)}


class StreamingDetokenizer:
    """Incremental detokenizer: per token it re-decodes only a bounded
    window (a few finalized context ids plus the pending ids), holding back
    a partial UTF-8 sequence (a trailing U+FFFD) until it completes, for at
    most _MAX_PENDING ids."""

    _CONTEXT = 4
    _MAX_PENDING = 4

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._context: list[int] = []
        self._context_text = ""
        self._pending: list[int] = []
        self.text = ""
        self.last_segment = ""

    def _flush(self) -> str:
        window = self._context + self._pending
        full = self._tok.decode(window)
        if self._context_text and full.startswith(self._context_text):
            segment = full[len(self._context_text):]
        else:
            segment = self._tok.decode(self._pending)
        self._context = window[-self._CONTEXT:]
        self._context_text = self._tok.decode(self._context)
        self._pending = []
        self.text += segment
        self.last_segment = segment
        return segment

    def add_token(self, token_id: int) -> str:
        """Feed one token id; return newly finalized text ("" if held)."""
        self._pending.append(int(token_id))
        full = self._tok.decode(self._context + self._pending)
        if full.endswith("�") and len(self._pending) < self._MAX_PENDING:
            self.last_segment = ""
            return ""
        return self._flush()

    def finalize(self) -> str:
        """Flush held-back ids; return the final segment."""
        if not self._pending:
            self.last_segment = ""
            return ""
        return self._flush()


def load_tokenizer(model_dir: str):
    """The HF tokenizer of a checkpoint directory (transformers'
    AutoTokenizer) behind the port's contract: encode (no special tokens),
    decode, eos_token_id, get_vocab, apply_chat_template."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise RuntimeError(
            f"loading the tokenizer of {model_dir} needs the `transformers` package, which "
            "this environment lacks; run without a checkpoint path (synthetic weights and "
            "the byte tokenizer) or install it"
        ) from e
    tok = AutoTokenizer.from_pretrained(model_dir)

    class _Wrapped:
        eos_token_id = tok.eos_token_id

        def encode(self, text: str) -> list[int]:
            return tok.encode(text, add_special_tokens=False)

        def decode(self, ids) -> str:
            return tok.decode(list(ids))

        def get_vocab(self):
            return tok.get_vocab()

        def apply_chat_template(self, messages, **kw):
            return tok.apply_chat_template(messages, **kw)

    return _Wrapped()
