"""Single-request generation CLI — counterpart of main.py.

    python -m tiny_llm_tpu_torch.main [--model qwen3-0.6b] [--checkpoint-path DIR]
        [--draft-model NAME | --draft-checkpoint-path DIR] [--no-cache] [--paged]
        [--impl cuda|torch] [--device cuda|cpu] [--max-tokens N] ...

Loads a HF checkpoint directory if given (its tokenizer needs the
`transformers` package), else builds the named architecture with synthetic
W4A16 weights from seed 0 and a byte tokenizer; the pipeline is the same
either way. With a draft model it runs speculative decoding
(`generate.speculative_generate`, its break-even guard on unless
--no-spec-guard). Runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse

from .generate import simple_generate, simple_generate_with_kv_cache, speculative_generate
from .models import QWEN3_CONFIGS, Qwen3Model, load_params, synthetic_quantized_params
from .ops import make_sampler
from .tokenizer import ByteTokenizer, load_tokenizer


def build_model(
    name: str,
    checkpoint: str | None,
    max_seq_len: int,
    paged: bool,
    impl: str | None,
    device: str = "cuda",
):
    """(model, tokenizer): a checkpoint's weights (W4A16 g128 at load) and
    tokenizer, or synthetic weights of the named shape and the byte
    tokenizer (byte ids fit any Qwen3 vocabulary)."""
    if checkpoint:
        tok = load_tokenizer(checkpoint)
        params, cfg = load_params(checkpoint, device=device)
    else:
        cfg = QWEN3_CONFIGS[name]
        params = synthetic_quantized_params(cfg, seed=0, device=device)
        tok = ByteTokenizer()
    model = Qwen3Model(params, cfg, max_seq_len=max_seq_len, impl=impl, device=device)
    if paged:
        model.enable_paged_attention()
    return model, tok


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate text with a Qwen3 model on one GPU.")
    p.add_argument("--model", default="qwen3-0.6b", help="shortcut name")
    p.add_argument("--checkpoint-path", default=None, help="HF checkpoint dir")
    p.add_argument("--draft-model", default=None)
    p.add_argument("--draft-checkpoint-path", default=None)
    p.add_argument("--no-spec-guard", action="store_true",
                   help="run speculative decoding even if the measured draft/target "
                   "step-time ratio cannot break even")
    p.add_argument("--prompt", default="Give me a short introduction to LLMs.")
    p.add_argument("--max-tokens", type=int, default=256)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--no-cache", action="store_true", help="recompute the prefix every token")
    p.add_argument("--paged", action="store_true", help="paged KV cache")
    p.add_argument("--impl", default=None, choices=["cuda", "torch"],
                   help="torch: the kernels' plain PyTorch versions")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--temp", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=None)
    p.add_argument("--top-k", type=int, default=None)
    return p


def main(argv: list[str] | None = None) -> str:
    """Parse `argv` (sys.argv when None), generate, print and return the text."""
    args = parser().parse_args(argv)
    model, tok = build_model(args.model, args.checkpoint_path, args.max_seq_len, args.paged,
                             args.impl, args.device)

    def stream(text: str) -> None:
        print(f"\r{text[-100:]}", end="", flush=True)

    if args.draft_model or args.draft_checkpoint_path:
        draft, draft_tok = build_model(args.draft_model or args.model,
                                       args.draft_checkpoint_path, args.max_seq_len,
                                       args.paged, args.impl, args.device)
        out = speculative_generate(draft, model, draft_tok, tok, args.prompt,
                                   max_tokens=args.max_tokens, on_token=stream,
                                   auto_disable=not args.no_spec_guard)
    else:
        sampler = make_sampler(args.temp, args.top_p, args.top_k)
        loop = simple_generate if args.no_cache else simple_generate_with_kv_cache
        out = loop(model, tok, args.prompt, sampler=sampler, max_tokens=args.max_tokens,
                   on_token=stream)
    print()
    print(out)
    return out


if __name__ == "__main__":
    main()
