"""Continuous-batching serving CLI — counterpart of batch-main.py.

    python -m tiny_llm_tpu_torch.batch_main [--model qwen3-0.6b] [--checkpoint-path DIR]
        [--prompts-file FILE] [--batch-size 4] [--max-seq-len 512] [--dense]
        [--impl cuda|torch] [--device cuda|cpu]

Serves a list of prompts through `serving.batch_generate` (paged KV unless
--dense) and prints each request's text and the output tok/s. The model
comes from `main.build_model`: a checkpoint or synthetic weights.
"""

from __future__ import annotations

import argparse
import time

from .main import build_model
from .serving import batch_generate

DEFAULT_PROMPTS = [
    "Why is the sky blue?",
    "Write a haiku about autumn.",
    "Explain KV caching in one paragraph.",
    "What is 17 * 23?",
    "Name three uses of a paged KV cache.",
    "Describe the MXU in one sentence.",
]


def main(argv: list[str] | None = None) -> list[tuple[int, str]]:
    """Parse `argv` (sys.argv when None), serve, print and return the
    (prompt index, text) results."""
    p = argparse.ArgumentParser(description="Serve prompts with continuous batching.")
    p.add_argument("--model", default="qwen3-0.6b")
    p.add_argument("--checkpoint-path", default=None)
    p.add_argument("--prompts-file", default=None, help="one prompt per line")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--max-seq-len", type=int, default=512)
    p.add_argument("--prefill-step", type=int, default=128)
    p.add_argument("--max-output-tokens", type=int, default=None)
    p.add_argument("--dense", action="store_true", help="dense KV slots, no page pool")
    p.add_argument("--impl", default=None, choices=["cuda", "torch"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    model, tok = build_model(args.model, args.checkpoint_path, args.max_seq_len,
                             paged=not args.dense, impl=args.impl, device=args.device)
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts = [line.rstrip("\n") for line in f if line.strip()]
    else:
        prompts = DEFAULT_PROMPTS
    t0 = time.monotonic()
    results = batch_generate(model, tok, prompts, max_seq_len=args.max_seq_len,
                             batch_size=args.batch_size, prefill_step=args.prefill_step,
                             max_output_tokens=args.max_output_tokens)
    dt = time.monotonic() - t0
    for idx, text in sorted(results):
        print(f"[{idx}] {text.replace(chr(10), ' ')[:100]}")
    n_out = sum(len(tok.encode(t)) for _, t in results)
    print(f"-- {len(results)} requests, {n_out} output tokens, {dt:.1f}s, "
          f"{n_out / dt:.1f} tok/s")
    return results


if __name__ == "__main__":
    main()
