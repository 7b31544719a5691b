"""Token samplers: greedy / temperature / top-k / top-p.

Counterpart of tiny_llm_tpu/ops/sampler.py with the same masking order
(top-k, then top-p on the masked distribution, then temperature, then a
categorical draw). The draw takes an explicit torch.Generator on the
logits' device, so sampling stays on the card.
"""

from __future__ import annotations

import torch


def apply_top_k(logprobs: torch.Tensor, top_k: int) -> torch.Tensor:
    kth = torch.topk(logprobs, top_k, dim=-1).values[..., -1:]
    return torch.where(logprobs >= kth, logprobs, float("-inf"))


def apply_top_p(logprobs: torch.Tensor, top_p: float) -> torch.Tensor:
    """Keep a token iff the cumulative mass strictly before it is < top_p."""
    sorted_lp = torch.sort(logprobs, dim=-1, descending=True).values
    sorted_p = torch.exp(sorted_lp)
    cum = torch.cumsum(sorted_p, dim=-1)
    keep = (cum - sorted_p) < top_p
    kept_min = torch.where(keep, sorted_lp, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where(logprobs >= kept_min, logprobs, float("-inf"))


def make_sampler(temp: float, top_p: float | None = None, top_k: int | None = None):
    """Returns sample(logprobs [B, V], generator) -> int32 tokens [B]."""

    def sample(logprobs: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if temp == 0:
            return torch.argmax(logprobs, dim=-1).to(torch.int32)
        if generator is None:
            raise ValueError("temperature sampling needs a torch.Generator")
        lp = logprobs.to(torch.float32)
        if top_k is not None and top_k > 0:
            lp = apply_top_k(lp, top_k)
        if top_p is not None and top_p > 0:
            lp = apply_top_p(lp, top_p)
        probs = torch.softmax(lp / temp, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    return sample
