"""Split-attention chunked prefill: prefix ⊕ chunk softmax-state combine.

Counterpart of tiny_llm_tpu/kernels/split_prefill.py. A prefill chunk at
offset > 0 attends to (a) the cached prefix, every prefix key visible to
every chunk query, and (b) its own tokens, causally. The two parts run as
separate passes, each emitting its online-softmax state, and merge exactly:

    m = max(m_a, m_b);  w_x = l_x * exp(m_x - m)
    out = (w_a * o_a + w_b * o_b) / (w_a + w_b)

  * the chunk part: `flash_prefill_state` on the chunk's own k/v at
    chunk-local positions 0..L-1 (kernels/flash_attention.py; on the card
    the CUDA port of `_prefill_state_kernel`);
  * the prefix part: `paged_prefix_state` over the pages before the chunk
    (kernels/paged_attention.py; the CUDA port of
    `_paged_prefix_state_kernel`);
  * the combine: plain torch ops, as the JAX package leaves it to XLA.

Both halves' o come in q's dtype (bf16), as the TPU kernels emit them; the
combine runs in f32 and rounds once. A row with an empty prefix (offset 0)
contributes the identity state (o = 0, m = -1e30, l = 0).
"""

from __future__ import annotations

import torch

from .flash_attention import flash_prefill_state
from .paged_attention import paged_prefix_state


def combine_state_pair(o1, m1, l1, o2, m2, l2) -> torch.Tensor:
    """Merge two locally normalised online-softmax states over disjoint key
    sets (o [B, Hq, L, D], m and l [B, Hq, L] f32) into the exact attention
    over their union, in o1's dtype."""
    m = torch.maximum(m1, m2)
    w1 = l1 * torch.exp(m1 - m)
    w2 = l2 * torch.exp(m2 - m)
    num = w1[..., None] * o1.to(torch.float32) + w2[..., None] * o2.to(torch.float32)
    den = torch.clamp(w1 + w2, min=1e-30)
    return (num / den[..., None]).to(o1.dtype)


def split_paged_prefill(
    q: torch.Tensor,  # [B, Hq, L, D] — chunk queries (RoPE applied)
    k_chunk: torch.Tensor,  # [B, Hkv, L, D] — chunk keys (RoPE applied)
    v_chunk: torch.Tensor,
    key_pages: torch.Tensor,  # [P, Hkv, ps, D] — one layer's pages
    value_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32, -1 padded
    prefix_lens: torch.Tensor,  # [B] int32 — row offsets (0 rows are fine)
    scale: float | None = None,
    impl: str | None = None,
) -> torch.Tensor:
    """Chunk attention over (prefix pages ⊕ chunk), combined exactly. The
    chunk's k/v may already be written into the pages (forward_step_paged
    writes them first): the prefix pass reads only positions below
    prefix_lens, so offsets need not be page-aligned."""
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    B, _, L, _ = q.shape
    lens_full = torch.full((B,), L, dtype=torch.int32, device=q.device)
    o_c, m_c, l_c = flash_prefill_state(q, k_chunk, v_chunk, lens_full, scale, impl=impl)
    o_p, m_p, l_p = paged_prefix_state(q, key_pages, value_pages, block_table, prefix_lens,
                                       scale, impl=impl)
    return combine_state_pair(o_c, m_c, l_c, o_p, m_p, l_p)
