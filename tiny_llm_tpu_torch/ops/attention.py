"""Attention in f32: causal mask, simple and grouped SDPA.

Counterpart of tiny_llm_tpu/ops/attention.py, and the oracle the plain
versions of the attention kernels (K2, K3) are checked against: f32
scores, f32 softmax, f32 PV product.
"""

from __future__ import annotations

import torch

from .basics import softmax


def causal_mask(L: int, S: int, *, device: str | torch.device) -> torch.Tensor:
    """[L, S] additive mask: query i sees keys j <= i + (S - L)."""
    q_pos = torch.arange(L, device=device)[:, None] + (S - L)
    k_pos = torch.arange(S, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return torch.where(k_pos <= q_pos, zero, torch.tensor(float("-inf"), device=device))


def scaled_dot_product_attention_simple(q, k, v, scale=None, mask=None):
    """SDPA for equal head counts: q/k/v are [..., L|S, D]."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    scores = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask.to(torch.float32)
    w = softmax(scores, dim=-1)
    return torch.matmul(w, v.to(torch.float32)).to(q.dtype)


def scaled_dot_product_attention_grouped(q, k, v, scale=None, mask=None):
    """GQA attention. q [..., Hq, L, D]; k/v [..., Hkv, S, D].

    `mask` is None, "causal", or an additive tensor broadcastable to
    [..., Hq, L, S] (a head axis of 1 or Hq)."""
    *batch, Hq, L, D = q.shape
    Hkv, S = k.shape[-3], k.shape[-2]
    if Hq % Hkv:
        raise ValueError(f"H_q {Hq} not a multiple of H_kv {Hkv}")
    n_rep = Hq // Hkv
    scale = D**-0.5 if scale is None else scale
    qg = q.reshape(*batch, Hkv, n_rep, L, D).to(torch.float32)
    scores = torch.einsum("...hrld,...hsd->...hrls", qg, k.to(torch.float32)) * scale
    if mask is not None:
        if isinstance(mask, str):
            if mask != "causal":
                raise ValueError(f"unknown mask kind {mask!r}")
            m = causal_mask(L, S, device=q.device)
        else:
            m = mask.to(torch.float32)
            if m.ndim == q.ndim:
                if m.shape[-3] == Hq:
                    m = m.reshape(*m.shape[:-3], Hkv, n_rep, L, S)
                else:
                    m = m[..., None, :, :]
        scores = scores + m
    w = softmax(scores, dim=-1)
    out = torch.einsum("...hrls,...hsd->...hrld", w, v.to(torch.float32))
    return out.reshape(*batch, Hq, L, D).to(q.dtype)
