"""Speculative decoding in rounds over the dense slab — counterpart of
tiny_llm_tpu/speculative.py.

`generate.speculative_generate` keeps the host-driven loop over cache
objects. Here the same algorithm runs in rounds over two preallocated
slabs, as the JAX package's jitted dispatch does:

  * the draft proposes `proposal_length` tokens greedily, each argmax kept
    on the device and fed to its next step;
  * the target verifies `[last, *proposals]` in one forward with
    logits_to_keep = K + 1 (K1 at M = K + 1, K3 at L = K + 1 on the card);
  * the longest accepted prefix is found on the device;
  * rewinding is free: the slabs are written at an offset, so a rejected
    suffix is just not advanced over, and the next round overwrites it;
  * after a full accept the draft has not cached its last proposal (the
    target did, in the verify forward), so one draft step catches it up,
    as the host loop's does. The JAX package's rounds skip that step and
    leave the slot stale, so its draft proposes the next round over a
    hole in its context (on Qwen3-4B with itself as draft, the stale
    slot halves acceptance); the port differs here on purpose.

The port's forward_step takes its offsets as a host list, so each round
reads its emitted count on the host once (one sync a round; the JAX
package fetches once per `rounds` rounds). `stats["dispatches"]` keeps the
JAX meaning: one per `rounds_per_dispatch` rounds; `stats["catch_ups"]`
counts the draft's catch-up steps. Greedy speculative
decoding is lossless: the stream equals the target's greedy continuation
whatever the draft proposes. `forced_alpha` replaces the accept / reject
comparison with draws from np.random.default_rng(forced_seed), exactly as
the JAX package draws them (benchmark mode: the compute is the same, the
acceptance rate pinned, and the stream is the verifier's own predictions).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.qwen3 import (
    Qwen3Config,
    Qwen3Params,
    forward_decode_burst_dense,
    forward_step,
    fuse_projections,
)
from .ops.quantize import QuantizedTensor
from .ops.rope import rope_tables


@dataclasses.dataclass(frozen=True)
class SpecModel:
    """One side (draft or target) of the speculative pair: fused params on
    their device, the config, the RoPE tables and the kernels' `impl`
    (None: the kernels on the card, their plain versions on the CPU)."""

    params: Qwen3Params
    cfg: Qwen3Config
    rope_tabs: tuple[torch.Tensor, torch.Tensor]
    impl: str | None = None

    @classmethod
    def build(cls, params: Qwen3Params, cfg: Qwen3Config, max_seq: int,
              impl: str | None = None) -> "SpecModel":
        """From the loaders' unfused params (fused here; they stay on their
        device, which the tables follow)."""
        dev = params.embedding.device
        return cls(fuse_projections(params), cfg,
                   rope_tables(cfg.head_dim, max_seq, base=cfg.rope_theta, device=dev), impl)

    @property
    def device(self) -> torch.device:
        return self.params.embedding.device

    @property
    def dtype(self) -> torch.dtype:
        emb = self.params.embedding
        return torch.bfloat16 if isinstance(emb, QuantizedTensor) else emb.dtype

    def empty_slabs(self, max_seq: int) -> tuple[torch.Tensor, torch.Tensor]:
        shape = (self.cfg.num_hidden_layers, 1, self.cfg.num_key_value_heads, max_seq,
                 self.cfg.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def step(self, tokens: torch.Tensor, offset: int, keys, values, keep: int) -> torch.Tensor:
        """One forward of tokens [1, L] at `offset`: logits [1, keep, V]."""
        return forward_step(self.params, self.cfg, self.rope_tabs, tokens, [offset], keys,
                            values, logits_to_keep=keep, impl=self.impl)


def _greedy_last(logits: torch.Tensor) -> torch.Tensor:
    """argmax of the last row, as a device tensor [1, 1]."""
    return torch.argmax(logits[0, -1].to(torch.float32)).reshape(1, 1)


def speculative_rounds(
    draft: SpecModel,
    target: SpecModel,
    last_token: torch.Tensor,  # [1, 1] on the device: last emitted token, not yet cached
    offset: int,  # valid context length in both slabs
    d_keys: torch.Tensor,
    d_values: torch.Tensor,
    t_keys: torch.Tensor,
    t_values: torch.Tensor,
    forced_reject: np.ndarray | None = None,  # [rounds, K] bool (benchmark mode)
    *,
    proposal_length: int,
    rounds: int,
) -> tuple[torch.Tensor, list[int], torch.Tensor, int]:
    """`rounds` speculation rounds; the slabs are written in place.

    Returns (emitted [rounds, K + 1] on the device, n_emit per round, the
    new last token [1, 1], the new offset): row r's first n_emit[r] tokens
    are round r's. `forced_reject[r, k]` replaces the comparison of
    proposal k in round r (rejected where True; the first rejection wins)."""
    K = proposal_length
    dev = last_token.device
    rows, n_emits = [], []
    last, off = last_token, offset
    for r in range(rounds):
        tok, proposals = last, []
        for k in range(K):
            tok = _greedy_last(draft.step(tok, off + k, d_keys, d_values, 1))
            proposals.append(tok)
        verification = torch.cat([last, *proposals], dim=1)  # [1, K + 1]
        logits = target.step(verification, off, t_keys, t_values, K + 1)
        predictions = torch.argmax(logits[0].to(torch.float32), dim=-1)  # [K + 1]
        if forced_reject is None:
            matches = predictions[:K] == verification[0, 1:]
        else:
            matches = torch.from_numpy(~forced_reject[r]).to(dev)
        m = torch.where(matches.all(), K, torch.argmin(matches.to(torch.int32)))
        n = int(m) + 1  # the round's one host sync
        if n == K + 1:
            draft.step(proposals[-1], off + K, d_keys, d_values, 1)
        rows.append(predictions)
        n_emits.append(n)
        last = predictions[n - 1].reshape(1, 1)
        off += n
    return torch.stack(rows), n_emits, last, off


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _prefill(model: SpecModel, prompt_ids: list[int], keys, values) -> torch.Tensor:
    tokens = torch.tensor([prompt_ids], dtype=torch.long, device=model.device)
    return model.step(tokens, 0, keys, values, 1)


def speculative_decode_device(
    draft: SpecModel,
    target: SpecModel,
    prompt_ids: list[int],
    *,
    max_tokens: int = 128,
    proposal_length: int = 4,
    rounds_per_dispatch: int = 4,
    max_seq: int | None = None,
    eos_ids: frozenset[int] = frozenset(),
    forced_alpha: float | None = None,
    forced_seed: int = 0,
    stats: dict | None = None,
) -> list[int]:
    """Prefill both models, then run speculation rounds `rounds_per_dispatch`
    at a time until `max_tokens` tokens (or an EOS) are out. Returns the
    emitted token ids (the prefill's token first)."""
    P, K = len(prompt_ids), proposal_length
    max_seq = max_seq or _round_up(P + max_tokens + (K + 1) * rounds_per_dispatch + 1, 128)
    d_keys, d_values = draft.empty_slabs(max_seq)
    t_keys, t_values = target.empty_slabs(max_seq)
    last = _greedy_last(_prefill(target, prompt_ids, t_keys, t_values))
    _prefill(draft, prompt_ids, d_keys, d_values)
    rng = np.random.default_rng(forced_seed) if forced_alpha is not None else None
    emitted = [int(last)]
    if emitted[0] in eos_ids:
        return []
    offset, dispatches, catch_ups = P, 0, 0
    while len(emitted) < max_tokens:
        forced = None
        if rng is not None:
            forced = rng.random((rounds_per_dispatch, K)) >= forced_alpha
        toks, n_emits, last, offset = speculative_rounds(
            draft, target, last, offset, d_keys, d_values, t_keys, t_values, forced,
            proposal_length=K, rounds=rounds_per_dispatch,
        )
        dispatches += 1
        catch_ups += sum(n == K + 1 for n in n_emits)
        toks_h = toks.tolist()
        done = False
        for r, n in enumerate(n_emits):
            for t in toks_h[r][:n]:
                if t in eos_ids:
                    done = True
                    break
                emitted.append(t)
            if done:
                break
        if done:
            break
    if stats is not None:
        stats["dispatches"] = dispatches
        stats["emitted"] = len(emitted)
        stats["catch_ups"] = catch_ups
    return emitted[:max_tokens]


def greedy_continuation(target: SpecModel, prompt_ids: list[int], n: int,
                        max_seq: int) -> list[int]:
    """Plain greedy decode of `n` tokens: the prefill, then one burst of
    n - 1 steps with the argmax on the device (the non-speculative
    baseline and the reference stream)."""
    keys, values = target.empty_slabs(max_seq)
    last = _greedy_last(_prefill(target, prompt_ids, keys, values))
    if n <= 1:
        return [int(last)][:n]
    toks = forward_decode_burst_dense(
        target.params, target.cfg, target.rope_tabs, last.reshape(1), len(prompt_ids), keys,
        values, steps=n - 1, impl=target.impl,
    )
    return [int(last), *toks[:, 0].tolist()]
