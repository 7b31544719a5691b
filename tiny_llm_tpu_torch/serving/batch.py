"""Continuous-batching scheduler with chunked prefill — counterpart of
tiny_llm_tpu/serving/batch.py (`Request`, `batch_generate`), classic
schedule as-is: fixed decode slots, at most one pending prefill request,
power-of-two prefill chunks, decode bursts, EOS / max-seq / max-output
eviction, pool backpressure and open-loop arrivals.

A request prefills into its own cache (dense or paged), then is installed
into a batch slot: a copy into the dense slab, or O(1) metadata for the
paged cache, whose pages already live in the shared pool. Sampling draws
from explicit torch.Generators derived from `seed`: reproducible, but not
the JAX package's random stream.

`mixed_prefill=True` runs the JAX package's mixed schedule as-is: while a
prompt is pending beside active decode slots, each decode burst also
prefills `mixed_chunk`-token sub-chunks of the pending prompt and then of
the next arrived prompts, back to back (Qwen3Model.mixed_burst); requests
whose prefill ends inside a burst wait in `ready` for a free slot.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from ..kv.paged import PoolExhausted
from ..ops.sampler import make_sampler
from .metrics import ServingMetrics


def _argmax_last(logits: torch.Tensor) -> np.ndarray:
    return logits[:, -1, :].to(torch.float32).argmax(dim=-1).cpu().numpy()


def _sample_last(logits: torch.Tensor, sampler: Callable, generator) -> np.ndarray:
    lp = torch.log_softmax(logits[:, -1, :].to(torch.float32), dim=-1)
    return sampler(lp, generator).cpu().numpy()


def _request_generator(device, seed: int, idx: int) -> torch.Generator:
    """Request idx's own stream: independent of the other requests' and of
    the order they are admitted in."""
    state = np.random.SeedSequence([seed, idx]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class Request:
    """One in-flight generation request."""

    def __init__(
        self,
        model: Any,
        tokenizer: Any,
        prompt: str,
        prefill_max_step: int = 128,
        prompt_idx: int = 0,
        sampler: Callable | None = None,
        generator: torch.Generator | None = None,
        arrival_t: float | None = None,
    ):
        self.sampler = sampler
        self.generator = generator
        self.prompt = prompt
        # Latency stamps (monotonic seconds): arrival_t is when the request
        # entered the system (the campaign start for an offline batch),
        # admitted_t when its prefill began. ServingMetrics.observe_request
        # turns them into TTFT / latency percentiles.
        self.admitted_t = time.monotonic()
        self.arrival_t = self.admitted_t if arrival_t is None else arrival_t
        self.first_token_t: float | None = None
        self.completed_t: float | None = None
        self.model = model
        self.kv_cache = model.create_kv_cache()
        self.prefill_tokens = list(tokenizer.encode(prompt))
        if hasattr(self.kv_cache, "ensure_capacity"):
            # Reserve the whole prompt's pages at admission. If the pool
            # cannot hold them now, release the handle before re-raising so
            # the caller can defer admission without leaking pages.
            try:
                self.kv_cache.ensure_capacity(len(self.prefill_tokens))
            except PoolExhausted:
                self.kv_cache.release()
                raise
        self.prefill_max_step = prefill_max_step
        self.is_done = False
        self.is_prefill_done = False
        eos = getattr(tokenizer, "eos_token_ids", None)
        self.eos_ids = (
            {int(t) for t in eos} if eos is not None else {int(tokenizer.eos_token_id)}
        )
        self.next_token: int | None = None
        self.offset = 0
        self.prompt_idx = prompt_idx
        self.output_ids: list[int] = []
        self._tokenizer = tokenizer

    def try_prefill(self) -> None:
        """Advance prefill by at most prefill_max_step tokens, in a chunk
        whose size is the largest power of two that fits the remainder."""
        if self.is_prefill_done:
            raise ValueError("prefill called after done")
        n = min(self.prefill_max_step, len(self.prefill_tokens) - self.offset)
        if n > 1:
            n = 1 << (n.bit_length() - 1)
        chunk = self.prefill_tokens[self.offset : self.offset + n]
        logits = self.model([chunk], self.offset, self.kv_cache, logits_to_keep=1)
        self.offset += n
        if self.offset == len(self.prefill_tokens):
            self.is_prefill_done = True
            if self.sampler is not None:
                tok = int(_sample_last(logits, self.sampler, self.generator)[0])
            else:
                tok = int(_argmax_last(logits)[0])
            self.decode_done(tok, update_offset=False)

    def decode_done(self, token: int, update_offset: bool = True) -> None:
        if self.is_done:
            raise ValueError("decode called after done")
        if token in self.eos_ids:
            self.is_done = True
            self.completed_t = time.monotonic()
            return
        if self.first_token_t is None:
            # The first output token comes from the prefill step itself, so
            # TTFT = queueing + prefill.
            self.first_token_t = time.monotonic()
        self.output_ids.append(token)
        self.next_token = token
        if update_offset:
            self.offset += 1

    def text(self) -> str:
        return self._tokenizer.decode(self.output_ids)


def batch_generate(
    model: Any,
    tokenizer: Any,
    prompts: list[str],
    max_seq_len: int = 512,
    batch_size: int = 5,
    prefill_step: int = 128,
    progress_callback: Callable | None = None,
    max_output_tokens: int | None = None,
    metrics: ServingMetrics | None = None,
    decode_burst: int = 8,
    prefill_chunks_per_iter: int | None = None,
    temp: float = 0.0,
    top_k: int | None = None,
    top_p: float | None = None,
    seed: int = 0,
    arrival_times: list[float] | None = None,
    mixed_prefill: bool = False,
    mixed_chunk: int = 32,
) -> list[tuple[int, str]]:
    """Serve `prompts` with continuous batching; returns (prompt_idx, text).

    Each iteration advances the pending prefill by up to
    `prefill_chunks_per_iter` chunks (admitting the next arrived prompt when
    none is pending), then decodes every installed slot: a `decode_burst`-
    step burst over a paged cache, one step over the dense slots, then
    evicts finished requests. temp > 0 samples (top-k / top-p) on the
    device. `arrival_times` (non-decreasing seconds from the campaign
    start, one per prompt) makes the campaign open-loop: a prompt enters
    the queue only once its time has come, and the scheduler idles until
    then when nothing is in flight. `mixed_prefill` advances pending
    prompts inside the decode bursts instead, in `mixed_chunk`-token
    sub-chunks, where the model supports it (a paged pool whose page size
    `mixed_chunk` divides); misaligned offsets and a prefill with no active
    slot take the classic path."""
    sampler = make_sampler(temp, top_p, top_k) if temp > 0 else None
    burst_gen = torch.Generator(device=model.device).manual_seed(seed) if temp > 0 else None
    if arrival_times is not None:
        if len(arrival_times) != len(prompts):
            raise ValueError("arrival_times must match prompts 1:1")
        if any(b < a for a, b in zip(arrival_times, arrival_times[1:])):
            raise ValueError("arrival_times must be non-decreasing")
    queue = [
        (i, p, 0.0 if arrival_times is None else float(arrival_times[i]))
        for i, p in enumerate(prompts)
    ]
    if prefill_chunks_per_iter is None:
        # Rate-match admission to burst decode: each iteration retires
        # ~decode_burst tokens per slot, so prefill advances several chunks.
        prefill_chunks_per_iter = max(1, decode_burst // 2)
    decode_requests: list[Request | None] = [None] * batch_size
    kv_cache = model.create_batching_kv_cache(
        max_active_requests=batch_size, max_seq_len=max_seq_len
    )
    paged = getattr(kv_cache, "owns_added_requests", False)
    result: list[tuple[int, str]] = []
    pending: Request | None = None
    start = time.monotonic()

    mixed_ok = (
        mixed_prefill
        and decode_burst > 1
        and getattr(model, "supports_mixed", False)
        and paged
        # Mixed sub-chunks stay inside one page: the chunk divides the page size.
        and model.page_pool.page_size % mixed_chunk == 0
    )
    # Requests whose prefill completed inside a mixed burst, waiting for a
    # free decode slot.
    ready: list[Request] = []

    def new_request(idx: int, prompt: str, arr_rel: float) -> Request:
        return Request(
            model, tokenizer, prompt, prefill_step, idx, sampler=sampler,
            generator=(
                _request_generator(model.device, seed, idx) if sampler is not None else None
            ),
            arrival_t=start + arr_rel,
        )

    def try_install(req: Request) -> bool:
        """Install a prefilled request in a free slot, if any: the first, or
        the one a placement-constrained cache chooses (DP replica pinning,
        parallel/dp.py; None stalls admission until one of its slots frees)."""
        free = [i for i in range(batch_size) if decode_requests[i] is None]
        if hasattr(kv_cache, "choose_slot"):
            slot = kv_cache.choose_slot(req.kv_cache, free)
        else:
            slot = free[0] if free else None
        if slot is None:
            return False
        kv_cache.add_request(req.kv_cache, slot)
        if not paged:
            # The dense slot holds a copy; the request's own slab goes.
            req.kv_cache.release()
        decode_requests[slot] = req
        return True

    def mixed_handles_prefill() -> bool:
        """Whether this iteration's burst advances the pending prefill as
        mixed steps (so the classic chunk loop leaves it alone). Misaligned
        offsets (a classic chunk smaller than the mixed chunk ran first)
        take the classic path."""
        return (
            mixed_ok
            and pending is not None
            and not pending.is_prefill_done
            and pending.offset % mixed_chunk == 0
            and any(r is not None for r in decode_requests)
        )

    while True:
        if (not queue and all(r is None for r in decode_requests) and pending is None
                and not ready):
            break

        # Requests whose prefill completed inside a mixed burst take slots
        # as they free, first come first served.
        while ready and try_install(ready[0]):
            ready.pop(0)

        # Open-loop idle: nothing in flight and the next request has not
        # arrived yet — sleep until it does (bounded naps).
        if (queue and pending is None and not ready
                and all(r is None for r in decode_requests)):
            wait = queue[0][2] - (time.monotonic() - start)
            if wait > 0:
                time.sleep(min(wait, 0.05))
                if progress_callback is not None:
                    progress_callback(decode_requests, pending, len(queue), start)
                continue

        for _ in range(prefill_chunks_per_iter):
            if queue and pending is None and time.monotonic() - start >= queue[0][2]:
                idx, prompt, arr_rel = queue.pop(0)
                try:
                    pending = new_request(idx, prompt, arr_rel)
                except PoolExhausted as e:
                    # Pool backpressure: requeue the prompt and let active
                    # requests retire. A pool that cannot fit it with
                    # nothing else running never will: a sizing error.
                    queue.insert(0, (idx, prompt, arr_rel))
                    if all(r is None for r in decode_requests):
                        raise RuntimeError(
                            "page pool cannot fit the next prompt even with no active "
                            "requests; size the pool for the longest prompt"
                        ) from e
                    break
            if pending is None:
                break
            if not pending.is_prefill_done:
                if mixed_handles_prefill():
                    break  # the burst below advances it as mixed steps
                pending.try_prefill()
            if pending.is_prefill_done:
                if pending.is_done:
                    # EOS directly after prefill; never occupies a slot.
                    result.append((pending.prompt_idx, pending.text()))
                    if metrics is not None:
                        metrics.observe_request(pending)
                    pending.kv_cache.release()
                    pending = None
                    continue
                if not try_install(pending):
                    break  # prefilled but no compatible slot: stop prefilling
                pending = None

        if any(r is not None for r in decode_requests):
            active = sum(1 for r in decode_requests if r is not None)
            if metrics is not None:
                metrics.observe_step(active, getattr(kv_cache, "pool", None))
            next_tokens = [(r.next_token if r is not None else 0) for r in decode_requests]
            if mixed_handles_prefill():
                # The schedule gives each of the burst's steps one sub-chunk:
                # the pending request's remaining prompt, then the next
                # arrived prompts back to back, admitted into the burst.
                from ..models.qwen3 import MixedStep

                schedule: list = [None] * decode_burst
                finishing: list[tuple[int, Request]] = []
                cur, pending = pending, None
                for t in range(decode_burst):
                    if cur is None:
                        if not (queue and time.monotonic() - start >= queue[0][2]):
                            break
                        try:
                            cur = new_request(*queue[0])
                        except PoolExhausted:
                            # Backpressure mid-burst: the prompt stays queued
                            # until retiring requests free pages.
                            break
                        queue.pop(0)
                    remaining = len(cur.prefill_tokens) - cur.offset
                    r = min(mixed_chunk, remaining)
                    schedule[t] = MixedStep(
                        cache=cur.kv_cache, tokens=cur.prefill_tokens[cur.offset : cur.offset + r],
                        offset=cur.offset,
                        # The completion draw uses the request's own stream,
                        # as the classic path's post-prefill draw does.
                        generator=cur.generator if r == remaining else None,
                    )
                    cur.offset += r
                    if cur.offset == len(cur.prefill_tokens):
                        cur.is_prefill_done = True
                        finishing.append((t, cur))
                        cur = None
                pending = cur
                toks, comp = model.mixed_burst(
                    kv_cache, np.asarray(next_tokens, np.int32), decode_burst, schedule,
                    mixed_chunk, temp=temp, top_k=top_k, top_p=top_p, generator=burst_gen,
                )
                for t, req in finishing:
                    # comp[t]: the request's first output token, drawn at its
                    # sub-chunk's last real row.
                    req.decode_done(int(comp[t]), update_offset=False)
                    if req.is_done:
                        # EOS directly after prefill; never occupies a slot.
                        result.append((req.prompt_idx, req.text()))
                        if metrics is not None:
                            metrics.observe_request(req)
                        req.kv_cache.release()
                    else:
                        ready.append(req)
            elif decode_burst > 1 and paged:
                # One host sync for `decode_burst` tokens per slot; EOS
                # reactions lag by less than one burst.
                toks = model.decode_burst(
                    kv_cache, np.asarray(next_tokens, np.int32), decode_burst,
                    temp=temp, top_k=top_k, top_p=top_p, generator=burst_gen,
                )  # [K, B]
            else:
                logits = model(
                    np.asarray(next_tokens, np.int64).reshape(-1, 1),
                    [(r.offset if r is not None else 0) for r in decode_requests],
                    kv_cache,
                    logits_to_keep=1,
                )
                if sampler is not None:
                    toks = _sample_last(logits, sampler, burst_gen)[None, :]  # [1, B]
                else:
                    toks = _argmax_last(logits)[None, :]  # [1, B]
            for i in range(batch_size):
                req = decode_requests[i]
                if req is None:
                    continue
                reason = None
                for j in range(toks.shape[0]):
                    req.decode_done(int(toks[j, i]))
                    if req.is_done:
                        reason = "EOS"
                    elif req.offset >= max_seq_len:
                        reason = "max seq len"
                    elif max_output_tokens is not None and len(req.output_ids) >= max_output_tokens:
                        reason = "max output tokens"
                    if reason is not None:
                        break
                if reason is not None:
                    kv_cache.remove_request(i)
                    result.append((req.prompt_idx, req.text()))
                    if req.completed_t is None:  # max-len / max-output evictions
                        req.completed_t = time.monotonic()
                    if metrics is not None:
                        metrics.observe_request(req)
                    decode_requests[i] = None
        if progress_callback is not None:
            progress_callback(decode_requests, pending, len(queue), start)
    return result
