"""Serving metrics ledger — a copy of tiny_llm_tpu/serving/metrics.py
(pure Python; importing it from the JAX package would pull in JAX).

The copy counters are structurally zero in this design too (no concat
growth, no batch reconstruction, no pool realloc); they are still reported
so the ledger shows *why* they are zero.
"""

from __future__ import annotations

import dataclasses


def _pct(sorted_vals: list[float], q: float) -> float:
    """Linear-interpolated percentile over an already-sorted list."""
    n = len(sorted_vals)
    if n == 1:
        return sorted_vals[0]
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


@dataclasses.dataclass
class ServingMetrics:
    requests_completed: int = 0
    prefill_tokens: int = 0
    output_tokens: int = 0
    decode_steps: int = 0
    batched_decode_slots: int = 0  # sum over steps of active slots
    peak_active_requests: int = 0
    peak_live_pages: int = 0
    pool_capacity_pages: int = 0
    page_size: int = 0
    tail_waste_slots: int = 0  # allocated-but-unused page slots at peak
    reused_page_allocations: int = 0
    wall_s: float = 0.0
    # Structurally-zero-by-design counters (reference ledger columns):
    growth_copy_bytes: int = 0  # dense concat growth — preallocated slabs
    staging_copy_bytes: int = 0  # batch reconstruction — slot masks instead
    copied_bytes_on_growth: int = 0  # pool realloc — fixed pool
    # Per-request latency samples (ms). TTFT is arrival -> first output
    # token available on the host; with burst decode the first token is
    # produced by the prefill dispatch itself, so TTFT measures queueing
    # + chunked prefill, not burst quantization. admission_ttft excludes
    # scheduler queueing (admission -> first token): the pure prefill
    # latency a request pays once a slot opens. In the OFFLINE campaign
    # every request arrives at t=0, so ttft percentiles are dominated by
    # batch-division queueing; the open-loop mode
    # (batch_generate(arrival_times=...) / bench.py --arrival-rate)
    # stamps real arrivals, making TTFT a function of offered load.
    ttft_ms: list = dataclasses.field(default_factory=list)
    admission_ttft_ms: list = dataclasses.field(default_factory=list)
    request_latency_ms: list = dataclasses.field(default_factory=list)

    @property
    def peak_kv_bytes(self) -> int:
        return self.peak_live_pages * self.page_size * self._bytes_per_slot

    _bytes_per_slot: int = 0

    def observe_step(self, active_slots: int, pool=None) -> None:
        self.decode_steps += 1
        self.batched_decode_slots += active_slots
        self.peak_active_requests = max(self.peak_active_requests, active_slots)
        if pool is not None:
            self.peak_live_pages = max(self.peak_live_pages, pool.live_pages)
            self.reused_page_allocations = pool.reused_page_allocations

    def observe_request(self, req) -> None:
        """Fold one completed request's timestamps into the ledger.

        Reads the stamps batch.Request records (arrival_t, admitted_t,
        first_token_t, completed_t); requests finishing with zero output
        tokens (immediate EOS) contribute latency but no TTFT sample."""
        self.requests_completed += 1
        self.prefill_tokens += len(req.prefill_tokens)
        self.output_tokens += len(req.output_ids)
        if req.first_token_t is not None:
            self.ttft_ms.append((req.first_token_t - req.arrival_t) * 1e3)
            self.admission_ttft_ms.append(
                (req.first_token_t - req.admitted_t) * 1e3
            )
        if req.completed_t is not None:
            self.request_latency_ms.append(
                (req.completed_t - req.arrival_t) * 1e3
            )

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("_bytes_per_slot", None)
        if self.decode_steps:
            d["mean_batch_occupancy"] = round(
                self.batched_decode_slots / self.decode_steps, 2
            )
        if self.wall_s:
            d["output_tok_s"] = round(self.output_tokens / self.wall_s, 2)
            d["req_s"] = round(self.requests_completed / self.wall_s, 3)
        for name in ("ttft_ms", "admission_ttft_ms", "request_latency_ms"):
            samples = sorted(d.pop(name))
            if not samples:
                continue
            base = name[: -len("_ms")]
            d[f"{base}_p50_ms"] = round(_pct(samples, 0.50), 2)
            d[f"{base}_p95_ms"] = round(_pct(samples, 0.95), 2)
            d[f"{base}_max_ms"] = round(samples[-1], 2)
        return d
