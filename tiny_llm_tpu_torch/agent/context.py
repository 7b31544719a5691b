"""Token-budget context management with durable compaction.

The port's copy of tiny_llm_tpu/agent/context.py (pure Python: the port
cannot import the JAX package, whose __init__ imports JAX); only its
docstrings differ.

Parity: the reference's agent/context.py (843 LoC) —
the capabilities preserved: a validating ContextPolicy, per-tool-result
truncation (head+tail), complete-turn boundary computation, a structured
WorkingSummary (model-written with a deterministic fallback), and a
durable `compaction` event so the compacted view is reproducible from the
session log alone.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable

SUMMARY_FIELDS = (
    "goal",
    "constraints",
    "facts",
    "changed_files",
    "validation",
    "failed_approaches",
    "next_step",
)


class ContextLimitError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class ContextPolicy:
    max_tokens: int = 32768
    reserve_output: int = 8192
    max_summary_tokens: int = 1024
    max_tool_result_tokens: int = 4096
    min_recent_turns: int = 2

    def __post_init__(self):
        if self.reserve_output >= self.max_tokens:
            raise ValueError("reserve_output must be below max_tokens")
        if self.min_recent_turns < 1:
            raise ValueError("min_recent_turns must be >= 1")

    @property
    def input_budget(self) -> int:
        return self.max_tokens - self.reserve_output


@dataclasses.dataclass
class WorkingSummary:
    """7-field structured summary (reference context.py:68-101)."""

    goal: str = ""
    constraints: list = dataclasses.field(default_factory=list)
    facts: list = dataclasses.field(default_factory=list)
    changed_files: list = dataclasses.field(default_factory=list)
    validation: list = dataclasses.field(default_factory=list)
    failed_approaches: list = dataclasses.field(default_factory=list)
    next_step: str = ""

    def render(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps({k: d[k] for k in SUMMARY_FIELDS}, ensure_ascii=False)

    @staticmethod
    def parse(text: str) -> "WorkingSummary":
        obj = json.loads(text)
        if not isinstance(obj, dict):
            raise ValueError("summary must be a JSON object")
        kwargs = {}
        for k in SUMMARY_FIELDS:
            v = obj.get(k, [] if k not in ("goal", "next_step") else "")
            kwargs[k] = v
        return WorkingSummary(**kwargs)


def _turn_boundaries(messages: list[dict]) -> list[int]:
    """Indices where complete turns start: a user message that is not a
    tool_result continuation."""
    bounds = []
    for i, m in enumerate(messages):
        if m["role"] == "user" and not m["content"].startswith("tool_result:"):
            bounds.append(i)
    return bounds


def compact_messages(
    messages: list[dict], max_chars: int, min_recent_turns: int = 2
) -> list[dict]:
    """Char-budget fallback compaction: keep the first user message (task
    anchor) + the most recent complete turns that fit
    (reference context.py:119-155)."""
    total = sum(len(m["content"]) for m in messages)
    if total <= max_chars:
        return list(messages)
    bounds = _turn_boundaries(messages)
    anchor_end = bounds[1] if len(bounds) > 1 else len(messages)
    anchor = messages[:anchor_end][:1]
    for start_idx in bounds[1:][::-1][min_recent_turns - 1 :]:
        tail = messages[start_idx:]
        kept = anchor + [{"role": "user", "content": "[earlier context dropped]"}] + tail
        if sum(len(m["content"]) for m in kept) <= max_chars:
            return kept
    # Even the minimum doesn't fit; keep anchor + last turn regardless.
    last = bounds[-1] if bounds else 0
    return anchor + messages[last:]


def bound_tool_result(content: str, max_chars: int) -> str:
    """Head+tail truncation for oversized tool results."""
    if len(content) <= max_chars:
        return content
    head = max_chars * 2 // 3
    tail = max_chars - head
    return (
        content[:head]
        + f"\n... [{len(content) - max_chars} chars truncated] ...\n"
        + content[-tail:]
    )


class ContextManager:
    """Token-exact window preparation with durable compaction events.

    encode(text) must return a token count (a real tokenizer's encode; the
    reference binary-searches with the same contract, context.py:200-231).
    """

    def __init__(
        self,
        encode: Callable[[str], int],
        policy: ContextPolicy | None = None,
        summarize: Callable[[list[dict]], WorkingSummary] | None = None,
        session_log=None,
    ):
        self._encode = encode
        self.policy = policy or ContextPolicy()
        self.summarize = summarize
        self.session = session_log
        self.compactions = 0

    def _tokens(self, messages: list[dict]) -> int:
        return sum(self._encode(m["content"]) + 4 for m in messages)

    def _bound_tool_result_tokens(self, content: str) -> str:
        """TOKEN-exact head+tail truncation: binary-search the character
        budget until the truncated text measures within
        max_tool_result_tokens by the REAL encoder (reference
        context.py:200-231 uses the same encode-and-bisect contract —
        char heuristics drift badly on code and non-ASCII)."""
        budget = self.policy.max_tool_result_tokens
        if self._encode(content) <= budget:
            return content
        lo, hi = 16, len(content)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._encode(bound_tool_result(content, mid)) <= budget:
                lo = mid
            else:
                hi = mid - 1
        return bound_tool_result(content, lo)

    def prepare(self, messages: list[dict]) -> list[dict]:
        pol = self.policy
        # 1. Bound every tool result (token-exact).
        out = []
        for m in messages:
            c = m["content"]
            if c.startswith("tool_result:"):
                c = self._bound_tool_result_tokens(c)
            out.append({"role": m["role"], "content": c})
        if self._tokens(out) <= pol.input_budget:
            return out

        # 2. Compact: summarize the old turns, keep the recent ones. Every
        # attempt is durable (reference context.py:795-836) so a resumed
        # session can see WHY a compaction holds the summary it does.
        bounds = _turn_boundaries(out)
        keep_from = bounds[-pol.min_recent_turns] if len(bounds) >= pol.min_recent_turns else 0
        old, recent = out[:keep_from], out[keep_from:]
        if self.summarize is not None and old:
            try:
                summary = self.summarize(old)
                self._record_summary_attempt("model", ok=True)
            except Exception as e:
                summary = deterministic_summary(old)
                self._record_summary_attempt("model", ok=False, error=str(e))
        else:
            summary = deterministic_summary(old)
            self._record_summary_attempt("deterministic", ok=True)
        summary_text = summary.render()
        while self._encode(summary_text) > pol.max_summary_tokens:
            summary = _shrink_summary(summary)
            new_text = summary.render()
            if new_text == summary_text:
                break
            summary_text = new_text
        compacted = [
            {"role": "user", "content": "[summary of earlier work]\n" + summary_text},
            *recent,
        ]
        if self._tokens(compacted) > pol.input_budget:
            compacted = compact_messages(
                compacted, pol.input_budget * 4, pol.min_recent_turns
            )
        if self._tokens(compacted) > pol.input_budget:
            raise ContextLimitError(
                "context cannot be reduced under the input budget"
            )
        self.compactions += 1
        if self.session is not None:
            self.session.append(
                "compaction",
                {"summary": summary_text, "kept_messages": recent,
                 "dropped": len(old)},
            )
        return compacted

    def _record_summary_attempt(self, kind: str, ok: bool,
                                error: str | None = None) -> None:
        if self.session is None:
            return
        data = {"summarizer": kind, "ok": ok}
        if error is not None:
            data["error"] = error[:500]
        self.session.append("summary_attempt", data)


def model_summarizer(generate) -> Callable[[list[dict]], WorkingSummary]:
    """Build a summarizer backed by a model generation callable (the
    reference runs it in a SEPARATE GenerationSession so summarization
    never disturbs the main conversation's KV prefix; pass such a
    session's __call__ here). Falls back to the deterministic summary on
    any parse failure."""

    schema = json.dumps({k: "..." for k in SUMMARY_FIELDS})

    def summarize(messages: list[dict]) -> WorkingSummary:
        transcript = "\n".join(
            f"{m['role']}: {m['content'][:400]}" for m in messages
        )
        prompt = [
            {"role": "system",
             "content": "Summarize the work so far as ONE JSON object with "
                        f"exactly these fields: {schema}. No other text."},
            {"role": "user", "content": transcript[-8000:]},
        ]
        reply = generate(prompt)
        if isinstance(reply, tuple):
            reply = reply[0]
        try:
            return WorkingSummary.parse(reply.strip().strip("`"))
        except Exception:
            # Structured facts are always derivable from events; never let
            # a bad model summary lose them (reference context.py:648-662).
            return deterministic_summary(messages)

    return summarize


def deterministic_summary(messages: list[dict]) -> WorkingSummary:
    """Fallback summary built from the event stream without a model
    (reference context.py:589-646): goal = first user message; changed
    files and validation are derived from tool results."""
    goal = ""
    changed, validation, facts = [], [], []
    for m in messages:
        c = m["content"]
        if m["role"] == "user" and not c.startswith("tool_result:") and not goal:
            goal = c[:500]
        if c.startswith("tool_result:"):
            try:
                result = json.loads(c[len("tool_result:") :])
            except json.JSONDecodeError:
                continue
            if isinstance(result, dict):
                if "written" in result:
                    changed.append(result["written"])
                if "returncode" in result:
                    validation.append(
                        f"argv={result.get('argv')} rc={result['returncode']}"
                    )
    return WorkingSummary(
        goal=goal,
        changed_files=sorted(set(changed)),
        validation=validation[-5:],
        facts=facts,
    )


def _shrink_summary(s: WorkingSummary) -> WorkingSummary:
    """Drop the least-essential content first."""
    return WorkingSummary(
        goal=s.goal[:300],
        constraints=s.constraints[:3],
        facts=s.facts[: max(len(s.facts) // 2, 0)],
        changed_files=s.changed_files[:10],
        validation=s.validation[:3],
        failed_approaches=s.failed_approaches[:2],
        next_step=s.next_step[:200],
    )
