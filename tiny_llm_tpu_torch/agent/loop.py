"""The bounded agent loop.

The port's copy of tiny_llm_tpu/agent/loop.py (pure Python: the port
cannot import the JAX package, whose __init__ imports JAX); only its
docstrings differ.

Parity: the reference's agent/loop.py (456 LoC) —
AgentLimits, per-step pipeline (deliver steering -> prepare context ->
generate -> record -> parse -> dispatch), invalid-action and
identical-action loop detection, cancellation at named phases, and
terminal-final linearization against pending steering (a final answer is
only accepted when no steering is queued; otherwise the steering is
delivered and the loop continues).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable

from .context import ContextManager, ContextPolicy
from .control import AgentInterrupted, CancellationToken
from .protocol import (
    AgentError,
    FinalAction,
    ToolAction,
    build_system_prompt,
    parse_action,
)
from .session import SessionLog, memory_session


def estimate_tokens(text: str) -> int:
    """Conservative token estimate used when no real tokenizer is wired
    in: ~4 chars/token for prose, and never below 1. Only the fallback
    path uses this; a ContextManager built with the model's encoder is
    always token-exact."""
    return max(1, len(text) // 4)


@dataclasses.dataclass(frozen=True)
class AgentLimits:
    """All budgets derive from one token-denominated ContextPolicy
    (reference context.py:30-65) — there is no separate char budget."""

    max_steps: int = 8
    max_invalid_actions: int = 3
    max_identical_actions: int = 2
    context: ContextPolicy = dataclasses.field(default_factory=ContextPolicy)

    def __post_init__(self):
        if self.max_steps < 1 or self.max_invalid_actions < 1:
            raise ValueError("limits must be positive")


@dataclasses.dataclass
class AgentRun:
    status: str  # "final" | "step_limit" | "invalid_limit" | "loop" | "interrupted"
    final_message: str | None
    steps: int
    session: SessionLog


def run_agent(
    task: str,
    generate: Callable[[list[dict]], tuple[str, object]],
    workspace,
    limits: AgentLimits | None = None,
    session: SessionLog | None = None,
    context_manager=None,
    cancellation: CancellationToken | None = None,
    system_prompt: str | None = None,
) -> AgentRun:
    limits = limits or AgentLimits()
    session = session if session is not None else memory_session()
    cancellation = cancellation or CancellationToken()
    workspace.session = session
    workspace.cancellation = cancellation
    if workspace.journal is not None:
        workspace.journal.session = session

    if system_prompt is None:
        system_prompt = build_system_prompt(workspace.policy)

    # Crash recovery on resume: close dangling tool calls AND assistant
    # messages that never led anywhere, then add the (possibly new) task
    # (reference loop.py:171-214, session.py:497-553).
    session.recover_incomplete_turns()
    # Project instructions: snapshot the workspace's AGENTS.md once per
    # session (reference session.py:638-666).
    root = getattr(getattr(workspace, "policy", None), "root", None)
    if root is not None:
        session.snapshot_project_instructions(root)
    session.append("user_message", {"text": task})
    session.append("run_started", {"task": task})

    invalid_count = 0
    identical_count = 0
    last_signature: str | None = None
    steps = 0

    def finish(status: str, message: str | None) -> AgentRun:
        session.append(
            "run_finished", {"status": status, "message": message, "steps": steps}
        )
        return AgentRun(
            status=status, final_message=message, steps=steps, session=session
        )

    try:
        while steps < limits.max_steps:
            steps += 1
            cancellation.raise_if_cancelled("step_start")

            for text in session.deliver_pending_steering():
                pass  # delivery appends the durable events; messages() shows them

            messages = [{"role": "system", "content": system_prompt}] + session.messages()
            if context_manager is None:
                # Fallback manager: same token-denominated policy as the
                # explicit path, with an estimated encoder. Keeps every
                # budget in tokens (no parallel char-budget system).
                context_manager = ContextManager(
                    encode=estimate_tokens,
                    policy=limits.context,
                    session_log=session,
                )
            messages = [messages[0]] + context_manager.prepare(messages[1:])

            cancellation.raise_if_cancelled("generate")
            reply, stats = generate(messages)
            session.append(
                "assistant_message",
                {"text": reply, "stats": getattr(stats, "__dict__", None)},
            )

            try:
                action = parse_action(reply)
            except AgentError as e:
                invalid_count += 1
                session.append(
                    "protocol_error", {"error": str(e), "count": invalid_count}
                )
                if invalid_count >= limits.max_invalid_actions:
                    return finish("invalid_limit", None)
                session.append(
                    "user_message",
                    {"text": f"protocol error: {e}. Reply with exactly one "
                             "JSON object."},
                )
                continue

            sig = action.signature()
            if sig == last_signature:
                identical_count += 1
                if identical_count >= limits.max_identical_actions:
                    session.append("loop_detected", {"signature": sig})
                    return finish("loop", None)
            else:
                identical_count = 0
                last_signature = sig

            if isinstance(action, FinalAction):
                # Linearized terminal acceptance: a queued steering message
                # outranks the final answer (reference loop.py:358-392).
                if session.pending_steering():
                    for _ in session.deliver_pending_steering():
                        pass
                    session.append(
                        "user_message",
                        {"text": "new steering arrived; continue working"},
                    )
                    # A superseded final is a response to input the model
                    # had not seen; its next reply answers the NEW
                    # steering, so an identical final there is not a loop
                    # (reference: steering supersedes a concurrent final
                    # without tripping recovery-loop detection).
                    identical_count = 0
                    last_signature = None
                    continue

                def _accept():
                    return finish("final", action.message)

                return cancellation.run_if_active(_accept, "final")

            result = workspace.execute(action)
            # workspace.execute already appended tool_call/tool_result.
            del result
        return finish("step_limit", None)
    except AgentInterrupted as e:
        session.append("interrupted", {"reason": e.reason, "phase": e.phase})
        return AgentRun(
            status="interrupted", final_message=None, steps=steps, session=session
        )
