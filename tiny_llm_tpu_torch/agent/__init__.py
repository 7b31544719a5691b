"""Coding-agent subsystem of the port (counterpart of tiny_llm_tpu/agent).

Capability parity with the reference's agent — strict action protocol,
bounded agent loop, KV-prefix-reuse generation sessions, sandboxed
workspace tools, durable JSONL session logs with crash recovery,
token-budget context management, a write-ahead mutation journal with
checkpoint/undo, and a sealed-task evaluation harness. Model-agnostic:
only generation.py touches the port's model and KV caches. Every module
but generation.py is a copy of the JAX package's, which the port cannot
import (tiny_llm_tpu/__init__.py imports JAX).
"""

from .protocol import (
    AgentError,
    FinalAction,
    ToolAction,
    build_system_prompt,
    parse_action,
)
from .control import AgentInterrupted, CancellationToken, SteeringHandle
from .session import SessionEvent, SessionLog, SessionStore, memory_session
from .workspace import ToolPolicy, Workspace
from .generation import GenerationSession, GenerationStats
from .context import ContextManager, ContextPolicy, WorkingSummary, compact_messages
from .recovery import Checkpoint, MutationJournal, UndoPlan
from .loop import AgentLimits, AgentRun, run_agent
from .evaluation import (
    EvaluationMetrics,
    StagedTask,
    StaticHeldOutGrader,
    TaskPackage,
    evaluate_task,
)

__all__ = [
    "AgentError",
    "FinalAction",
    "ToolAction",
    "build_system_prompt",
    "parse_action",
    "AgentInterrupted",
    "CancellationToken",
    "SteeringHandle",
    "SessionEvent",
    "SessionLog",
    "SessionStore",
    "memory_session",
    "ToolPolicy",
    "Workspace",
    "GenerationSession",
    "GenerationStats",
    "ContextManager",
    "ContextPolicy",
    "WorkingSummary",
    "compact_messages",
    "Checkpoint",
    "MutationJournal",
    "UndoPlan",
    "AgentLimits",
    "AgentRun",
    "run_agent",
    "EvaluationMetrics",
    "StagedTask",
    "StaticHeldOutGrader",
    "TaskPackage",
    "evaluate_task",
]
