"""Agent action protocol: strict one-JSON-object parsing.

The port's copy of tiny_llm_tpu/agent/protocol.py (pure Python: the port
cannot import the JAX package, whose __init__ imports JAX); only its
docstrings differ.

Parity: the reference's agent/protocol.py:1-128. The
model must reply with exactly one JSON object — either a final answer or
one tool call with an exact field set. Anything else (prose around the
object, unknown tools, missing/extra fields, wrong types) is an
AgentError the loop feeds back as a correction.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

# tool name -> (required fields, optional fields) with expected types.
TOOL_FIELDS: dict[str, tuple[dict[str, type], dict[str, type]]] = {
    "list_files": ({"path": str}, {}),
    "read_file": ({"path": str}, {}),
    "write_file": ({"path": str, "content": str}, {}),
    "edit_file": ({"path": str, "old": str, "new": str}, {}),
    "run_command": ({"argv": list}, {}),
}

SIDE_EFFECT_TOOLS = frozenset({"write_file", "edit_file", "run_command"})


class AgentError(Exception):
    """Protocol violation; the message is shown to the model verbatim."""


@dataclasses.dataclass(frozen=True)
class FinalAction:
    message: str

    def signature(self) -> str:
        return f"final:{self.message}"


@dataclasses.dataclass(frozen=True)
class ToolAction:
    tool: str
    args: dict[str, Any]

    def signature(self) -> str:
        return f"tool:{self.tool}:{json.dumps(self.args, sort_keys=True)}"

    @property
    def has_side_effects(self) -> bool:
        return self.tool in SIDE_EFFECT_TOOLS


def _extract_json_object(text: str) -> dict:
    """Accept exactly one JSON object, optionally inside a ```json fence."""
    stripped = text.strip()
    if stripped.startswith("```"):
        lines = stripped.splitlines()
        if lines and lines[0].startswith("```"):
            lines = lines[1:]
        if lines and lines[-1].strip() == "```":
            lines = lines[:-1]
        stripped = "\n".join(lines).strip()
    try:
        decoder = json.JSONDecoder()
        obj, end = decoder.raw_decode(stripped)
    except json.JSONDecodeError as e:
        raise AgentError(f"reply is not a JSON object: {e}") from None
    if stripped[end:].strip():
        raise AgentError("reply must contain exactly one JSON object, nothing else")
    if not isinstance(obj, dict):
        raise AgentError("reply must be a JSON object")
    return obj


def parse_action(text: str) -> FinalAction | ToolAction:
    obj = _extract_json_object(text)
    kind = obj.get("type")
    if kind == "final":
        extra = set(obj) - {"type", "message"}
        if extra:
            raise AgentError(f"final action has unknown fields: {sorted(extra)}")
        message = obj.get("message")
        if not isinstance(message, str):
            raise AgentError('final action needs a string "message" field')
        return FinalAction(message=message)
    if kind == "tool":
        tool = obj.get("tool")
        if tool not in TOOL_FIELDS:
            raise AgentError(
                f"unknown tool {tool!r}; available: {sorted(TOOL_FIELDS)}"
            )
        required, optional = TOOL_FIELDS[tool]
        fields = {k: v for k, v in obj.items() if k not in ("type", "tool")}
        for name, typ in required.items():
            if name not in fields:
                raise AgentError(f"tool {tool!r} requires field {name!r}")
            if not isinstance(fields[name], typ):
                raise AgentError(f"field {name!r} of {tool!r} must be {typ.__name__}")
        for name in fields:
            if name not in required and name not in optional:
                raise AgentError(f"tool {tool!r} has unknown field {name!r}")
        if tool == "run_command":
            argv = fields["argv"]
            if not argv or not all(isinstance(a, str) for a in argv):
                raise AgentError('"argv" must be a non-empty list of strings')
        return ToolAction(tool=tool, args=fields)
    raise AgentError('reply must set "type" to "final" or "tool"')


def build_system_prompt(policy, extra_instructions: str | None = None) -> str:
    """Policy-aware system prompt (reference protocol.py:96-128)."""
    cmd_lines = (
        "\n".join(f"  - {' '.join(c)}" for c in policy.allowed_commands)
        if policy.allowed_commands
        else "  (none allowed)"
    )
    writes = "enabled" if policy.allow_writes else "DISABLED (read-only)"
    parts = [
        "You are a coding agent operating on one project workspace.",
        "Reply with EXACTLY ONE JSON object per turn and nothing else.",
        'Finish with: {"type": "final", "message": "<answer>"}',
        "Or call one tool:",
        '  {"type": "tool", "tool": "list_files", "path": "<dir>"}',
        '  {"type": "tool", "tool": "read_file", "path": "<file>"}',
        '  {"type": "tool", "tool": "write_file", "path": "<file>", "content": "<text>"}',
        '  {"type": "tool", "tool": "edit_file", "path": "<file>", "old": "<unique text>", "new": "<text>"}',
        '  {"type": "tool", "tool": "run_command", "argv": ["cmd", "arg", ...]}',
        "Paths are relative to the workspace root; absolute paths and '..' are rejected.",
        f"File writes are {writes}. Read a file before writing or editing it.",
        "Allowed commands (exact argv prefixes):",
        cmd_lines,
    ]
    if extra_instructions:
        parts.append("Project instructions:\n" + extra_instructions)
    return "\n".join(parts)
