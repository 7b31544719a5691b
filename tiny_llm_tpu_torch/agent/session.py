"""Durable session event log + store.

The port's copy of tiny_llm_tpu/agent/session.py (pure Python: the port
cannot import the JAX package, whose __init__ imports JAX); only its
docstrings differ.

Parity: the reference's agent/session.py (append-only
fsync'd JSONL, event-chain validation, steering queue, crash recovery,
store with create/load/latest/branch, ephemeral memory sessions). Design
choices here: integer event ids forming a strict chain (id = prev + 1,
parent = prev id), flock + size revalidation around every append so a
concurrent writer is detected rather than interleaved, and load-time
truncation of a torn final line (power-loss recovery).
"""

from __future__ import annotations

import dataclasses
import fcntl
import json
import os
import secrets
import threading
import time
from typing import Any, Iterable

SESSION_DIR_NAME = ".tiny-llm-tpu/sessions"

# Event types with loop-visible semantics.
CONVERSATION_TYPES = ("user_message", "assistant_message", "tool_result")


class SessionError(Exception):
    pass


class SessionConflict(SessionError):
    """The on-disk log advanced underneath us (concurrent writer)."""


@dataclasses.dataclass(frozen=True)
class SessionEvent:
    id: int
    ts: float
    type: str
    parent: int | None
    data: dict[str, Any]

    def to_json(self) -> str:
        return json.dumps(
            {"id": self.id, "ts": self.ts, "type": self.type,
             "parent": self.parent, "data": self.data},
            ensure_ascii=False,
        )

    @staticmethod
    def from_json(line: str) -> "SessionEvent":
        obj = json.loads(line)
        return SessionEvent(
            id=int(obj["id"]),
            ts=float(obj["ts"]),
            type=str(obj["type"]),
            parent=obj["parent"],
            data=dict(obj["data"]),
        )


class SessionLog:
    """Append-only event log; path=None keeps it purely in memory."""

    def __init__(self, path: str | None, events: list[SessionEvent] | None = None):
        self.path = path
        self.events: list[SessionEvent] = list(events or [])
        self._expected_size = 0
        # In-process appends must serialize: SteeringHandle.submit is
        # documented to run from OTHER threads while the agent loop
        # appends, and the event id/parent chain is computed from
        # events[-1] before the write lands. The flock below only guards
        # cross-process writers; without this mutex two in-process
        # threads can mint the same id and corrupt the chain on disk
        # (caught by test_agent_interleavings.py
        # test_concurrent_steering_during_live_apply).
        self._append_lock = threading.Lock()
        if path is not None:
            if not os.path.exists(path):
                with open(path, "x"):
                    pass
            self._expected_size = os.path.getsize(path)

    # -- project instructions --------------------------------------------------
    MAX_INSTRUCTIONS_BYTES = 64 * 1024

    def snapshot_project_instructions(self, workspace_root: str) -> SessionEvent | None:
        """Durably snapshot the workspace's AGENTS.md into the session
        (reference session.py:638-666): the file's content at session
        start is what the model sees for the whole session, immune to
        later edits. Symlinked or oversized files are rejected; a missing
        file is a no-op. Idempotent per session."""
        import hashlib

        if any(e.type == "project_instructions" for e in self.events):
            return None
        path = os.path.join(workspace_root, "AGENTS.md")
        if os.path.islink(path):
            raise SessionError("AGENTS.md is a symlink; refusing to snapshot")
        if not os.path.isfile(path):
            return None
        size = os.path.getsize(path)
        if size > self.MAX_INSTRUCTIONS_BYTES:
            raise SessionError(
                f"AGENTS.md is {size} bytes; limit {self.MAX_INSTRUCTIONS_BYTES}"
            )
        with open(path, "rb") as f:
            data = f.read()
        return self.append(
            "project_instructions",
            {
                "path": "AGENTS.md",
                "sha256": hashlib.sha256(data).hexdigest(),
                "content": data.decode("utf-8"),
            },
        )

    def project_instructions(self) -> str | None:
        for e in self.events:
            if e.type == "project_instructions":
                return e.data["content"]
        return None

    # -- core append ---------------------------------------------------------
    def append(self, type: str, data: dict[str, Any] | None = None) -> SessionEvent:
        with self._append_lock:
            return self._append_locked(type, data)

    def _append_locked(
        self, type: str, data: dict[str, Any] | None = None
    ) -> SessionEvent:
        data = dict(data or {})
        self._validate_append(type, data)
        ev = SessionEvent(
            id=(self.events[-1].id + 1) if self.events else 0,
            ts=time.time(),
            type=type,
            parent=self.events[-1].id if self.events else None,
            data=data,
        )
        if self.path is None:
            self.events.append(ev)
            return ev
        line = ev.to_json() + "\n"
        fd = os.open(self.path, os.O_WRONLY | os.O_APPEND)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            actual = os.fstat(fd).st_size
            if actual != self._expected_size:
                raise SessionConflict(
                    f"log advanced on disk ({actual} != {self._expected_size}); "
                    "another writer owns this session"
                )
            payload = line.encode("utf-8")
            try:
                os.write(fd, payload)
                os.fsync(fd)
            except BaseException:
                # An event is only real once write+fsync BOTH succeeded.
                # Roll the file back to the validated head so the on-disk
                # log never holds an event this handle does not (a torn
                # partial write would otherwise be silently completed by
                # a later reader). Truncation failure leaves a torn tail,
                # which load() already recovers.
                try:
                    os.ftruncate(fd, actual)
                except OSError:
                    pass
                raise
            self._expected_size = actual + len(payload)
        finally:
            os.close(fd)
        self.events.append(ev)
        return ev

    def _validate_append(self, type: str, data: dict) -> None:
        if type == "tool_result":
            call_id = data.get("call_id")
            if call_id is None and data.get("recovered"):
                # Synthetic gap-closing result (recover_incomplete_turns):
                # documents a crash after an assistant message, closes no
                # tool_call.
                return
            open_calls = {e.id for e in self.events if e.type == "tool_call"}
            closed = {e.data.get("call_id") for e in self.events
                      if e.type == "tool_result"}
            if call_id not in open_calls - closed:
                raise SessionError(
                    f"tool_result must close an open tool_call (got {call_id})"
                )
        if type == "steering_delivered":
            queued = {e.id for e in self.events if e.type == "steering_queued"}
            delivered = {e.data.get("steering_id") for e in self.events
                         if e.type == "steering_delivered"}
            if data.get("steering_id") not in queued - delivered:
                raise SessionError("steering_delivered must match a queued event")

    # -- conversation view ---------------------------------------------------
    def messages(self) -> list[dict[str, str]]:
        """Rebuild the model-visible conversation from durable events.
        A snapshotted AGENTS.md leads the conversation and survives
        compaction (reference session.py:395-411)."""
        out: list[dict[str, str]] = []
        for ev in self.events:
            if ev.type == "user_message":
                out.append({"role": "user", "content": ev.data["text"]})
            elif ev.type == "assistant_message":
                out.append({"role": "assistant", "content": ev.data["text"]})
            elif ev.type == "tool_result":
                out.append(
                    {"role": "user",
                     "content": "tool_result: " + json.dumps(
                         ev.data.get("result"), ensure_ascii=False)}
                )
            elif ev.type == "steering_delivered":
                out.append({"role": "user",
                            "content": "[steering] " + ev.data["text"]})
            elif ev.type == "compaction":
                # A compaction event REPLACES everything before it with the
                # recorded summary + kept suffix (token-budget recovery).
                kept = ev.data.get("kept_messages", [])
                out = [
                    {"role": "user",
                     "content": "[summary of earlier work]\n" + ev.data["summary"]},
                    *[dict(m) for m in kept],
                ]
        instructions = self.project_instructions()
        if instructions:
            out = [
                {"role": "user",
                 "content": "[project instructions: AGENTS.md]\n" + instructions}
            ] + out
        return out

    # -- steering ------------------------------------------------------------
    def queue_steering(self, text: str) -> SessionEvent:
        return self.append("steering_queued", {"text": text})

    def pending_steering(self) -> list[SessionEvent]:
        delivered = {e.data.get("steering_id") for e in self.events
                     if e.type == "steering_delivered"}
        return [e for e in self.events
                if e.type == "steering_queued" and e.id not in delivered]

    def deliver_pending_steering(self) -> list[str]:
        texts = []
        for ev in self.pending_steering():
            self.append("steering_delivered",
                        {"steering_id": ev.id, "text": ev.data["text"]})
            texts.append(ev.data["text"])
        return texts

    # -- crash recovery ------------------------------------------------------
    def open_tool_calls(self) -> list[SessionEvent]:
        closed = {e.data.get("call_id") for e in self.events
                  if e.type == "tool_result"}
        return [e for e in self.events
                if e.type == "tool_call" and e.id not in closed]

    def recover_unmatched_tool_calls(self) -> list[SessionEvent]:
        """Close dangling tool_calls with synthetic error results
        (reference session.py:471-495). The call is never repeated — the
        prior process may or may not have executed it."""
        added = []
        for call in self.open_tool_calls():
            added.append(
                self.append(
                    "tool_result",
                    {"call_id": call.id,
                     "result": {"error": "interrupted before completion"},
                     "recovered": True},
                )
            )
        return added

    # Event types that mean "the turn proceeded past the assistant message".
    _TURN_PROGRESS_TYPES = frozenset(
        {"tool_call", "tool_result", "protocol_error", "loop_detected",
         "interrupted"}
    )

    def recover_incomplete_turns(self) -> list[SessionEvent]:
        """Close crash gaps after a durable assistant message without
        interpreting it (reference session.py:497-553): if a recorded
        model response was never followed by any action, error, or
        completed run_finished, append a synthetic error tool_result so a
        resumed conversation shows the gap instead of silently implying
        the action ran. (Deviation from the reference: a user_message
        directly after an assistant_message is NOT a gap here — this
        loop's protocol-error prompts and steering notices are durable
        user messages, so they mark the turn as handled.)"""
        recovered = list(self.recover_unmatched_tool_calls())
        events = list(self.events)
        closed = {
            e.data.get("assistant_event_id")
            for e in events
            if e.type == "tool_result" and e.data.get("assistant_event_id")
        }
        for idx, ev in enumerate(events):
            if ev.type != "assistant_message" or ev.id in closed:
                continue
            following = next(
                (c for c in events[idx + 1:]
                 if c.type in self._TURN_PROGRESS_TYPES
                 or c.type in ("assistant_message", "run_started",
                               "run_finished", "user_message")),
                None,
            )
            is_gap = (
                following is None
                or following.type in ("assistant_message", "run_started")
                or (following.type == "run_finished"
                    and following.data.get("status") != "final")
            )
            if is_gap:
                recovered.append(
                    self.append(
                        "tool_result",
                        {"call_id": None,
                         "assistant_event_id": ev.id,
                         "result": {"error":
                             "the prior process stopped after recording a "
                             "model response; no action from it was repeated"},
                         "recovered": True},
                    )
                )
        return recovered

    # -- loading -------------------------------------------------------------
    @staticmethod
    def _parse_chain(raw: bytes) -> tuple[list[SessionEvent], int]:
        """Parse the longest valid event-chain prefix; returns
        (events, byte offset of the first torn/absent line)."""
        events: list[SessionEvent] = []
        good_offset = 0
        offset = 0
        for line in raw.split(b"\n"):
            if not line:
                offset += 1
                continue
            try:
                ev = SessionEvent.from_json(line.decode("utf-8"))
            except (json.JSONDecodeError, KeyError, UnicodeDecodeError, ValueError):
                break  # torn tail — truncate here
            expected_id = events[-1].id + 1 if events else 0
            expected_parent = events[-1].id if events else None
            if ev.id != expected_id or ev.parent != expected_parent:
                raise SessionError(
                    f"event chain broken at id {ev.id} "
                    f"(expected id {expected_id} parent {expected_parent})"
                )
            events.append(ev)
            offset += len(line) + 1
            good_offset = offset
        return events, good_offset

    @staticmethod
    def load(path: str) -> "SessionLog":
        """Load a log, truncating a torn final line and validating the
        id/parent chain (partial-tail recovery, session.py:870-918).

        The read happens under a SHARED flock: append() commits events
        under LOCK_EX (write+fsync), so an unlocked reader racing a
        cross-process appender could observe a half-written line and
        "recover" it as a torn tail — TRUNCATING an event the writer
        already fsync'd (round-5 multi-process hardening; the
        multiprocess suite hammers this interleaving). Truncation of a
        genuinely torn tail re-reads under LOCK_EX so the verdict is
        reached on bytes no live writer is mid-way through."""
        with open(path, "rb") as f:
            fcntl.flock(f.fileno(), fcntl.LOCK_SH)
            try:
                raw = f.read()
            finally:
                fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        events, good_offset = SessionLog._parse_chain(raw)
        if good_offset < len(raw):
            # Torn tail observed. Re-verify under the exclusive lock (a
            # concurrent writer may have been mid-append) and truncate
            # only what is STILL torn with every writer excluded.
            with open(path, "r+b") as f:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                try:
                    f.seek(0)
                    raw = f.read()
                    events, good_offset = SessionLog._parse_chain(raw)
                    if good_offset < len(raw):
                        f.truncate(good_offset)
                finally:
                    fcntl.flock(f.fileno(), fcntl.LOCK_UN)
        SessionLog._validate_links(events)
        log = SessionLog.__new__(SessionLog)
        log.path = path
        log.events = events
        log._expected_size = good_offset
        log._append_lock = threading.Lock()
        return log

    @staticmethod
    def _validate_links(events: list[SessionEvent]) -> None:
        """Semantic cross-link validation for a LOADED event list.

        The id/parent chain proves byte-level integrity; this proves the
        link structure the runtime relies on: every tool_result closes a
        then-open tool_call, every steering_delivered matches a
        then-queued, not-yet-delivered steering event. A chain-valid log
        violating these is corruption or tampering and fails closed
        (reference analog: the day-6 load_rejects_out_of_order_and_
        duplicate_{steering,assistant}_links family)."""
        open_calls: set[int] = set()
        queued: set[int] = set()
        delivered: set[int] = set()
        for ev in events:
            if ev.type == "tool_call":
                open_calls.add(ev.id)
            elif ev.type == "tool_result":
                call_id = ev.data.get("call_id")
                if call_id is None and ev.data.get("recovered"):
                    continue  # synthetic gap-closing result
                if call_id not in open_calls:
                    raise SessionError(
                        f"loaded tool_result {ev.id} does not close an "
                        f"open tool_call (call_id {call_id})"
                    )
                open_calls.discard(call_id)
            elif ev.type == "steering_queued":
                queued.add(ev.id)
            elif ev.type == "steering_delivered":
                sid = ev.data.get("steering_id")
                if sid not in queued or sid in delivered:
                    raise SessionError(
                        f"loaded steering_delivered {ev.id} does not match "
                        f"a queued, undelivered steering event (id {sid})"
                    )
                delivered.add(sid)


def memory_session() -> SessionLog:
    """Ephemeral log (reference memory_session, session.py:1265-1277)."""
    return SessionLog(None)


class SessionStore:
    """Per-workspace session directory with atomic publication.

    Parity: reference SessionStore (session.py:668-1262): 0700 dir,
    create via temp+rename, latest-resume, validated branch copies.
    """

    def __init__(self, workspace_root: str):
        self.dir = os.path.join(workspace_root, SESSION_DIR_NAME)
        os.makedirs(self.dir, mode=0o700, exist_ok=True)

    def _path(self, session_id: str) -> str:
        if "/" in session_id or session_id.startswith("."):
            raise SessionError(f"invalid session id {session_id!r}")
        return os.path.join(self.dir, session_id + ".jsonl")

    def create(self, meta: dict | None = None) -> SessionLog:
        # The nanosecond field keeps lexicographic order == creation order
        # even for sessions created within the same wall-clock second, so
        # latest() resumes the right lineage.
        session_id = (
            f"{time.strftime('%Y%m%d-%H%M%S')}-{time.time_ns():019d}"
            f"-{secrets.token_hex(4)}"
        )
        tmp = os.path.join(self.dir, f".tmp-{session_id}")
        header = SessionEvent(
            id=0, ts=time.time(), type="session_created",
            parent=None, data={"session_id": session_id, **(meta or {})},
        )
        with open(tmp, "x") as f:
            f.write(header.to_json() + "\n")
            f.flush()
            os.fsync(f.fileno())
        final = self._path(session_id)
        os.rename(tmp, final)
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        return SessionLog.load(final)

    def list(self) -> list[str]:
        return sorted(
            n[: -len(".jsonl")]
            for n in os.listdir(self.dir)
            if n.endswith(".jsonl") and not n.startswith(".")
        )

    def load(self, session_id: str) -> SessionLog:
        path = self._path(session_id)
        if not os.path.exists(path):
            raise SessionError(f"no such session {session_id!r}")
        return SessionLog.load(path)

    def latest(self) -> SessionLog | None:
        ids = self.list()
        return self.load(ids[-1]) if ids else None

    def session_id(self, log: SessionLog) -> str:
        assert log.path is not None
        return os.path.basename(log.path)[: -len(".jsonl")]

    def branch(self, session_id: str, upto_event_id: int) -> SessionLog:
        """Copy a validated prefix into a new session lineage
        (reference session.py:996-1200). The cut must land on a safe
        boundary: no tool_call left open by the prefix."""
        src = self.load(session_id)
        prefix = [e for e in src.events if e.id <= upto_event_id]
        if not prefix:
            raise SessionError("branch point precedes the first event")
        closed = {e.data.get("call_id") for e in prefix if e.type == "tool_result"}
        for e in prefix:
            if e.type == "tool_call" and e.id not in closed:
                raise SessionError(
                    f"branch point leaves tool_call {e.id} open; "
                    "choose a boundary after its tool_result"
                )
        new = self.create({"branched_from": session_id,
                           "branch_point": upto_event_id})
        for e in prefix:
            if e.type == "session_created":
                continue
            new.append(e.type, e.data)
        return new
