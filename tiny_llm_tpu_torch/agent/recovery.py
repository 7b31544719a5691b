"""Write-ahead mutation journal + checkpoint/undo.

The port's copy of tiny_llm_tpu/agent/recovery.py (pure Python: the port
cannot import the JAX package, whose __init__ imports JAX); only its
docstrings differ.

Parity: the reference's agent/recovery.py (2055 LoC) —
the invariants preserved:

* WAL ordering: the intent event (with the before-image) is fsync'd into
  the session log BEFORE the file write happens; commit is recorded after
  verifying the after-fingerprint.
* recover_pending classifies interrupted intents (committed / not_applied
  / conflict) purely by hashing, never touching files.
* Undo restores the before-images of committed writes since a named
  checkpoint, refuses when current state no longer matches the plan's
  fingerprints, and journals its own restores (undo is itself redoable).
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import os
from typing import Any

MAX_BEFORE_IMAGE = 64 * 1024


class RecoveryError(Exception):
    pass


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _encode_content(data: bytes) -> dict:
    try:
        return {"text": data.decode("utf-8")}
    except UnicodeDecodeError:
        return {"b64": base64.b64encode(data).decode("ascii")}


def _decode_content(obj: dict) -> bytes:
    if "text" in obj:
        return obj["text"].encode("utf-8")
    return base64.b64decode(obj["b64"])


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    event_id: int
    name: str


@dataclasses.dataclass(frozen=True)
class PlannedRestore:
    path: str  # workspace-relative
    before_exists: bool
    before_content: dict | None  # encoded; None if too large to restore
    before_digest: str | None
    expected_current_digest: str | None  # None = file absent now


@dataclasses.dataclass(frozen=True)
class UndoPlan:
    checkpoint_id: int
    restores: tuple[PlannedRestore, ...]
    warnings: tuple[str, ...]

    def fingerprint(self) -> str:
        h = hashlib.sha256()
        for r in self.restores:
            h.update(
                f"{r.path}|{r.before_digest}|{r.expected_current_digest}".encode()
            )
        return h.hexdigest()


class MutationJournal:
    def __init__(self, session_log, root: str):
        self.session = session_log
        self.root = os.path.realpath(root)

    def _rel(self, path: str) -> str:
        return os.path.relpath(os.path.realpath(
            os.path.join(self.root, path) if not os.path.isabs(path) else path
        ), self.root)

    # -- WAL -----------------------------------------------------------------
    def record_intent(self, path: str, after_bytes: bytes):
        """Durably record the before-image BEFORE the caller writes."""
        rel = self._rel(path)
        full = os.path.join(self.root, rel)
        if os.path.exists(full):
            with open(full, "rb") as f:
                before = f.read()
            data: dict[str, Any] = {
                "path": rel,
                "before_exists": True,
                "before_digest": _digest(before),
                "mode": os.stat(full).st_mode & 0o777,
            }
            if len(before) <= MAX_BEFORE_IMAGE:
                data["before_content"] = _encode_content(before)
        else:
            data = {"path": rel, "before_exists": False, "before_digest": None}
        data["after_digest"] = _digest(after_bytes)
        return self.session.append("mutation_intent", data)

    def commit(self, intent_event) -> None:
        """Verify the write landed, then durably mark it committed."""
        rel = intent_event.data["path"]
        full = os.path.join(self.root, rel)
        with open(full, "rb") as f:
            current = _digest(f.read())
        if current != intent_event.data["after_digest"]:
            raise RecoveryError(
                f"commit fingerprint mismatch for {rel!r}: file does not "
                "hold the intended content"
            )
        self.session.append("mutation_committed", {"intent_id": intent_event.id})

    # -- recovery ------------------------------------------------------------
    def _committed_ids(self) -> set[int]:
        return {
            e.data["intent_id"]
            for e in self.session.events
            if e.type == "mutation_committed"
        }

    def pending_intents(self) -> list:
        committed = self._committed_ids()
        return [
            e for e in self.session.events
            if e.type == "mutation_intent" and e.id not in committed
        ]

    def recover_pending(self) -> list[dict]:
        """Classify interrupted intents without touching any file
        (reference recovery.py:267-306)."""
        results = []
        for intent in self.pending_intents():
            rel = intent.data["path"]
            full = os.path.join(self.root, rel)
            if os.path.exists(full):
                with open(full, "rb") as f:
                    cur = _digest(f.read())
            else:
                cur = None
            if cur == intent.data["after_digest"]:
                status = "committed"
            elif cur == intent.data["before_digest"] or (
                cur is None and not intent.data["before_exists"]
            ):
                status = "not_applied"
            else:
                status = "conflict"
            self.session.append(
                "mutation_recovered", {"intent_id": intent.id, "status": status}
            )
            results.append({"intent_id": intent.id, "path": rel, "status": status})
        return results

    # -- checkpoints / undo --------------------------------------------------
    def create_checkpoint(self, name: str) -> Checkpoint:
        ev = self.session.append("checkpoint", {"name": name})
        return Checkpoint(event_id=ev.id, name=name)

    def checkpoints(self) -> list[Checkpoint]:
        return [
            Checkpoint(event_id=e.id, name=e.data["name"])
            for e in self.session.events
            if e.type == "checkpoint"
        ]

    def plan_undo(self, checkpoint: Checkpoint) -> UndoPlan:
        """Collapse committed post-checkpoint writes per path into the
        oldest before-image (reference recovery.py:347-424)."""
        committed = self._committed_ids()
        warnings: list[str] = []
        first_intent: dict[str, Any] = {}
        last_after: dict[str, str] = {}
        for e in self.session.events:
            if e.id <= checkpoint.event_id:
                continue
            if e.type == "command_started":
                warnings.append(
                    f"command ran after checkpoint: {e.data.get('argv')}"
                )
            if e.type == "mutation_intent" and e.id in committed:
                rel = e.data["path"]
                if rel not in first_intent:
                    first_intent[rel] = e.data
                last_after[rel] = e.data["after_digest"]
        restores = []
        for rel, data in first_intent.items():
            full = os.path.join(self.root, rel)
            if os.path.exists(full):
                with open(full, "rb") as f:
                    cur = _digest(f.read())
            else:
                cur = None
            if cur != last_after[rel]:
                warnings.append(
                    f"{rel!r} was modified outside the journal since its "
                    "last committed write"
                )
            if data["before_exists"] and "before_content" not in data:
                warnings.append(
                    f"{rel!r} before-image exceeded {MAX_BEFORE_IMAGE} bytes; "
                    "cannot restore it"
                )
                continue
            restores.append(
                PlannedRestore(
                    path=rel,
                    before_exists=data["before_exists"],
                    before_content=data.get("before_content"),
                    before_digest=data["before_digest"],
                    expected_current_digest=cur,
                )
            )
        return UndoPlan(
            checkpoint_id=checkpoint.event_id,
            restores=tuple(restores),
            warnings=tuple(warnings),
        )

    # -- applying / resuming undo ---------------------------------------------
    def _has_interrupted_undo(self, plan: UndoPlan) -> bool:
        """True when the log shows an undo of THIS plan that started but
        never reached its undo_finished event (crash mid-undo)."""
        open_attempt = False
        fp = plan.fingerprint()
        for e in self.session.events:
            if e.type == "undo_started" and e.data.get("fingerprint") == fp:
                open_attempt = True
            elif e.type == "undo_finished" and e.data.get("fingerprint") == fp:
                open_attempt = False
        return open_attempt

    def _restore_result_digest(self, r: PlannedRestore) -> str | None:
        """Digest the file should hold AFTER this change is applied
        (None = the file should be absent)."""
        return r.before_digest if r.before_exists else None

    def _reconcile_undo_changes(
        self, plan: UndoPlan
    ) -> tuple[dict[str, str], list[str]]:
        """Resolve per-change WAL events of an interrupted undo of this
        plan WITHOUT replaying or clobbering anything (reference
        recovery.py:853-1030).

        Every change the undo applies is bracketed by durable
        undo_change_started / undo_change_finished events carrying a
        change_id and the plan fingerprint.  A crash can leave a change
        in exactly three states, distinguishable by hashing:

        * started + finished          -> applied (verify it still holds)
        * started, file == result     -> applied but unjournaled; close it
          durably with undo_change_recovered(status="applied")
        * started, file == expected   -> not applied; record and redo
        * started, file == neither    -> conflict; record, never touch

        Returns (completed: path -> operation, conflicts).  Raises
        RecoveryError when the event stream is internally inconsistent
        (that indicates log tampering or a software bug, not a crash).
        """
        fp = plan.fingerprint()
        by_path = {r.path: r for r in plan.restores}
        starts: dict[str, tuple[str, str]] = {}  # change_id -> (path, op)
        resolved: dict[str, str] = {}  # change_id -> outcome
        for e in self.session.events:
            if e.type == "undo_change_started":
                if e.data.get("fingerprint") != fp:
                    continue
                cid = e.data.get("change_id")
                path = e.data.get("path")
                if not isinstance(cid, str) or cid in starts:
                    raise RecoveryError("undo change start event is invalid")
                if path not in by_path:
                    raise RecoveryError(
                        f"undo change start for {path!r} is not in the plan"
                    )
                r = by_path[path]
                op = "restore" if r.before_exists else "remove"
                if (
                    e.data.get("operation") != op
                    or e.data.get("expected_current") != r.expected_current_digest
                    or e.data.get("result_digest") != self._restore_result_digest(r)
                ):
                    raise RecoveryError(
                        f"undo change start for {path!r} does not match the plan"
                    )
                starts[cid] = (path, op)
            elif e.type in ("undo_change_finished", "undo_change_recovered"):
                cid = e.data.get("change_id")
                if cid is None:
                    continue  # other plan / other schema
                if cid not in starts:
                    if e.data.get("fingerprint") == fp:
                        raise RecoveryError("undo change resolution without a start")
                    continue
                if cid in resolved:
                    raise RecoveryError("undo change resolved twice")
                path, op = starts[cid]
                if e.data.get("path") != path:
                    raise RecoveryError("undo change resolution path mismatch")
                if e.type == "undo_change_finished":
                    resolved[cid] = "applied"
                else:
                    status = e.data.get("status")
                    if status not in ("applied", "not_applied", "conflict"):
                        raise RecoveryError("undo recovery status is invalid")
                    resolved[cid] = status

        completed: dict[str, str] = {}
        conflicts: list[str] = []
        for cid, (path, op) in starts.items():
            r = by_path[path]
            full = os.path.join(self.root, path)
            cur = self._current_digest(full)
            result = self._restore_result_digest(r)
            outcome = resolved.get(cid)
            if outcome == "applied":
                if cur == result:
                    completed[path] = op
                else:
                    conflicts.append(path)
                continue
            if outcome == "conflict":
                conflicts.append(path)
                continue
            if outcome == "not_applied":
                continue  # will be redone
            # Unresolved: the crash hit between started and finished.
            if cur == result:
                # Applied but unjournaled: close it durably.
                self.session.append(
                    "undo_change_recovered",
                    {"change_id": cid, "fingerprint": fp, "path": path,
                     "operation": op, "status": "applied"},
                )
                completed[path] = op
            elif cur == r.expected_current_digest:
                self.session.append(
                    "undo_change_recovered",
                    {"change_id": cid, "fingerprint": fp, "path": path,
                     "operation": op, "status": "not_applied"},
                )
            else:
                self.session.append(
                    "undo_change_recovered",
                    {"change_id": cid, "fingerprint": fp, "path": path,
                     "operation": op, "status": "conflict"},
                )
                conflicts.append(path)
        return completed, conflicts

    def _current_digest(self, full: str) -> str | None:
        if not os.path.exists(full):
            return None
        with open(full, "rb") as f:
            return _digest(f.read())

    def _quarantine(self, full: str, rel: str) -> str:
        """Preserve unexpected content instead of destroying it
        (reference _remove_exact, recovery.py:1708-2055): the file moves
        into a quarantine dir and the caller's removal proceeds."""
        qdir = os.path.join(self.root, ".tiny-llm-tpu", "quarantine")
        os.makedirs(qdir, mode=0o700, exist_ok=True)
        dest = os.path.join(
            qdir, f"{rel.replace(os.sep, '_')}.{os.getpid()}.{len(os.listdir(qdir))}"
        )
        os.replace(full, dest)
        return dest

    def _remove_exact(self, full: str, rel: str, expected: str | None) -> str | None:
        """Remove `full` only if it still holds the expected content;
        unexpected content is quarantined, never destroyed. Returns the
        quarantine destination when content was preserved."""
        cur = self._current_digest(full)
        if cur is None:
            return None
        if expected is not None and cur != expected:
            dest = self._quarantine(full, rel)
            self.session.append(
                "undo_quarantined", {"path": rel, "moved_to": dest}
            )
            return dest
        os.unlink(full)
        return None

    def _restore_exact(self, full: str, content: bytes) -> None:
        tmp = full + f".undo-{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, full)

    def apply_undo(self, plan: UndoPlan, confirm=None) -> dict:
        """Apply a plan with per-change WAL events so undo is itself
        crash-recoverable (reference recovery.py:547-763).

        Order of operations per change: recheck the current fingerprint,
        durably append undo_change_started (change_id + plan
        fingerprint + expected/result digests), perform the restore or
        identity-checked removal, durably append undo_change_finished.
        A crash at any point is reconciled by `_reconcile_undo_changes`
        on the next apply of the same plan.

        A fresh apply refuses wholesale when any file drifted since the
        plan was computed (the plan is stale — recompute it).  A RESUMED
        apply instead classifies each previously started change by state
        and only redoes the not-applied ones; files touched outside the
        undo become per-change conflicts, never silently clobbered.
        """
        if confirm is not None and not confirm(plan):
            return {"applied": 0, "status": "rejected"}
        fp = plan.fingerprint()
        resuming = self._has_interrupted_undo(plan)
        if resuming:
            completed, conflicts = self._reconcile_undo_changes(plan)
        else:
            completed, conflicts = {}, []

        # Preflight the changes that remain to be applied.
        remaining: list[PlannedRestore] = []
        for r in plan.restores:
            if r.path in completed or r.path in conflicts:
                continue
            cur = self._current_digest(os.path.join(self.root, r.path))
            if cur != r.expected_current_digest:
                if resuming and cur == self._restore_result_digest(r):
                    # Applied before any per-change event could be
                    # written — possible only for plans replayed against
                    # logs from older sessions; close it durably.
                    self.session.append(
                        "undo_change_recovered",
                        {"change_id": None, "fingerprint": fp, "path": r.path,
                         "operation": "restore" if r.before_exists else "remove",
                         "status": "applied"},
                    )
                    completed[r.path] = "restore" if r.before_exists else "remove"
                    continue
                if resuming:
                    conflicts.append(r.path)
                    continue
                raise RecoveryError(
                    f"{r.path!r} changed since the undo plan was computed"
                )
            remaining.append(r)

        self.session.append(
            "undo_started",
            {"checkpoint_id": plan.checkpoint_id, "fingerprint": fp,
             "paths": [r.path for r in remaining], "resumed": resuming},
        )
        applied = 0
        restored: list[str] = []
        removed: list[str] = []
        quarantined: list[str] = []
        for r in remaining:
            full = os.path.join(self.root, r.path)
            op = "restore" if r.before_exists else "remove"
            # Last-moment recheck: anything that slipped in between the
            # preflight and this change is a conflict, not a casualty.
            if self._current_digest(full) != r.expected_current_digest:
                conflicts.append(r.path)
                continue
            change_id = os.urandom(16).hex()
            self.session.append(
                "undo_change_started",
                {"change_id": change_id, "fingerprint": fp, "path": r.path,
                 "operation": op,
                 "expected_current": r.expected_current_digest,
                 "result_digest": self._restore_result_digest(r)},
            )
            if r.before_exists:
                content = _decode_content(r.before_content)
                intent = self.record_intent(full, content)
                self._restore_exact(full, content)
                self.commit(intent)
                restored.append(r.path)
            else:
                q = self._remove_exact(full, r.path, r.expected_current_digest)
                if q is not None:
                    quarantined.append(q)
                removed.append(r.path)
            self.session.append(
                "undo_change_finished",
                {"change_id": change_id, "fingerprint": fp, "path": r.path,
                 "operation": op},
            )
            applied += 1
        self.session.append(
            "undo_finished",
            {"checkpoint_id": plan.checkpoint_id, "fingerprint": fp,
             "applied": applied, "restored": restored, "removed": removed,
             "conflicts": list(dict.fromkeys(conflicts)),
             "quarantined": quarantined, "resumed": resuming},
        )
        return {
            "applied": applied,
            "skipped": len(completed),
            "status": "resumed" if resuming else "ok",
            "restored": restored,
            "removed": removed,
            "conflicts": list(dict.fromkeys(conflicts)),
            "quarantined": quarantined,
            "warnings": list(plan.warnings),
        }
