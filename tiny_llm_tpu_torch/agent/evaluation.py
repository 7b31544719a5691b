"""Sealed task packages + static held-out grading.

The port's copy of tiny_llm_tpu/agent/evaluation.py (pure Python: the port
cannot import the JAX package, whose __init__ imports JAX); only its
docstrings differ.

Parity: the reference's agent/evaluation.py (1578 LoC) —
task packages (task.json + workspace/ + held_out_tests/checks.json),
hardened staging into a fresh directory, post-run snapshots, check types
(path_exists / path_absent / unchanged / text_equals / json_value /
python_constant), editable-paths enforcement, metrics reconstructed from
durable session events, and the evaluate_task orchestration.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from typing import Any

MAX_TREE_FILES = 500
MAX_FILE_BYTES = 1 * 1024 * 1024
MAX_DEPTH = 12

CHECK_TYPES = (
    "path_exists",
    "path_absent",
    "unchanged",
    "text_equals",
    "json_value",
    "python_constant",
)


class EvaluationError(Exception):
    pass


def _walk_tree(root: str, sealed: bool = False) -> dict[str, bytes]:
    """Hardened workspace walk: no symlinks, no protected dirs, bounded
    size/count/depth (reference evaluation.py:178-344).

    sealed=True (package staging) REJECTS embedded VCS metadata instead
    of silently skipping it: a task package carrying a .git tree is not
    inert — clones/checkouts could smuggle evaluator-visible state
    (reference test class: packages are sealed inert trees). Candidate
    freezes keep the lenient skip: an agent creating dotfiles mid-run
    is a graded behavior, not a package defect."""
    out: dict[str, bytes] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        depth = 0 if rel_dir == "." else rel_dir.count(os.sep) + 1
        if depth > MAX_DEPTH:
            raise EvaluationError(f"tree deeper than {MAX_DEPTH}: {rel_dir}")
        if sealed and ".git" in dirnames:
            raise EvaluationError(
                f"package workspace embeds VCS metadata: "
                f"{os.path.join(rel_dir, '.git')}"
            )
        dirnames[:] = [
            d for d in sorted(dirnames)
            if not d.startswith(".") and not os.path.islink(os.path.join(dirpath, d))
        ]
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            if os.path.islink(full) or not os.path.isfile(full):
                continue
            if name.startswith("."):
                continue
            size = os.path.getsize(full)
            if size > MAX_FILE_BYTES:
                raise EvaluationError(f"file too large: {full}")
            with open(full, "rb") as f:
                data = f.read()
            if os.path.getsize(full) != size:
                raise EvaluationError(f"unstable read: {full}")
            rel = os.path.normpath(os.path.join(rel_dir, name)) if rel_dir != "." else name
            out[rel] = data
            if len(out) > MAX_TREE_FILES:
                raise EvaluationError(f"more than {MAX_TREE_FILES} files")
    return out


@dataclasses.dataclass(frozen=True)
class TaskPackage:
    """On-disk layout: task.json, workspace/, held_out_tests/checks.json."""

    root: str
    task_id: str
    instructions: str
    editable_paths: tuple[str, ...]
    checks: tuple[dict, ...]

    @staticmethod
    def load(root: str) -> "TaskPackage":
        with open(os.path.join(root, "task.json")) as f:
            manifest = json.load(f)
        checks_path = os.path.join(root, "held_out_tests", "checks.json")
        with open(checks_path) as f:
            checks = json.load(f)
        if not isinstance(checks, list):
            raise EvaluationError("checks.json must be a list")
        for c in checks:
            if c.get("type") not in CHECK_TYPES:
                raise EvaluationError(f"unknown check type {c.get('type')!r}")
        if not os.path.isdir(os.path.join(root, "workspace")):
            raise EvaluationError("package lacks workspace/")
        return TaskPackage(
            root=root,
            task_id=str(manifest["id"]),
            instructions=str(manifest["instructions"]),
            editable_paths=tuple(manifest.get("editable_paths", [])),
            checks=tuple(checks),
        )


@dataclasses.dataclass
class StagedTask:
    package: TaskPackage
    workdir: str
    original: dict[str, bytes]

    @staticmethod
    def stage(package: TaskPackage, workdir: str | None = None) -> "StagedTask":
        """Copy the package workspace byte-exact into a fresh directory."""
        src = os.path.join(package.root, "workspace")
        original = _walk_tree(src, sealed=True)
        workdir = workdir or tempfile.mkdtemp(prefix=f"task-{package.task_id}-")
        for rel, data in original.items():
            dst = os.path.join(workdir, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with open(dst, "wb") as f:
                f.write(data)
        return StagedTask(package=package, workdir=workdir, original=original)

    def freeze(self) -> "CandidateSnapshot":
        return CandidateSnapshot(files=_walk_tree(self.workdir))


@dataclasses.dataclass
class CandidateSnapshot:
    files: dict[str, bytes]

    @property
    def tree_hash(self) -> str:
        """Order-independent digest of (path, bytes): two snapshots with
        the same hash grade identically (grade() is a pure function of
        the snapshot — pinned by the determinism tests)."""
        import hashlib

        h = hashlib.sha256()
        for rel in sorted(self.files):
            h.update(rel.encode("utf-8"))
            h.update(b"\0")
            h.update(hashlib.sha256(self.files[rel]).digest())
        return h.hexdigest()


@dataclasses.dataclass
class CheckResult:
    check: dict
    passed: bool
    detail: str = ""


def _json_pointer(obj: Any, pointer: str) -> Any:
    if pointer in ("", "/"):
        return obj
    for part in pointer.lstrip("/").split("/"):
        part = part.replace("~1", "/").replace("~0", "~")
        if isinstance(obj, list):
            obj = obj[int(part)]
        else:
            obj = obj[part]
    return obj


class StaticHeldOutGrader:
    """Grade a candidate snapshot against the package's checks without
    running any agent or model code (reference evaluation.py:1309-1369)."""

    def __init__(self, package: TaskPackage, original: dict[str, bytes]):
        self.package = package
        self.original = original

    def grade(self, snapshot: CandidateSnapshot) -> list[CheckResult]:
        results = []
        for check in self.package.checks:
            results.append(self._run_check(check, snapshot))
        results.extend(self._editable_paths_check(snapshot))
        return results

    def _run_check(self, check: dict, snap: CandidateSnapshot) -> CheckResult:
        kind = check["type"]
        path = check.get("path")
        data = snap.files.get(path)
        try:
            if kind == "path_exists":
                return CheckResult(check, data is not None)
            if kind == "path_absent":
                return CheckResult(check, data is None)
            if kind == "unchanged":
                return CheckResult(
                    check,
                    data is not None and data == self.original.get(path),
                )
            if data is None:
                return CheckResult(check, False, f"{path} missing")
            if kind == "text_equals":
                got = data.decode("utf-8")
                want = check["value"]
                if check.get("strip", True):
                    got, want = got.strip(), want.strip()
                return CheckResult(check, got == want,
                                   "" if got == want else f"got {got[:80]!r}")
            if kind == "json_value":
                obj = json.loads(data.decode("utf-8"))
                got = _json_pointer(obj, check["pointer"])
                return CheckResult(check, got == check["value"],
                                   f"got {got!r}")
            if kind == "python_constant":
                tree = ast.parse(data.decode("utf-8"))
                name = check["name"]
                for node in tree.body:
                    if (
                        isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id == name
                    ):
                        got = ast.literal_eval(node.value)
                        return CheckResult(check, got == check["value"],
                                           f"got {got!r}")
                return CheckResult(check, False, f"no constant {name!r}")
        except Exception as e:  # malformed candidate content fails the check
            return CheckResult(check, False, f"{type(e).__name__}: {e}")
        return CheckResult(check, False, f"unhandled check {kind}")

    def _editable_paths_check(self, snap: CandidateSnapshot) -> list[CheckResult]:
        if not self.package.editable_paths:
            return []
        allowed = set(self.package.editable_paths)
        forbidden = []
        for rel, data in snap.files.items():
            if rel not in allowed and data != self.original.get(rel):
                forbidden.append(rel)
        for rel in self.original:
            if rel not in snap.files and rel not in allowed:
                forbidden.append(rel)
        check = {"type": "editable_paths", "allowed": sorted(allowed)}
        return [
            CheckResult(
                check,
                not forbidden,
                "" if not forbidden else f"forbidden modifications: {sorted(forbidden)}",
            )
        ]


@dataclasses.dataclass
class EvaluationMetrics:
    """Reconstructed purely from durable session events
    (reference evaluation.py:1408-1488)."""

    steps: int = 0
    tool_calls: int = 0
    tool_errors: int = 0
    protocol_errors: int = 0
    compactions: int = 0
    input_tokens: int = 0
    output_tokens: int = 0
    commands_run: int = 0
    status: str = ""

    @staticmethod
    def from_session(session) -> "EvaluationMetrics":
        m = EvaluationMetrics()
        for ev in session.events:
            if ev.type == "assistant_message":
                m.steps += 1
                stats = ev.data.get("stats") or {}
                m.input_tokens += stats.get("input_tokens", 0) or 0
                m.output_tokens += stats.get("output_tokens", 0) or 0
            elif ev.type == "tool_call":
                m.tool_calls += 1
            elif ev.type == "tool_result":
                if isinstance(ev.data.get("result"), dict) and "error" in ev.data["result"]:
                    m.tool_errors += 1
            elif ev.type == "protocol_error":
                m.protocol_errors += 1
            elif ev.type == "compaction":
                m.compactions += 1
            elif ev.type == "command_started":
                m.commands_run += 1
            elif ev.type == "run_finished":
                m.status = ev.data.get("status", "")
        return m


def evaluate_task(
    package: TaskPackage,
    generate,
    limits=None,
    allow_commands: bool = False,
    workdir: str | None = None,
) -> dict:
    """Stage, run the agent, freeze, grade (reference evaluation.py:
    1491-1561). Commands are disabled by default (command-free policy)."""
    from .loop import AgentLimits, run_agent
    from .recovery import MutationJournal
    from .session import memory_session
    from .workspace import ToolPolicy, Workspace

    staged = StagedTask.stage(package, workdir)
    session = memory_session()
    policy = ToolPolicy(
        root=staged.workdir,
        allow_writes=True,
        allowed_commands=(("python", "-c"),) if allow_commands else (),
    )
    journal = MutationJournal(session, staged.workdir)
    workspace = Workspace(
        policy, session_log=session, journal=journal,
        confirm=lambda action: True,  # evaluation auto-approves
    )
    run = run_agent(
        package.instructions,
        generate,
        workspace,
        limits=limits or AgentLimits(),
        session=session,
    )
    snapshot = staged.freeze()
    grader = StaticHeldOutGrader(package, staged.original)
    results = grader.grade(snapshot)
    metrics = EvaluationMetrics.from_session(session)
    return {
        "task_id": package.task_id,
        "status": run.status,
        "final_message": run.final_message,
        "checks": [
            {"check": r.check, "passed": r.passed, "detail": r.detail}
            for r in results
        ],
        "passed": all(r.passed for r in results),
        "metrics": dataclasses.asdict(metrics),
        "workdir": staged.workdir,
    }
