"""Sandboxed workspace tools.

The port's copy of tiny_llm_tpu/agent/workspace.py (pure Python: the port
cannot import the JAX package, whose __init__ imports JAX); only its
docstrings differ.

Parity: the reference's agent/workspace.py (1094 LoC) —
root-pinned path resolution, bounded list/read, read-before-write digests,
atomic writes with backup/quarantine/restore, exact-unique-match edits,
exact-argv command allowlist with process-group kill and bounded output,
and a confirm-gated execute dispatcher wired to the session log and the
mutation journal.  The hardening invariants preserved here:

* paths: relative only, no '..', no symlink components.  Reads and writes
  are anchored to *file descriptors*: the parent directory is opened with
  an O_NOFOLLOW walk from the pinned root (identity-checked by dev/ino),
  so a component swapped for a symlink after validation cannot redirect
  the operation (the reference's dir-fd walk, workspace.py:731-766).
* reads: the final component is opened O_NOFOLLOW relative to the parent
  fd; it must be a regular file with a single hard link, within the size
  cap, and stable across a double-fstat + name re-stat identity check
  (reference _read_regular_at, workspace.py:768-826).
* writes: split into prepare (full validation, digest+mode+parent
  identity captured) and commit (revalidate, journal intent, atomic
  write) so operator confirmation happens on a fully validated
  operation.  The atomic write stages an O_EXCL temp in the parent fd,
  fsyncs, renames the old file to a backup, verifies the backup, hard-
  links the temp in, verifies the result, and on ANY failure edge
  quarantines unexpected state instead of destroying it and restores the
  backup (reference _atomic_write, workspace.py:876-1094).  Artifacts
  that could not be cleaned up are recorded in
  ``retained_recovery_files``.
* commands: no shell, exact argv-prefix allowlist, scrubbed environment,
  own process group killed on timeout, output drained by a bounded
  reader thread (never an unbounded buffer), durable
  command_started/command_finished events bracketing every launch, and
  ``command_cleanup_incomplete`` / ``command_side_effects_untracked``
  flags when the runner cannot prove the child is gone
  (reference _run_command, workspace.py:441-653).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import signal
import stat as stat_module
import subprocess
import threading
import time
import uuid
from typing import Callable

from .control import AgentInterrupted, CancellationToken
from .protocol import AgentError, ToolAction

PROTECTED_NAMES = frozenset(
    {".git", ".env", ".ssh", ".tiny-llm-tpu", ".gnupg", ".aws"}
)

_NOFOLLOW = getattr(os, "O_NOFOLLOW", 0)
_CLOEXEC = getattr(os, "O_CLOEXEC", 0)
_DIRECTORY = getattr(os, "O_DIRECTORY", 0)
_DIR_FLAGS = os.O_RDONLY | _DIRECTORY | _NOFOLLOW | _CLOEXEC
_FILE_FLAGS = os.O_RDONLY | _NOFOLLOW | _CLOEXEC


class WorkspaceError(Exception):
    """Tool failure; message is returned to the model as the tool result."""


@dataclasses.dataclass(frozen=True)
class ToolPolicy:
    root: str
    allow_writes: bool = False
    allowed_commands: tuple[tuple[str, ...], ...] = ()
    max_file_bytes: int = 256 * 1024
    max_entries: int = 500
    max_output_bytes: int = 32 * 1024
    command_timeout_s: float = 30.0
    protected_names: frozenset[str] = PROTECTED_NAMES

    def __post_init__(self):
        root = os.path.realpath(self.root)
        if not os.path.isdir(root):
            raise ValueError(f"workspace root {self.root!r} is not a directory")
        object.__setattr__(self, "root", root)
        for cmd in self.allowed_commands:
            if not cmd or not all(isinstance(a, str) for a in cmd):
                raise ValueError(f"bad allowlist entry {cmd!r}")
        if self.max_file_bytes <= 0 or self.max_output_bytes <= 0:
            raise ValueError("size limits must be positive")


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@dataclasses.dataclass(frozen=True)
class PreparedWrite:
    """A fully validated write, computed before operator confirmation.

    Captures everything needed to detect interference between the moment
    the operator approved the action and the moment it executes: the
    expected content digest and mode of the target (None for a new
    file), and the dev/ino identity of the parent directory.
    """

    rel: str
    parts: tuple[str, ...]
    data: bytes
    expected_digest: str | None
    expected_mode: int | None
    after_mode: int
    parent_identity: tuple[int, int]


class Workspace:
    def __init__(
        self,
        policy: ToolPolicy,
        session_log=None,
        journal=None,
        confirm: Callable[[ToolAction], bool] | None = None,
        cancellation: CancellationToken | None = None,
    ):
        self.policy = policy
        self.session = session_log
        self.journal = journal
        # Default-deny for side effects, like the reference's execute
        # dispatch (workspace.py:655-707).
        self.confirm = confirm if confirm is not None else (lambda action: False)
        self.cancellation = cancellation or CancellationToken()
        self._read_digests: dict[str, str] = {}
        st = os.stat(policy.root)
        self._root_id = (st.st_dev, st.st_ino)
        # Files this workspace changed (for disclosure), files whose state
        # is unknown because a mutation may have been interrupted, and
        # recovery artifacts (backups/quarantines) left on disk.
        self.modified_files: set[str] = set()
        self.uncertain_modified_files: set[str] = set()
        self.retained_recovery_files: set[str] = set()
        # Command-runner safety flags: set when a child process ran (so
        # arbitrary side effects may exist) and when the runner could not
        # prove the child and its descendants are fully gone.
        self.command_side_effects_untracked = False
        self.command_cleanup_incomplete = False

    # -- path resolution -----------------------------------------------------
    def _split(self, rel: str) -> tuple[str, ...]:
        if not isinstance(rel, str) or rel == "" or "\x00" in rel:
            raise WorkspaceError("path must be a non-empty relative path")
        if os.path.isabs(rel):
            raise WorkspaceError(f"absolute paths are rejected: {rel!r}")
        parts = tuple(
            p for p in rel.replace("\\", "/").split("/") if p not in ("", ".")
        )
        if not parts:
            raise WorkspaceError("path must be a non-empty relative path")
        if any(p == ".." for p in parts):
            raise WorkspaceError(f"'..' components are rejected: {rel!r}")
        if parts[0] in self.policy.protected_names:
            raise WorkspaceError(f"path {rel!r} is protected")
        return parts

    def resolve_path(self, rel: str, for_write: bool = False) -> str:
        # Root identity pin: the root must still be the directory the
        # policy was built for (workspace.py:74-121).
        st = os.stat(self.policy.root)
        if (st.st_dev, st.st_ino) != self._root_id:
            raise WorkspaceError("workspace root changed identity; refusing")
        if rel == ".":
            return self.policy.root
        parts = self._split(rel)
        cur = self.policy.root
        for i, p in enumerate(parts):
            cur = os.path.join(cur, p)
            if os.path.islink(cur):
                raise WorkspaceError(f"symlink component rejected: {rel!r}")
            is_last = i == len(parts) - 1
            if not os.path.exists(cur):
                if for_write and is_last:
                    break
                raise WorkspaceError(f"path does not exist: {rel!r}")
        return cur

    def _open_parent_fd(self, parts: tuple[str, ...]) -> tuple[int, str]:
        """Open the final component's parent directory via an O_NOFOLLOW
        dir-fd walk from the pinned root.  Nothing resolved through this
        fd can be redirected by a symlink swapped in after validation.
        Caller owns the returned fd."""
        try:
            fd = os.open(self.policy.root, _DIR_FLAGS)
        except OSError as e:
            raise WorkspaceError(f"workspace root is unsafe: {e}") from None
        try:
            st = os.fstat(fd)
            if not stat_module.S_ISDIR(st.st_mode) or (
                st.st_dev, st.st_ino
            ) != self._root_id:
                raise WorkspaceError("workspace root changed identity; refusing")
            for comp in parts[:-1]:
                try:
                    child = os.open(comp, _DIR_FLAGS, dir_fd=fd)
                except OSError as e:
                    raise WorkspaceError(
                        f"path component {comp!r} is missing or unsafe: {e}"
                    ) from None
                os.close(fd)
                fd = child
                if not stat_module.S_ISDIR(os.fstat(fd).st_mode):
                    raise WorkspaceError(f"path component {comp!r} is not a directory")
            return fd, parts[-1]
        except BaseException:
            os.close(fd)
            raise

    def _read_regular_at(
        self, parent_fd: int, name: str, tool: str
    ) -> tuple[bytes, os.stat_result] | None:
        """Open and read the final component relative to the anchored
        parent fd, proving it is a stable, single-link regular file.
        Returns None when the name does not exist."""
        try:
            fd = os.open(name, _FILE_FLAGS, dir_fd=parent_fd)
        except FileNotFoundError:
            return None
        except OSError as e:
            raise WorkspaceError(
                f"{tool}: path must be a safe regular file ({e})"
            ) from None
        try:
            opened = os.fstat(fd)
            if not stat_module.S_ISREG(opened.st_mode):
                raise WorkspaceError(f"{tool}: not a regular file")
            if opened.st_nlink != 1:
                # A second hard link means content can be swapped through
                # another name; refuse (reference workspace.py:786-791).
                raise WorkspaceError(f"{tool}: file has multiple hard links")
            if opened.st_size > self.policy.max_file_bytes:
                raise WorkspaceError(
                    f"{tool}: file is {opened.st_size} bytes; "
                    f"limit {self.policy.max_file_bytes}"
                )
            with os.fdopen(fd, "rb", closefd=False) as f:
                data = f.read(self.policy.max_file_bytes + 1)
            if len(data) > self.policy.max_file_bytes:
                raise WorkspaceError(f"{tool}: file exceeds the size limit")
            # Stability: the inode must not have changed while we read it,
            # and the NAME must still point at the inode we read (a swap
            # between open and read would otherwise go unnoticed).
            after = os.fstat(fd)
            try:
                named = os.stat(name, dir_fd=parent_fd, follow_symlinks=False)
            except FileNotFoundError:
                raise WorkspaceError(f"{tool}: file changed while reading") from None
            same_inode = (named.st_dev, named.st_ino) == (opened.st_dev, opened.st_ino)
            stable = (
                (after.st_size, after.st_mtime_ns) == (opened.st_size, opened.st_mtime_ns)
                and (named.st_size, named.st_mtime_ns)
                == (opened.st_size, opened.st_mtime_ns)
            )
            if (
                not stat_module.S_ISREG(named.st_mode)
                or named.st_nlink != 1
                or not same_inode
                or not stable
                or stat_module.S_IMODE(named.st_mode)
                != stat_module.S_IMODE(opened.st_mode)
            ):
                raise WorkspaceError(f"{tool}: file changed while reading")
            return data, opened
        finally:
            os.close(fd)

    # -- read-only tools -----------------------------------------------------
    def list_files(self, rel: str) -> list[str]:
        target = self.resolve_path(rel or ".")
        if not os.path.isdir(target):
            raise WorkspaceError(f"not a directory: {rel!r}")
        out = []
        for name in sorted(os.listdir(target)):
            if name in self.policy.protected_names:
                continue
            full = os.path.join(target, name)
            out.append(name + ("/" if os.path.isdir(full) else ""))
            if len(out) >= self.policy.max_entries:
                out.append(f"... (truncated at {self.policy.max_entries} entries)")
                break
        return out

    def read_file(self, rel: str) -> str:
        parts = self._split(rel)
        self.resolve_path(rel)  # protected/symlink-component screening
        parent, name = self._open_parent_fd(parts)
        try:
            got = self._read_regular_at(parent, name, tool="read_file")
        finally:
            os.close(parent)
        if got is None:
            raise WorkspaceError(f"not a regular file: {rel!r}")
        data, _ = got
        target = os.path.join(self.policy.root, *parts)
        self._read_digests[target] = _digest(data)
        try:
            return data.decode("utf-8")
        except UnicodeDecodeError:
            raise WorkspaceError(f"file is not valid UTF-8: {rel!r}") from None

    # -- mutations: prepare --------------------------------------------------
    def prepare_write(self, rel: str, content: str) -> PreparedWrite:
        """Validate a write completely — path safety, size, read-before-
        write digest, mode capture — without touching the workspace."""
        if not self.policy.allow_writes:
            raise WorkspaceError("writes are disabled by policy")
        parts = self._split(rel)
        self.resolve_path(rel, for_write=True)
        data = content.encode("utf-8")
        if len(data) > self.policy.max_file_bytes:
            raise WorkspaceError("content exceeds max_file_bytes")
        target = os.path.join(self.policy.root, *parts)
        parent, name = self._open_parent_fd(parts)
        try:
            pstat = os.fstat(parent)
            got = self._read_regular_at(parent, name, tool="write_file")
        finally:
            os.close(parent)
        observed = self._read_digests.get(target)
        if got is None:
            if observed is not None:
                raise WorkspaceError(
                    f"{rel!r} disappeared since it was read; re-read before writing"
                )
            expected_digest = None
            expected_mode = None
            after_mode = 0o644
        else:
            current, cur_stat = got
            if observed is None:
                raise WorkspaceError(f"read {rel!r} before writing it")
            if observed != _digest(current):
                raise WorkspaceError(
                    f"{rel!r} changed since it was read; re-read before writing"
                )
            expected_digest = _digest(current)
            expected_mode = stat_module.S_IMODE(cur_stat.st_mode)
            after_mode = expected_mode & 0o777
        return PreparedWrite(
            rel=rel,
            parts=parts,
            data=data,
            expected_digest=expected_digest,
            expected_mode=expected_mode,
            after_mode=after_mode,
            parent_identity=(pstat.st_dev, pstat.st_ino),
        )

    def prepare_edit(self, rel: str, old: str, new: str) -> PreparedWrite:
        """Validate an exact-unique-match replacement without mutating."""
        if not self.policy.allow_writes:
            raise WorkspaceError("writes are disabled by policy")
        if not old:
            raise WorkspaceError("old text must not be empty")
        current_text = self.read_file(rel)
        n = current_text.count(old)
        if n == 0:
            raise WorkspaceError("old text not found")
        if n > 1:
            raise WorkspaceError(f"old text occurs {n} times; must be unique")
        return self.prepare_write(rel, current_text.replace(old, new, 1))

    # -- mutations: commit ---------------------------------------------------
    def _revalidate(
        self, prepared: PreparedWrite, parent_fd: int, name: str
    ) -> None:
        """The target must still look exactly as it did at prepare time."""
        got = self._read_regular_at(parent_fd, name, tool="write_file")
        if prepared.expected_digest is None:
            if got is not None:
                raise WorkspaceError(
                    f"{prepared.rel!r} appeared after approval; read it first"
                )
            return
        if got is None:
            raise WorkspaceError(
                f"{prepared.rel!r} changed since it was read; re-read before writing"
            )
        content, st = got
        if (
            _digest(content) != prepared.expected_digest
            or stat_module.S_IMODE(st.st_mode) != prepared.expected_mode
        ):
            raise WorkspaceError(
                f"{prepared.rel!r} changed since it was read; re-read before writing"
            )

    def commit_write(self, prepared: PreparedWrite) -> dict:
        """Journal the intent, then perform the atomic write."""
        target = os.path.join(self.policy.root, *prepared.parts)
        intent = None
        if self.journal is not None:
            intent = self.journal.record_intent(target, prepared.data)
        self.cancellation.raise_if_cancelled("file_mutation")
        self.uncertain_modified_files.add(target)
        self._atomic_write(prepared)
        self._read_digests[target] = _digest(prepared.data)
        self.modified_files.add(target)
        self.uncertain_modified_files.discard(target)
        if self.journal is not None:
            self.journal.commit(intent)
        return {"written": prepared.rel, "bytes": len(prepared.data)}

    def _atomic_write(self, prepared: PreparedWrite) -> None:
        """Stage → backup → link-install → verify, all fd-anchored.

        Failure edges:
        * before install: the target is untouched; the temp is removed by
          identity (never blind unlink of a name someone may have swapped).
        * after the backup rename but before/at install: the backup is
          re-linked under the original name and kept on disk.
        * after install but failing verification: the installed entry is
          QUARANTINED (renamed aside, identity-checked, retained) and the
          backup restored — unexpected content is never destroyed.
        Anything left behind is recorded in retained_recovery_files.
        """
        parent, name = self._open_parent_fd(prepared.parts)
        parent_dir = os.path.join(self.policy.root, *prepared.parts[:-1])
        tmp_name = f".tlt-agent-{uuid.uuid4().hex}.tmp"
        backup_name: str | None = None
        backup_identity: tuple[int, int] | None = None
        tmp_identity: tuple[int, int] | None = None
        installed = False
        succeeded = False

        def _unlink_by_identity(entry: str, identity: tuple[int, int]) -> bool:
            """Remove our private entry only if it is still our inode."""
            try:
                st = os.stat(entry, dir_fd=parent, follow_symlinks=False)
            except FileNotFoundError:
                return True
            except OSError:
                return False
            if (st.st_dev, st.st_ino) != identity:
                return False
            try:
                os.unlink(entry, dir_fd=parent)
            except OSError:
                return False
            return True

        def _restore_backup() -> None:
            """Put the old content back under its name without clobbering
            whatever may now be there (link fails on EEXIST by design).
            Once the content is safely back under the public name, the
            backup entry itself is removed by identity so the restored
            file is a normal single-link file again; if anything about
            that is uncertain the backup stays on disk, accounted for."""
            if backup_name is None:
                return
            try:
                os.link(
                    backup_name, name,
                    src_dir_fd=parent, dst_dir_fd=parent,
                    follow_symlinks=False,
                )
            except (FileExistsError, FileNotFoundError, OSError):
                return
            if backup_identity is not None and _unlink_by_identity(
                backup_name, backup_identity
            ):
                self.retained_recovery_files.discard(
                    os.path.join(parent_dir, backup_name)
                )

        def _quarantine_installed() -> None:
            """Move the public entry aside rather than unlinking a name
            whose inode we can no longer vouch for."""
            q_name = f".tlt-agent-{uuid.uuid4().hex}.failed"
            self.retained_recovery_files.add(os.path.join(parent_dir, q_name))
            try:
                os.replace(name, q_name, src_dir_fd=parent, dst_dir_fd=parent)
            except (FileNotFoundError, OSError):
                return

        try:
            pstat = os.fstat(parent)
            if (pstat.st_dev, pstat.st_ino) != prepared.parent_identity:
                raise WorkspaceError(
                    f"{prepared.rel!r} parent directory changed; re-read and retry"
                )
            self._revalidate(prepared, parent, name)
            fd = os.open(
                tmp_name,
                os.O_WRONLY | os.O_CREAT | os.O_EXCL | _NOFOLLOW | _CLOEXEC,
                0o600,
                dir_fd=parent,
            )
            try:
                # Identity first: even a failed write must leave a
                # cleanable (or at least accounted-for) temp entry.
                tst = os.fstat(fd)
                tmp_identity = (tst.st_dev, tst.st_ino)
                os.write(fd, prepared.data)
                os.fchmod(fd, prepared.after_mode)
                os.fsync(fd)
            finally:
                os.close(fd)
            self._revalidate(prepared, parent, name)
            if prepared.expected_digest is not None:
                backup_name = f".tlt-agent-{uuid.uuid4().hex}.bak"
                self.retained_recovery_files.add(
                    os.path.join(parent_dir, backup_name)
                )
                os.replace(name, backup_name, src_dir_fd=parent, dst_dir_fd=parent)
                moved = self._read_regular_at(parent, backup_name, tool="write_file")
                if moved is not None:
                    backup_identity = (moved[1].st_dev, moved[1].st_ino)
                if moved is None or _digest(moved[0]) != prepared.expected_digest:
                    _restore_backup()
                    raise WorkspaceError(
                        f"{prepared.rel!r} changed during the write; aborted"
                    )
            os.link(
                tmp_name, name,
                src_dir_fd=parent, dst_dir_fd=parent, follow_symlinks=False,
            )
            installed = True
            if not _unlink_by_identity(tmp_name, tmp_identity):
                raise WorkspaceError("could not safely clean up the temporary write")
            final = self._read_regular_at(parent, name, tool="write_file")
            if final is None or (
                _digest(final[0]),
                stat_module.S_IMODE(final[1].st_mode),
            ) != (_digest(prepared.data), prepared.after_mode):
                raise WorkspaceError("atomic write result failed verification")
            os.fsync(parent)
            if (
                backup_name is not None
                and backup_identity is not None
                and _unlink_by_identity(backup_name, backup_identity)
            ):
                self.retained_recovery_files.discard(
                    os.path.join(parent_dir, backup_name)
                )
            succeeded = True
        finally:
            try:
                if not succeeded:
                    if installed:
                        try:
                            _quarantine_installed()
                        finally:
                            _restore_backup()
                    else:
                        _restore_backup()
                if tmp_identity is not None and not _unlink_by_identity(
                    tmp_name, tmp_identity
                ):
                    self.retained_recovery_files.add(
                        os.path.join(parent_dir, tmp_name)
                    )
            finally:
                try:
                    os.fsync(parent)
                except OSError:
                    pass
                os.close(parent)

    # -- convenience write entry points (prepare + commit in one step) -------
    def write_file(self, rel: str, content: str) -> dict:
        return self.commit_write(self.prepare_write(rel, content))

    def edit_file(self, rel: str, old: str, new: str) -> dict:
        return self.commit_write(self.prepare_edit(rel, old, new))

    # -- commands ------------------------------------------------------------
    def _command_allowed(self, argv: list[str]) -> bool:
        return any(
            tuple(argv[: len(prefix)]) == prefix
            for prefix in self.policy.allowed_commands
        )

    def run_command(self, argv: list[str]) -> dict:
        if not self._command_allowed(argv):
            raise WorkspaceError(f"command {argv!r} is not in the allowlist")
        command_id = uuid.uuid4().hex
        env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
               "HOME": self.policy.root, "LANG": "C.UTF-8"}
        proc = None
        cleaned_up = False

        def finish_event(**data) -> None:
            if self.session is not None:
                self.session.append(
                    "command_finished",
                    {"command_id": command_id, "argv": list(argv),
                     "cleanup_incomplete": self.command_cleanup_incomplete,
                     **data},
                )

        def clean_up() -> None:
            """Kill the command's process group at most once."""
            nonlocal cleaned_up
            if proc is not None and not cleaned_up:
                cleaned_up = True
                self.command_side_effects_untracked = True
                self._kill_and_reap(proc)

        self.cancellation.raise_if_cancelled("command")
        if self.session is not None:
            self.session.append(
                "command_started", {"command_id": command_id, "argv": list(argv)}
            )
        try:
            self.cancellation.raise_if_cancelled("command")
        except AgentInterrupted:
            finish_event(returncode=130, launched=False, timed_out=False)
            raise
        self.command_side_effects_untracked = True
        t0 = time.monotonic()
        try:
            proc = subprocess.Popen(
                argv,
                cwd=self.policy.root,
                env=env,
                shell=False,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL,
                start_new_session=True,
                bufsize=0,
            )
        except OSError as e:
            finish_event(returncode=None, launched=False, timed_out=False,
                         error=str(e))
            raise WorkspaceError(f"failed to start command: {e}") from None

        # Bounded output drain: a reader thread moves pipe bytes into a
        # capped buffer so a chatty child can neither fill our memory nor
        # deadlock on a full pipe (reference workspace.py:519-539).
        assert proc.stdout is not None
        captured = bytearray()
        truncated_flag = threading.Event()
        read_failed = threading.Event()
        output_abandoned = False

        def drain() -> None:
            try:
                while chunk := proc.stdout.read(4096):
                    remaining = self.policy.max_output_bytes - len(captured)
                    if remaining > 0:
                        captured.extend(chunk[:remaining])
                    if len(chunk) > remaining:
                        truncated_flag.set()
            except (OSError, ValueError):
                self.command_cleanup_incomplete = True
                read_failed.set()

        reader = threading.Thread(target=drain, daemon=True)
        reader.start()
        timed_out = False
        returncode: int | None = None
        try:
            # Cancellation-aware wait: poll in short slices so a cancel
            # from another thread interrupts promptly.
            deadline = t0 + self.policy.command_timeout_s
            while True:
                self.cancellation.raise_if_cancelled("command")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    timed_out = True
                    clean_up()
                    returncode = proc.poll()
                    break
                try:
                    returncode = proc.wait(timeout=min(0.1, remaining))
                    break
                except subprocess.TimeoutExpired:
                    continue
        except BaseException:
            clean_up()
            finish_event(returncode=proc.poll(), launched=True,
                         timed_out=False)
            raise
        finally:
            reader.join(timeout=0.05)
            if reader.is_alive():
                # A descendant may still hold the write end of the pipe;
                # kill the group and give the reader a bounded grace.
                clean_up()
                reader.join(timeout=1.0)
                if reader.is_alive():
                    output_abandoned = True
                    self.command_cleanup_incomplete = True
                    try:
                        proc.stdout.close()
                    except (OSError, ValueError):
                        pass
                    reader.join(timeout=0.1)
            try:
                proc.stdout.close()
            except (OSError, ValueError):
                pass

        dt = time.monotonic() - t0
        text = bytes(captured).decode("utf-8", "replace")
        warnings = []
        if read_failed.is_set():
            warnings.append("command output collection failed")
        if output_abandoned:
            warnings.append(
                "command output abandoned; a descendant may retain the pipe"
            )
        result = {
            "argv": argv,
            "returncode": returncode,
            "output": text,
            "truncated": truncated_flag.is_set(),
            "timed_out": timed_out,
            "seconds": round(dt, 3),
        }
        if warnings:
            result["warnings"] = warnings
        finish_event(returncode=returncode, launched=True, timed_out=timed_out,
                     seconds=round(dt, 3))
        if timed_out:
            raise WorkspaceError(
                f"command timed out after {self.policy.command_timeout_s}s; killed"
            )
        return result

    def _kill_and_reap(self, proc) -> bool:
        """Bounded process-group termination + foreground reap; flags
        cleanup_incomplete whenever the child's fate is unproven."""
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        except OSError:
            self.command_cleanup_incomplete = True
            try:
                proc.kill()
            except OSError:
                pass
        try:
            proc.wait(timeout=1.0)
        except (OSError, subprocess.TimeoutExpired):
            self.command_cleanup_incomplete = True
            return False
        return True

    # -- dispatch ------------------------------------------------------------
    def execute(self, action: ToolAction) -> dict:
        """Run one tool action: cancellation check, PREPARE-then-confirm
        for side effects (the operator approves a fully validated
        operation, not a request that may later fail validation), and
        durable tool_call/tool_result events."""
        self.cancellation.raise_if_cancelled(f"tool:{action.tool}")
        call_ev = None
        if self.session is not None:
            call_ev = self.session.append(
                "tool_call", {"tool": action.tool, "args": action.args}
            )

        def record(result: dict) -> dict:
            if self.session is not None and call_ev is not None:
                self.session.append(
                    "tool_result", {"call_id": call_ev.id, "result": result}
                )
            return result

        def confirmed() -> bool:
            return bool(self.confirm(action))

        try:
            if action.tool == "list_files":
                return record({"entries": self.list_files(action.args["path"])})
            if action.tool == "read_file":
                return record({"content": self.read_file(action.args["path"])})
            if action.tool == "write_file":
                prepared = self.prepare_write(
                    action.args["path"], action.args["content"]
                )
                if not confirmed():
                    return record({"error": "action rejected by user"})
                return record(self.commit_write(prepared))
            if action.tool == "edit_file":
                prepared = self.prepare_edit(
                    action.args["path"], action.args["old"], action.args["new"]
                )
                if not confirmed():
                    return record({"error": "action rejected by user"})
                return record(self.commit_write(prepared))
            if action.tool == "run_command":
                argv = list(action.args["argv"])
                if not self._command_allowed(argv):
                    raise WorkspaceError(
                        f"command {argv!r} is not in the allowlist"
                    )
                if not confirmed():
                    return record({"error": "action rejected by user"})
                return record(self.run_command(argv))
            raise AgentError(f"unhandled tool {action.tool!r}")
        except (WorkspaceError, OSError, KeyError, ValueError,
                subprocess.SubprocessError) as e:
            return record({"error": str(e)})
