"""Cancellation and mid-run steering.

The port's copy of tiny_llm_tpu/agent/control.py (pure Python: the port
cannot import the JAX package, whose __init__ imports JAX); only its
docstrings differ.

Parity: the reference's agent/control.py:1-83 —
first-writer-wins thread-safe cancellation with named phases, plus a
handle for queueing durable user corrections into a running session.
"""

from __future__ import annotations

import threading
from typing import Callable


class AgentInterrupted(Exception):
    def __init__(self, reason: str, phase: str):
        super().__init__(f"interrupted during {phase}: {reason}")
        self.reason = reason
        self.phase = phase


class CancellationToken:
    """First writer wins; later cancel() calls keep the original reason."""

    def __init__(self):
        self._lock = threading.Lock()
        self._reason: str | None = None

    def cancel(self, reason: str = "cancelled") -> bool:
        """Returns True iff this call was the one that cancelled."""
        with self._lock:
            if self._reason is None:
                self._reason = reason
                return True
            return False

    @property
    def cancelled(self) -> bool:
        with self._lock:
            return self._reason is not None

    @property
    def reason(self) -> str | None:
        with self._lock:
            return self._reason

    def raise_if_cancelled(self, phase: str) -> None:
        with self._lock:
            if self._reason is not None:
                raise AgentInterrupted(self._reason, phase)

    def run_if_active(self, fn: Callable, phase: str):
        """Linearize an action against cancellation: either the action runs
        (and cancellation afterwards cannot un-run it) or the token was
        already cancelled and the action never starts."""
        with self._lock:
            if self._reason is not None:
                raise AgentInterrupted(self._reason, phase)
            return fn()


class SteeringHandle:
    """Queue durable mid-run user corrections into a session log."""

    def __init__(self, session_log):
        self._session = session_log

    def submit(self, text: str) -> None:
        self._session.queue_steering(text)
