"""Deterministic fault injection for the fake backend.

The fake cluster (kube/fake.py) is the reference's key test trick grown into
a full backend; :class:`ChaosConfig` is its failure dial. Tests attach one
to a ``FakeCluster`` and script failures op-by-op:

- ``fail_next(op, count)`` — the next ``count`` calls of an operation raise
  :class:`ChaosError` (a ``ConnectionError`` subclass, so every retry policy
  that retries transport errors retries chaos errors too);
- ``add_latency(op, seconds)`` — every call of the op sleeps first;
- ``drop_stream_after(op, nbytes)`` — streams opened by the op die after
  ``nbytes`` bytes of stdin traffic (a mid-upload connection drop);
- ``FakeCluster.kill_pod(name)`` — the pod vanishes and all its live exec
  streams are torn down (a pod deletion/restart mid-session).

Everything is counter-based — no RNG, no wall-clock — so a chaos test is
bit-for-bit repeatable (scripts/chaos_check_torch.py runs the port's chaos
tests three times and fails on any outcome drift).

Op names used by the fake backend hooks: ``exec_stream``, ``exec_buffered``,
``logs``, ``portforward_dial``, ``slice_workers``.

The port's copy of ``devspace_tpu/resilience/chaos.py``, with the same
behaviour.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class ChaosError(ConnectionError):
    """Injected failure. Subclasses ConnectionError (hence OSError) so the
    stock transport/resolution retry policies treat it as transient."""


class ChaosConfig:
    """Per-operation failure schedule, consumed by fake-backend hooks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fail_counts: dict[str, int] = {}
        self._fail_exc: dict[str, Callable[[], BaseException]] = {}
        self._latency: dict[str, float] = {}
        self._stream_budget: dict[str, int] = {}
        # observability for assertions: op -> [("ok"|"fail"), ...]
        self.calls: dict[str, list[str]] = {}

    # -- scripting API (tests) ---------------------------------------------
    def fail_next(
        self,
        op: str,
        count: int = 1,
        exc: Optional[Callable[[], BaseException]] = None,
    ) -> None:
        """Make the next ``count`` calls of ``op`` raise (then succeed)."""
        with self._lock:
            self._fail_counts[op] = self._fail_counts.get(op, 0) + count
            if exc is not None:
                self._fail_exc[op] = exc

    def fail_always(self, op: str) -> None:
        """Make every future call of ``op`` fail (a permanent outage)."""
        with self._lock:
            self._fail_counts[op] = 1 << 30

    def clear(self, op: Optional[str] = None) -> None:
        with self._lock:
            if op is None:
                self._fail_counts.clear()
                self._fail_exc.clear()
                self._latency.clear()
                self._stream_budget.clear()
            else:
                self._fail_counts.pop(op, None)
                self._fail_exc.pop(op, None)
                self._latency.pop(op, None)
                self._stream_budget.pop(op, None)

    def add_latency(self, op: str, seconds: float) -> None:
        """Every call of ``op`` sleeps ``seconds`` before running."""
        with self._lock:
            self._latency[op] = seconds

    def drop_stream_after(self, op: str, nbytes: int) -> None:
        """Streams opened by ``op`` from now on die after ``nbytes`` bytes
        of stdin traffic (each affected stream gets its own budget)."""
        with self._lock:
            self._stream_budget[op] = nbytes

    # -- engine API (fake backend hooks) -----------------------------------
    def before(self, op: str, **context) -> None:
        """Hook point at the top of a fake-backend operation: applies
        latency then consumes one scheduled failure, if any."""
        with self._lock:
            delay = self._latency.get(op, 0.0)
            remaining = self._fail_counts.get(op, 0)
            if remaining > 0:
                self._fail_counts[op] = remaining - 1
                make_exc = self._fail_exc.get(op)
                self.calls.setdefault(op, []).append("fail")
            else:
                make_exc = None
                self.calls.setdefault(op, []).append("ok")
        if delay > 0:
            time.sleep(delay)
        if remaining > 0:
            target = context.get("pod", "")
            raise (
                make_exc()
                if make_exc is not None
                else ChaosError(f"chaos: injected {op} failure ({target})")
            )

    def stream_budget(self, op: str) -> Optional[int]:
        """Byte budget for a newly opened stream of ``op``, or None."""
        with self._lock:
            return self._stream_budget.get(op)

    def failures_injected(self, op: str) -> int:
        with self._lock:
            return sum(1 for c in self.calls.get(op, []) if c == "fail")


class ByteBudgetStream:
    """Wraps a RemoteProcess so its connection 'drops' after a byte budget
    is spent on stdin traffic: the write raises ``StreamClosed`` and the
    underlying process is terminated — exactly what a mid-upload transport
    drop looks like to the sync engine."""

    def __init__(self, proc, budget: int):
        self._proc = proc
        self._budget = budget
        self._lock = threading.Lock()

    # Everything not intercepted forwards to the real process.
    def __getattr__(self, item):
        return getattr(self._proc, item)

    def write_stdin(self, data: bytes) -> None:
        from ..kube.streams import StreamClosed

        with self._lock:
            self._budget -= len(data)
            tripped = self._budget < 0
        if tripped:
            self._proc.terminate()
            raise StreamClosed("chaos: connection dropped (byte budget spent)")
        self._proc.write_stdin(data)
