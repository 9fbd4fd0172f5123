"""Retry/backoff and circuit-breaker primitives.

Design constraints, in order:

1. **Deterministic when seeded.** Jitter comes from a private
   ``random.Random(seed)`` so a chaos test with a fixed seed sees the exact
   same delay schedule on every run (scripts/chaos_check.py asserts this
   across repeats). No global RNG, no wall-clock dependence.
2. **Injectable time.** ``sleep``/``clock`` are parameters so unit tests run
   in microseconds and a stopping session can interrupt waits (pass the
   session's ``Event.wait`` as the sleep).
3. **Small surface.** One policy object usable two ways: as an iterator of
   delays (for loops that own their control flow, like the downstream poll),
   or as ``execute(fn)``.

The port's copy of ``devspace_tpu/resilience/policy.py``, with the same
behaviour; it imports nothing of the JAX package. The reference's
``@retry(policy)`` decorator is left out: nothing in the port uses it.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

from ..obs import events as _events
from ..obs.metrics import get_registry

# (name, kind, help) — lintable catalog (scripts/metrics_lint.py). These
# are process-wide direct counters (not per-instance): policies and
# breakers are cheap throwaway objects, so the aggregate is the useful
# signal and the counters live in the default registry.
RESILIENCE_METRIC_FAMILIES = (
    (
        "resilience_retry_attempts_total",
        "counter",
        "Backoff waits taken before retrying a failed operation",
        "sum",
    ),
    (
        "resilience_retries_exhausted_total",
        "counter",
        "Operations abandoned after exhausting retry attempts or deadline",
        "sum",
    ),
    (
        "resilience_circuit_open_total",
        "counter",
        "Circuit-breaker transitions into the open state",
        "sum",
    ),
)

def _counter(idx: int):
    name, _kind, help_, _agg = RESILIENCE_METRIC_FAMILIES[idx]
    return get_registry().counter(name, help_)


_retry_attempts = _counter(0)
_retries_exhausted = _counter(1)
_circuit_open = _counter(2)


class RetryExhausted(Exception):
    """All attempts failed; ``last`` carries the final exception."""

    def __init__(self, message: str, last: Optional[BaseException] = None, attempts: int = 0):
        super().__init__(message)
        self.last = last
        self.attempts = attempts


@dataclass
class RetryPolicy:
    """Exponential backoff with bounded attempts, delay cap, optional
    overall deadline and deterministic jitter.

    Delay for attempt ``k`` (0-based, i.e. the wait *after* the k+1-th
    failure) is ``min(max_delay, base_delay * multiplier**k)``, scaled by a
    jitter factor drawn uniformly from ``[1 - jitter, 1]``.
    """

    max_attempts: int = 5
    base_delay: float = 0.1
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.0  # fraction of the delay that may be shaved off
    deadline: Optional[float] = None  # total seconds across all attempts
    retry_on: tuple = (Exception,)
    seed: Optional[int] = None  # deterministic jitter stream when set
    _rng: random.Random = field(init=False, repr=False, compare=False, default=None)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def delays(self) -> Iterator[float]:
        """Yield the backoff delay after each failed attempt. Yields
        ``max_attempts - 1`` values: no wait follows the final attempt."""
        for k in range(max(0, self.max_attempts - 1)):
            delay = min(self.max_delay, self.base_delay * (self.multiplier**k))
            if self.jitter > 0:
                delay *= 1.0 - self.jitter * self._rng.random()
            yield max(0.0, delay)

    def execute(
        self,
        fn: Callable,
        *args,
        describe: str = "operation",
        on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
        sleep: Callable[[float], object] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        reraise: bool = False,
        **kwargs,
    ):
        """Call ``fn`` under this policy. ``on_retry(attempt, exc, delay)``
        fires before each backoff wait. Non-matching exceptions propagate
        immediately; exhausted attempts raise :class:`RetryExhausted` —
        or, with ``reraise=True``, the last underlying exception (for call
        sites whose callers dispatch on the original exception type).

        Trace propagation: the caller's active span context is
        captured once at entry and re-attached around EVERY attempt, so
        spans opened inside attempt N > 1 — including remote-exec
        traceparents exported after a shell revive — still parent under
        the operation that started the retry loop, even when ``sleep`` /
        ``on_retry`` callbacks disturbed the thread-local stack."""
        from ..obs.tracing import get_tracer

        tracer = get_tracer()
        trace_ctx = tracer.current_context()
        start = clock()
        last: Optional[BaseException] = None
        delays = self.delays()
        for attempt in range(1, self.max_attempts + 1):
            try:
                with tracer.attach(trace_ctx):
                    return fn(*args, **kwargs)
            except self.retry_on as e:  # noqa: PERF203 — retry is the point
                last = e
            try:
                delay = next(delays)
            except StopIteration:
                break
            if self.deadline is not None and clock() - start + delay > self.deadline:
                _retries_exhausted.inc()
                _events.emit(
                    "resilience", "retries_exhausted", level="error",
                    what=describe, attempts=attempt, why="deadline",
                )
                if reraise:
                    raise last
                raise RetryExhausted(
                    f"{describe} failed after {attempt} attempt(s): "
                    f"deadline of {self.deadline:.1f}s would be exceeded",
                    last=last,
                    attempts=attempt,
                ) from last
            if on_retry is not None:
                on_retry(attempt, last, delay)
            _retry_attempts.inc()
            sleep(delay)
        _retries_exhausted.inc()
        _events.emit(
            "resilience", "retries_exhausted", level="error",
            what=describe, attempts=self.max_attempts, why="attempts",
        )
        if reraise:
            raise last
        raise RetryExhausted(
            f"{describe} failed after {self.max_attempts} attempt(s): {last}",
            last=last,
            attempts=self.max_attempts,
        ) from last


class CircuitOpenError(Exception):
    """The breaker is open: calls are rejected without running."""


class CircuitBreaker:
    """Classic three-state breaker guarding an unreliable dependency.

    closed → (``failure_threshold`` consecutive failures) → open →
    (``reset_timeout`` elapses) → half-open → one probe call: success closes,
    failure re-opens. Thread-safe; time is injectable for tests.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        name: str = "",
    ):
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout = reset_timeout
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._check_state()

    def _check_state(self) -> str:
        # caller holds the lock
        if (
            self._state == self.OPEN
            and self._clock() - self._opened_at >= self.reset_timeout
        ):
            self._state = self.HALF_OPEN
        return self._state

    def allow(self) -> bool:
        """True when a call may proceed (half-open admits the probe)."""
        with self._lock:
            return self._check_state() != self.OPEN

    def record_success(self) -> None:
        with self._lock:
            was = self._state
            self._failures = 0
            self._state = self.CLOSED
        if was != self.CLOSED:
            _events.emit(
                "resilience", "circuit_close", circuit=self.name or "",
            )

    def record_failure(self) -> None:
        with self._lock:
            state = self._check_state()
            if state == self.HALF_OPEN:
                # failed probe: straight back to open, timer restarts
                self._state = self.OPEN
                self._opened_at = self._clock()
                _circuit_open.inc()
                _events.emit(
                    "resilience", "circuit_open", level="error",
                    circuit=self.name or "", probe_failed=True,
                )
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._state = self.OPEN
                self._opened_at = self._clock()
                _circuit_open.inc()
                _events.emit(
                    "resilience", "circuit_open", level="error",
                    circuit=self.name or "",
                    failures=self._failures,
                )

    def call(self, fn: Callable, *args, **kwargs):
        """Run ``fn`` under the breaker; raises :class:`CircuitOpenError`
        without calling when open."""
        if not self.allow():
            raise CircuitOpenError(
                f"circuit {self.name or fn.__name__!r} is open "
                f"({self.failure_threshold} consecutive failures; retry in "
                f"<= {self.reset_timeout:.1f}s)"
            )
        try:
            result = fn(*args, **kwargs)
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return result


class IdleBackoff:
    """Adaptive wait for poll loops: the timeout grows while the stream is
    idle and snaps back on activity. Replaces fixed ``timeout=0.2`` polls
    that wake 5x/second on streams that are quiet for hours (the log-mux
    busy loop).

    ``jitter`` shaves up to that fraction off each returned wait (drawn
    from a private seeded RNG, like :class:`RetryPolicy`), so many
    pollers backing off from the same event don't re-poll in lockstep —
    the gateway's QUEUE re-poll loop is the motivating caller."""

    def __init__(
        self,
        initial: float = 0.05,
        maximum: float = 1.0,
        multiplier: float = 2.0,
        jitter: float = 0.0,
        seed: Optional[int] = None,
    ):
        self.initial = initial
        self.maximum = maximum
        self.multiplier = multiplier
        self.jitter = jitter
        self._rng = random.Random(seed)
        self._current = initial

    def next_wait(self) -> float:
        """Current wait; each idle call grows the next one up to maximum."""
        wait = self._current
        self._current = min(self.maximum, self._current * self.multiplier)
        if self.jitter > 0:
            wait *= 1.0 - self.jitter * self._rng.random()
        return wait

    def reset(self) -> None:
        self._current = self.initial

    @property
    def current(self) -> float:
        return self._current
