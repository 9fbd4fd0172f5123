"""Retry with exponential backoff.

The port's own copy of ``RetryExhausted`` and ``RetryPolicy`` from
``devspace_tpu/resilience/policy.py``, with the same semantics: attempts,
delays, the optional deadline and the seeded jitter stream are those of
the reference, so a fixed seed gives the same delay schedule in both
packages. The reference's process-wide counters, events and trace
re-attachment wait for the port's observability slice.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional


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
        sites whose callers dispatch on the original exception type)."""
        start = clock()
        last: Optional[BaseException] = None
        delays = self.delays()
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:  # noqa: PERF203 — retry is the point
                last = e
            try:
                delay = next(delays)
            except StopIteration:
                break
            if self.deadline is not None and clock() - start + delay > self.deadline:
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
            sleep(delay)
        if reraise:
            raise last
        raise RetryExhausted(
            f"{describe} failed after {self.max_attempts} attempt(s): {last}",
            last=last,
            attempts=self.max_attempts,
        ) from last
