"""Runtime tripwires matching the static packs: the dynamic halves.

The port's counterpart of ``devspace_tpu/lint/runtime.py``, under the
same names. Static analysis catches the *patterns*; these catch the
*occurrences*, including ones the patterns miss (a program key that
drifts with the traffic, a lock order only a rare schedule produces).

- :class:`CompileWatch` counts program builds. In the reference a
  "compile" is an XLA compilation; here it is what
  ``inference.graphs.ProgramTable.captures`` counts: a CUDA-graph capture
  on the card, a program's first use on the CPU. Every table of the
  process (each engine's, each rank's under a mesh) adds its builds to
  the process-wide ``graphs.CAPTURES``, and a watch reads deltas off it.
  The port never calls ``torch.compile``, so nothing else is counted.
  Wrap a hot loop, ``reset()`` after warm-up (or ``prewarm()``), then
  ``assert_no_recompiles()``: a capture after that is a hot-path
  recapture, the counterpart of the reference's PR 7 recompile.

- :class:`OrderedLock` + :class:`LockOrderMonitor` record real lock
  acquisition order per thread and flag *inversions*: acquiring B while
  holding A after some thread acquired A while holding B. ``compare()``
  also diffs the runtime edges against a module's static graph
  (``rules_concurrency.extract_lock_graph``), so a runtime order that
  contradicts the declared discipline is caught even before the
  opposite schedule ever runs. A plain copy of the reference's.

Both are cheap enough to leave attached in tests and smoke runs.
"""

from __future__ import annotations

import threading
from typing import Optional

__all__ = [
    "CompileWatch",
    "LockOrderMonitor",
    "LockOrderViolation",
    "OrderedLock",
    "RecompileError",
    "compile_count",
    "get_monitor",
]

# -- CompileWatch ---------------------------------------------------------


def compile_count() -> int:
    """Programs built in this process so far by every ``ProgramTable``
    (monotone)."""
    from ..inference import graphs

    return graphs.CAPTURES


class RecompileError(AssertionError):
    """Raised by :meth:`CompileWatch.assert_no_recompiles`."""


class CompileWatch:
    """Count program builds (graph captures) across a region.

    ::

        engine.prewarm()
        with CompileWatch("serving") as watch:
            run_hot_loop()
        watch.assert_no_recompiles()   # raises RecompileError otherwise

    Also usable un-entered (``watch.start()`` / ``watch.stop()``) for
    legs that bracket phases manually; ``reset()`` inside the region
    forgets the builds of a warm-up. ``count`` is valid both inside and
    after the region.
    """

    def __init__(self, label: str = ""):
        self.label = label
        self._start: Optional[int] = None
        self._count: Optional[int] = None

    def start(self) -> "CompileWatch":
        self._start = compile_count()
        self._count = None
        return self

    def reset(self) -> None:
        """Forget builds so far (the post-warm-up zero point)."""
        if self._start is None:
            raise RuntimeError("CompileWatch not started")
        self._start = compile_count()

    def stop(self) -> int:
        if self._start is None:
            raise RuntimeError("CompileWatch not started")
        self._count = compile_count() - self._start
        return self._count

    @property
    def count(self) -> int:
        if self._count is not None:
            return self._count
        if self._start is None:
            return 0
        return compile_count() - self._start

    def assert_no_recompiles(self) -> None:
        n = self.count
        if n > 0:
            label = f" [{self.label}]" if self.label else ""
            raise RecompileError(
                f"CompileWatch{label}: {n} program build(s) (CUDA-graph "
                "captures) in a region declared capture-free — a program "
                "key reached serving that prewarm did not build"
            )

    def __enter__(self) -> "CompileWatch":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- OrderedLock ----------------------------------------------------------


class LockOrderViolation:
    """One detected inversion: ``thread`` acquired ``inner`` while
    holding ``outer``, but the opposite order was observed earlier (or
    declared by the static graph)."""

    def __init__(self, outer: str, inner: str, thread: str, source: str):
        self.outer = outer
        self.inner = inner
        self.thread = thread
        self.source = source  # "runtime" | "static"

    def __repr__(self) -> str:
        return (
            f"LockOrderViolation({self.outer!r} -> {self.inner!r}, "
            f"thread={self.thread!r}, vs {self.source} order "
            f"{self.inner!r} -> {self.outer!r})"
        )

    def key(self) -> tuple:
        return (self.outer, self.inner, self.source)


class LockOrderMonitor:
    """Records runtime lock-acquisition order and detects inversions.

    Pure bookkeeping — never blocks a caller and never raises from the
    lock path; violations accumulate for the harness to assert on
    (``violations()``).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._held = threading.local()
        # (outer, inner) -> first thread name that produced the edge
        self.edges: dict = {}
        self._violations: list[LockOrderViolation] = []

    def _stack(self) -> list:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    # -- hooks driven by OrderedLock ------------------------------------
    def note_acquired(self, name: str) -> None:
        stack = self._stack()
        tname = threading.current_thread().name
        with self._lock:
            for outer in stack:
                if outer == name:
                    continue
                self.edges.setdefault((outer, name), tname)
                if (name, outer) in self.edges:
                    v = LockOrderViolation(outer, name, tname, "runtime")
                    if all(
                        x.key() != v.key() for x in self._violations
                    ):
                        self._violations.append(v)
        stack.append(name)

    def note_released(self, name: str) -> None:
        stack = self._stack()
        # locks can release out of stack order; remove the newest match
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                break

    # -- results --------------------------------------------------------
    def violations(self) -> list:
        with self._lock:
            return list(self._violations)

    def ordered_edges(self) -> list:
        with self._lock:
            return sorted(self.edges)

    def compare(self, static_graph) -> list:
        """Diff runtime order against a static
        :class:`~devspace_tpu_torch.lint.rules_concurrency.LockGraph`:
        every runtime edge (A, B) whose *reverse* is a static edge is an
        inversion the static analyzer predicted from the other side.
        Lock names are matched on their terminal component
        (``Class._lock`` vs an OrderedLock named ``_lock``)."""
        if static_graph is None:
            return []

        def tails(pair):
            return tuple(p.rsplit(".", 1)[-1] for p in pair)

        static_edges = {tails(e) for e in static_graph.edges}
        out = []
        with self._lock:
            for (a, b), tname in sorted(self.edges.items()):
                ta, tb = tails((a, b))
                if ta == tb:
                    continue
                if (tb, ta) in static_edges and (ta, tb) not in static_edges:
                    v = LockOrderViolation(a, b, tname, "static")
                    if all(
                        x.key() != v.key()
                        for x in self._violations + out
                    ):
                        out.append(v)
        return out

    def reset(self) -> None:
        with self._lock:
            self.edges.clear()
            self._violations.clear()


_default_monitor = LockOrderMonitor()


def get_monitor() -> LockOrderMonitor:
    return _default_monitor


class OrderedLock:
    """A ``threading.Lock``/``RLock`` wrapper that reports acquisition
    order to a :class:`LockOrderMonitor`. Drop-in for the `with` idiom
    and acquire/release; the monitor defaults to the process-wide one
    so independently-instrumented subsystems share an order graph."""

    def __init__(
        self,
        name: str,
        monitor: Optional[LockOrderMonitor] = None,
        reentrant: bool = False,
    ):
        self.name = name
        self.monitor = monitor or _default_monitor
        self._lock = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)  # lint: allow(CON604) — this IS the lock wrapper
        if got:
            self.monitor.note_acquired(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        self.monitor.note_released(self.name)

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._lock, "locked", None)
        return bool(locked()) if locked is not None else False
