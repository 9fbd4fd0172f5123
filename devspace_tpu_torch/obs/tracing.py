"""Distributed tracing: real span model + engine timeline profiler.

Three layers, smallest first:

- **SpanContext** — W3C Trace Context identity (128-bit ``trace_id``,
  64-bit ``span_id``) with ``traceparent`` encode/decode. The header is
  the ONLY thing that crosses a process boundary (HTTP request into
  serve.py, the sync session's remote-exec boundary), so the parse is
  strict: a malformed header yields ``None`` and the receiver starts a
  fresh trace rather than propagating garbage ids.

- **Tracer** — owns a thread-local context stack and a bounded ring of
  finished :class:`Span` records. Spans nest per thread; an explicit
  ``context=`` argument re-attaches a context captured in another
  thread (the sync fan-out pool) or another process (a parsed
  ``traceparent``). The clock and the id source are injectable so the
  golden parentage tests assert exact ids and durations.
  ``utils/trace.py`` keeps its old API as a shim over this layer: its
  ``span()`` delegates id/parent management here and mirrors the
  legacy dict shape into its own ring.

- **TimelineRecorder** — the on-demand engine profiler's event sink.
  While attached (``engine.start_timeline()`` / ``/debug/trace``),
  the serving loop's phases land on named Chrome-trace tracks —
  device decode chunks per window lane, host scheduling, readback
  waits, tier restores, prefill chunks — so the overlapped
  dispatcher's concurrency is *visually verifiable*: decode lanes and
  the host-sched lane overlap in wall time in ``chrome://tracing`` /
  Perfetto. Off (the default) it is a single ``is None`` check per
  hook site — nothing on the hot path.

The port's copy of ``devspace_tpu/obs/tracing.py``, with the same behaviour; it
imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator, Optional

# (name, kind, help) — lintable catalog (scripts/metrics_lint.py).
# trace_spans_dropped_total stays in utils/trace.py (its ring, its
# counter); these cover the new layer: span volume and timeline exports.
TRACING_METRIC_FAMILIES = (
    (
        "trace_spans_started_total",
        "counter",
        "Spans opened on the process-wide tracer",
        "sum",
    ),
    (
        "trace_timeline_exports_total",
        "counter",
        "Engine timeline captures rendered to Chrome-trace JSON",
        "sum",
    ),
)

_FLAG_SAMPLED = "01"


def new_trace_id(rand: Callable[[int], bytes] = os.urandom) -> str:
    """128-bit lowercase-hex trace id (W3C: all-zero is invalid)."""
    tid = rand(16).hex()
    return tid if int(tid, 16) else new_trace_id(rand)


def new_span_id(rand: Callable[[int], bytes] = os.urandom) -> str:
    """64-bit lowercase-hex span id (W3C: all-zero is invalid)."""
    sid = rand(8).hex()
    return sid if int(sid, 16) else new_span_id(rand)


def derive_span_id(parent_span_id: str, name: str) -> str:
    """Deterministic child span id — a pure function of (parent id,
    child name), so replays and the golden parentage tests get stable
    ids without threading an id source everywhere."""
    import hashlib

    return hashlib.blake2b(
        f"{parent_span_id}/{name}".encode(), digest_size=8
    ).hexdigest()


def _is_hex(s: str) -> bool:
    try:
        int(s, 16)
        return True
    except ValueError:
        return False


class SpanContext:
    """Immutable (trace_id, span_id) identity pair."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"SpanContext({self.trace_id}, {self.span_id})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SpanContext)
            and self.trace_id == other.trace_id
            and self.span_id == other.span_id
        )

    def __hash__(self) -> int:
        return hash((self.trace_id, self.span_id))

    def to_traceparent(self) -> str:
        """W3C header: ``00-<trace_id>-<span_id>-01``."""
        return f"00-{self.trace_id}-{self.span_id}-{_FLAG_SAMPLED}"

    @classmethod
    def from_traceparent(cls, header: Optional[str]) -> Optional["SpanContext"]:
        """Strict W3C parse; ``None`` for anything malformed (the caller
        then starts a fresh trace — never propagate a bad id)."""
        if not header or not isinstance(header, str):
            return None
        parts = header.strip().split("-")
        if len(parts) != 4:
            return None
        version, trace_id, span_id, flags = parts
        if len(version) != 2 or not _is_hex(version) or version == "ff":
            return None
        if len(trace_id) != 32 or not _is_hex(trace_id) or not int(trace_id, 16):
            return None
        if len(span_id) != 16 or not _is_hex(span_id) or not int(span_id, 16):
            return None
        if len(flags) != 2 or not _is_hex(flags):
            return None
        if trace_id != trace_id.lower() or span_id != span_id.lower():
            return None
        return cls(trace_id, span_id)

    @classmethod
    def generate(cls, rand: Callable[[int], bytes] = os.urandom) -> "SpanContext":
        return cls(new_trace_id(rand), new_span_id(rand))


class Span:
    """One finished-or-running span. ``start`` is wall-clock seconds;
    ``duration_s`` is filled at close from the tracer's perf clock."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start",
        "duration_s", "track", "attrs", "ok", "error", "_t0",
    )

    def __init__(
        self,
        name: str,
        context: SpanContext,
        parent_id: Optional[str],
        start: float,
        track: str = "main",
        attrs: Optional[dict] = None,
    ):
        self.name = name
        self.trace_id = context.trace_id
        self.span_id = context.span_id
        self.parent_id = parent_id
        self.start = start
        self.duration_s: Optional[float] = None
        self.track = track
        self.attrs = attrs if attrs is not None else {}
        self.ok: Optional[bool] = None
        self.error: Optional[str] = None
        self._t0: float = 0.0

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_id,
            "start": self.start,
            "duration_s": self.duration_s,
            "track": self.track,
            "ok": self.ok,
        }
        if self.error:
            d["error"] = self.error
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class Tracer:
    """Thread-local span stack + bounded keep-newest ring of finished
    spans. One process-wide instance (:func:`get_tracer`); tests build
    private ones with deterministic clocks and id sources."""

    def __init__(
        self,
        clock: Callable[[], float] = time.time,
        perf: Callable[[], float] = time.perf_counter,
        ring: int = 2048,
        rand: Callable[[int], bytes] = os.urandom,
    ):
        self.clock = clock
        self.perf = perf
        self.rand = rand
        self._ring_size = ring
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.started = 0  # trace_spans_started_total
        self.dropped = 0

    # -- context -----------------------------------------------------------
    def _stack(self) -> list[SpanContext]:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def current_context(self) -> Optional[SpanContext]:
        stack = self._stack()
        return stack[-1] if stack else None

    def current_traceparent(self) -> Optional[str]:
        ctx = self.current_context()
        return ctx.to_traceparent() if ctx else None

    @contextmanager
    def attach(self, context: Optional[SpanContext]) -> Iterator[None]:
        """Activate an externally-captured context on THIS thread without
        recording a span — the re-attachment primitive for thread pools
        (sync fan-out) and retry loops (resilience/policy.py). A None
        context is a no-op, so call sites don't need to branch."""
        if context is None:
            yield
            return
        stack = self._stack()
        stack.append(context)
        try:
            yield
        finally:
            stack.pop()

    # -- spans -------------------------------------------------------------
    def start_span(
        self,
        name: str,
        context: Optional[SpanContext] = None,
        track: str = "main",
        attrs: Optional[dict] = None,
        push: bool = True,
    ) -> Span:
        """Open a span and push its context; pair with :meth:`end_span`
        (use :meth:`span` unless the open/close sites are in different
        scopes, like the per-request serving lifecycle). ``push=False``
        creates a DETACHED span — not on any thread's stack — for spans
        that outlive their opening thread (a sync session's root);
        children attach its ``.context`` explicitly."""
        parent = context if context is not None else self.current_context()
        if parent is not None:
            ctx = SpanContext(parent.trace_id, new_span_id(self.rand))
            parent_id = parent.span_id
        else:
            ctx = SpanContext.generate(self.rand)
            parent_id = None
        sp = Span(name, ctx, parent_id, self.clock(), track=track, attrs=attrs)
        sp._t0 = self.perf()
        if push:
            self._stack().append(ctx)
        self.started += 1
        return sp

    def end_span(
        self, sp: Span, ok: bool = True, error: Optional[str] = None
    ) -> None:
        sp.duration_s = round(self.perf() - sp._t0, 6)
        sp.ok = ok
        sp.error = error
        stack = self._stack()
        if stack and stack[-1].span_id == sp.span_id:
            stack.pop()
        else:  # closed out of order (cross-thread end): scrub, don't leak
            for i in range(len(stack) - 1, -1, -1):
                if stack[i].span_id == sp.span_id:
                    del stack[i]
                    break
        self._record(sp)

    @contextmanager
    def span(
        self,
        name: str,
        context: Optional[SpanContext] = None,
        track: str = "main",
        **attrs: Any,
    ) -> Iterator[Span]:
        """Context-manager form; exceptions mark the span failed and
        propagate."""
        sp = self.start_span(name, context=context, track=track, attrs=attrs)
        try:
            yield sp
        except BaseException as e:
            self.end_span(sp, ok=False, error=f"{type(e).__name__}: {e}")
            raise
        else:
            self.end_span(sp, ok=True)

    def _record(self, sp: Span) -> None:
        with self._lock:
            self._spans.append(sp)
            evicted = len(self._spans) - self._ring_size
            if evicted > 0:
                self.dropped += evicted
                del self._spans[:evicted]

    # -- views -------------------------------------------------------------
    def recent(self, limit: int = 50) -> list[Span]:
        with self._lock:
            return list(self._spans[-limit:])

    def find(self, trace_id: str) -> list[Span]:
        """All ring-resident spans of one trace, oldest first."""
        with self._lock:
            return [s for s in self._spans if s.trace_id == trace_id]


_default_tracer = Tracer()


def get_tracer() -> Tracer:
    return _default_tracer


def current_traceparent() -> Optional[str]:
    """The default tracer's active context as a ``traceparent`` header
    (None outside any span) — what call sites inject at process/exec
    boundaries."""
    return _default_tracer.current_traceparent()


# -- engine timeline profiler ----------------------------------------------

# Canonical lane (Chrome ``tid``) names the serving-loop profiler emits.
# Device decode gets one lane per dispatch-window position so overlapping
# chunks render side by side instead of merging into one bar.
TRACK_HOST_SCHED = "host sched"
TRACK_READBACK = "readback wait"
TRACK_TIER_RESTORE = "tier restore"
TRACK_PREFILL = "prefill"
TRACK_SPEC = "spec round"
TRACK_REQUESTS = "serving"

TIMELINE_TRACKS = (
    TRACK_HOST_SCHED,
    TRACK_READBACK,
    TRACK_TIER_RESTORE,
    TRACK_PREFILL,
    TRACK_SPEC,
    TRACK_REQUESTS,
)


def device_decode_track(lane: int) -> str:
    """Lane name for a dispatch-window position (0..depth-1)."""
    return f"device decode/{int(lane)}"


class TimelineRecorder:
    """Bounded event sink for one capture window. ``add`` is called from
    the scheduler thread (and dispatch drains) with ``time.monotonic``
    endpoints; ``chrome()`` rebases onto the capture's wall-clock start.
    Appends are GIL-atomic list ops — no lock on the recording path."""

    def __init__(self, max_events: int = 100_000):
        self.max_events = max_events
        self.events: list[dict] = []
        self.dropped = 0
        self._wall0 = time.time()
        self._mono0 = time.monotonic()

    def add(
        self, track: str, name: str, t0: float, t1: float, **args: Any
    ) -> None:
        """One complete event on ``track`` spanning monotonic [t0, t1]."""
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(
            {"track": track, "name": name, "t0": t0, "t1": t1, "args": args}
        )

    def chrome(self) -> dict:
        """Chrome-trace JSON object (``chrome://tracing`` / Perfetto).
        Every event lands on its named track (string ``tid``); a
        malformed track name is an exporter bug, rejected loudly."""
        events = []
        for e in self.events:
            track = e["track"]
            if not isinstance(track, str) or not track.strip():
                raise ValueError(
                    f"timeline event {e['name']!r} has an unnamed track"
                )
            events.append(
                {
                    "name": e["name"],
                    "cat": "engine",
                    "ph": "X",
                    "ts": (e["t0"] - self._mono0) * 1e6,
                    "dur": max(0.0, (e["t1"] - e["t0"]) * 1e6),
                    "pid": 1,
                    "tid": track,
                    "args": e["args"],
                }
            )
        # process/thread metadata so the lanes render with their names
        # in a stable order
        tracks = sorted({e["tid"] for e in events})
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": 1,
                "args": {"name": "devspace-tpu engine"},
            }
        ]
        for i, tr in enumerate(tracks):
            meta.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 1,
                    "tid": tr,
                    "args": {"name": tr},
                }
            )
            meta.append(
                {"name": "thread_sort_index", "ph": "M", "pid": 1,
                 "tid": tr, "args": {"sort_index": i}}
            )
        global _timeline_exports
        _timeline_exports += 1
        return {
            "traceEvents": meta + events,
            "displayTimeUnit": "ms",
            "metadata": {
                "capture_wall_start": self._wall0,
                "events": len(events),
                "dropped": self.dropped,
            },
        }

    def write_chrome(self, dest: str) -> int:
        doc = self.chrome()
        with open(dest, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        return len(doc["traceEvents"])


def lint_tracks(extra_depth: int = 8) -> list[str]:
    """Track-catalog lint (scripts/metrics_lint.py): every declared lane
    name must be nonempty and unique — a duplicated ``tid`` silently
    merges two semantic lanes in the Chrome UI; an empty one renders as
    an anonymous row. Checks the static catalog plus the dynamic decode
    lanes up to ``extra_depth``."""
    problems: list[str] = []
    names = list(TIMELINE_TRACKS) + [
        device_decode_track(i) for i in range(extra_depth)
    ]
    seen: set[str] = set()
    for n in names:
        if not isinstance(n, str) or not n.strip():
            problems.append(f"timeline track {n!r}: unnamed track")
            continue
        if n in seen:
            problems.append(f"timeline track {n!r}: duplicated track name")
        seen.add(n)
    return problems


_timeline_exports = 0


def _register_metrics() -> None:
    try:
        from .metrics import get_registry

        reg = get_registry()
        spans_name, _, spans_help, _agg = TRACING_METRIC_FAMILIES[0]
        exports_name, _, exports_help, _agg = TRACING_METRIC_FAMILIES[1]
        reg.register_callback(
            spans_name, "counter", spans_help,
            lambda: _default_tracer.started,
        )
        reg.register_callback(
            exports_name, "counter", exports_help,
            lambda: _timeline_exports,
        )
    except Exception:  # noqa: BLE001 — metrics are optional here
        pass


_register_metrics()
