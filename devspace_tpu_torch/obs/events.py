"""Structured, trace-correlated events — the third
observability pillar after metrics and traces.

Metrics say *how much*, traces say *where time went*; events say *what
happened*: the discrete lifecycle edges the engine / dispatcher / KV
tier / sync session / supervisor already handle but until now only
printed or counted (admit, preempt, poisoned window, spill, quarantine,
circuit-open, ...). Each :class:`Event` is auto-stamped with the
current ``trace_id``/``span_id`` from the tracer so an operator
can pivot from "what happened" straight to the request trace and
timeline that explain it.

Design constraints, in order:

1. **One branch when nothing listens.** ``emit()`` reads the sink tuple
   once and returns immediately when it is empty — event call sites can
   live on scheduler-thread paths without a measurable tax (covered by
   the <=2% serving-bench overhead guard in bench.py).
2. **Sinks are dumb and swappable.** A sink is anything with a
   ``record(event)`` method. The bus stores them in an immutable tuple
   swapped under a lock, so ``emit`` never locks; a raising sink is
   counted (``events_dropped_total``) and never breaks the emitter.
3. **Background threads lack request context.** The tracer's context
   stack is thread-local and the scheduler / monitor threads never see
   the HTTP thread's stack, so call sites that know their request pass
   ``trace_id=`` explicitly; auto-stamping is the fallback, not the
   only path.
4. **Names are machine-checked.** ``EVENT_CATALOG`` is the closed set
   of (subsystem, name) pairs; scripts/metrics_lint.py enforces
   snake_case and known subsystems the same way it lints metric
   families, so a typo'd event name fails in CI, not in an incident.

The port's copy of ``devspace_tpu/obs/events.py``, with the same behaviour; it
imports nothing of the JAX package.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional

from .metrics import get_registry
from .tracing import get_tracer

_LEVELS = ("debug", "info", "warn", "error")

# The known subsystems — an event outside this set fails the lint, and
# FlightRecorder rings are keyed by it.
EVENT_SUBSYSTEMS = (
    "cli",
    "dispatch",
    "engine",
    "fleet",
    "kv_tier",
    "resilience",
    "router",
    "serving",
    "slo",
    "supervisor",
    "sync",
)

# The closed event-name catalog: (subsystem, name, help). Linted by
# scripts/metrics_lint.py (snake_case names, known subsystem, unique
# pairs). Instrumentation sites emit ONLY names listed here.
EVENT_CATALOG = (
    ("cli", "log", "Leveled CLI log line routed through the event pipeline"),
    ("dispatch", "depth_change", "In-flight decode window count changed"),
    ("dispatch", "window_abandoned", "Queued dispatch windows dropped on abandon"),
    ("engine", "admit", "Request admitted to a decode slot"),
    ("engine", "preempt", "Lowest-priority slot preempted back to the queue"),
    ("engine", "poisoned_window", "Dispatched decode window raised; pool reset"),
    ("engine", "fail_outstanding", "Engine failing all outstanding requests"),
    ("engine", "request_failed", "One request failed (admission, prefill or decode)"),
    ("fleet", "scale_up", "Fleet manager adding replicas toward a higher target size"),
    ("fleet", "scale_down", "Fleet manager draining and removing surplus replicas"),
    ("fleet", "replica_started", "Fleet replica spawned and passed its readiness probe"),
    ("fleet", "replica_restarted", "Dead fleet replica restarted under the retry policy"),
    ("fleet", "replica_removed", "Fleet replica drained and terminated during scale-down"),
    ("kv_tier", "spill", "Evicted prefix blocks spilled to a lower KV tier"),
    ("kv_tier", "restore", "Spilled prefix blocks restored into the device pool"),
    ("kv_tier", "restore_fallback", "Tier restore failed; prefix recomputed"),
    ("kv_tier", "corrupt_drop", "Tier payload failed checksum and was dropped"),
    ("kv_tier", "migrate", "KV chain pulled from a peer replica and imported"),
    ("kv_tier", "migrate_failed", "KV chain pull failed; degrading to recompute-prefill"),
    ("kv_tier", "migrate_export", "KV chain envelope served to a peer replica"),
    ("resilience", "circuit_open", "Circuit breaker opened after repeated failures"),
    ("resilience", "circuit_close", "Circuit breaker closed after a probe success"),
    ("resilience", "retries_exhausted", "Retry policy gave up after max attempts"),
    ("router", "request_routed", "Gateway routed a request to a replica"),
    ("router", "spillover", "Request steered off its best prefix holder (it was hot)"),
    ("router", "request_rejected", "SLO-aware admission shed a request (breach band)"),
    ("router", "retry_rerouted", "Request rerouted after its replica failed before first byte"),
    ("router", "prefill_dispatched", "Two-phase placement: prompt prefilled on a separate replica"),
    ("router", "prefill_failed", "Phase-1 prefill call failed; degrading to unified placement"),
    ("serving", "drain_started", "Serving process entered drain mode (readyz 503, healthz live)"),
    ("serving", "drain_cleared", "Serving process left drain mode and readmits traffic"),
    ("slo", "warn", "SLO burn rate crossed the warn threshold"),
    ("slo", "breach", "SLO burn rate crossed the breach threshold"),
    ("slo", "recovered", "SLO returned to ok from warn/breach"),
    ("supervisor", "started", "Supervised service started"),
    ("supervisor", "died", "Supervised service died"),
    ("supervisor", "restarting", "Supervisor restarting a dead service"),
    ("supervisor", "restarted", "Supervised service restarted successfully"),
    ("supervisor", "degraded", "Service exceeded restart budget; running degraded"),
    ("supervisor", "budget_reset", "Service stayed healthy past its window; restart budget reset"),
    ("supervisor", "failed", "Supervised service failed permanently"),
    ("supervisor", "exited", "Supervised service exited cleanly"),
    ("supervisor", "stopped", "Supervisor stopped a service"),
    ("sync", "worker_quarantined", "Sync worker quarantined after repeated failures"),
    ("sync", "worker_revived", "Quarantined sync worker revived after probe"),
)

EVENTS_METRIC_FAMILIES = (
    ("events_emitted_total", "counter",
     "Structured events fanned out to at least one sink", "sum"),
    ("events_dropped_total", "counter",
     "Structured events a sink raised on (sink bug, full disk, ...)", "sum"),
)

# Keys owned by the envelope; attrs may not shadow them. "msg" stays an
# attr on purpose: utils/log.py writes {"time","level","msg",...} lines
# through this pipeline and downstream scrapers key on those three.
_RESERVED_KEYS = ("time", "level", "subsystem", "event", "trace_id", "span_id")


# Process-wide emission order. time.time() has finite resolution, so
# two events in one scheduler iteration often share a timestamp; the
# seq is the tie-break that keeps dump ordering stable.
_event_seq = itertools.count(1)


class Event:
    """One structured event. Immutable by convention; ``attrs`` is the
    free-form payload (small, JSON-serializable values only)."""

    __slots__ = ("ts", "level", "subsystem", "name", "attrs", "trace_id",
                 "span_id", "seq")

    def __init__(self, ts, level, subsystem, name, attrs=None,
                 trace_id=None, span_id=None, seq=None):
        self.ts = float(ts)
        self.level = level
        self.subsystem = subsystem
        self.name = name
        self.attrs = attrs or {}
        self.trace_id = trace_id
        self.span_id = span_id
        self.seq = int(seq) if seq is not None else next(_event_seq)

    def to_dict(self) -> dict:
        d = {
            "time": self.ts,
            "seq": self.seq,
            "level": self.level,
            "subsystem": self.subsystem,
            "event": self.name,
        }
        if self.trace_id:
            d["trace_id"] = self.trace_id
        if self.span_id:
            d["span_id"] = self.span_id
        for k, v in self.attrs.items():
            if k not in _RESERVED_KEYS:
                d[k] = v
        return d

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"Event({self.subsystem}.{self.name} level={self.level} "
                f"trace={self.trace_id} {self.attrs!r})")


def make_event(subsystem: str, name: str, level: str = "info",
               attrs: Optional[dict] = None,
               trace_id: Optional[str] = None,
               span_id: Optional[str] = None,
               clock: Callable[[], float] = time.time) -> Event:
    """Build a trace-stamped :class:`Event` without touching any bus —
    the constructor for sinks that originate their own events (the
    rebuilt utils/log.py FileLogger). When no explicit ids are given,
    stamps the calling thread's current tracer context."""
    if trace_id is None:
        ctx = get_tracer().current_context()
        if ctx is not None:
            trace_id, span_id = ctx.trace_id, ctx.span_id
    return Event(clock(), level, subsystem, name, attrs, trace_id, span_id)


class FlightRecorder:
    """Bounded per-subsystem ring of recent events, dumpable on demand
    (``/debug/events``, ``debug bundle``) or on failure (the engine dumps
    it when a dispatch window poisons). Cheap enough to leave attached
    in production: append to a deque under a short lock."""

    def __init__(self, per_subsystem: int = 256):
        self.per_subsystem = max(1, int(per_subsystem))
        self._rings: dict[str, deque] = {}
        self._lock = threading.Lock()

    def record(self, event: Event) -> None:
        with self._lock:
            ring = self._rings.get(event.subsystem)
            if ring is None:
                ring = self._rings[event.subsystem] = deque(
                    maxlen=self.per_subsystem
                )
            ring.append(event)

    def dump(self, subsystem: Optional[str] = None,
             limit: Optional[int] = None) -> list[Event]:
        """Recent events, oldest first, across all rings (or one
        subsystem's), trimmed to the newest ``limit``."""
        with self._lock:
            if subsystem is not None:
                events = list(self._rings.get(subsystem, ()))
            else:
                events = [e for ring in self._rings.values() for e in ring]
        # (ts, seq): equal timestamps are common (time.time() resolution
        # vs a tight scheduler loop) and a bare ts sort is only stable
        # WITHIN one ring — merging rings interleaved same-ts events in
        # ring-dict order. seq pins emission order across rings.
        events.sort(key=lambda e: (e.ts, e.seq))
        if limit is not None and limit >= 0:
            events = events[-limit:]
        return events

    def dump_dicts(self, subsystem: Optional[str] = None,
                   limit: Optional[int] = None) -> list[dict]:
        return [e.to_dict() for e in self.dump(subsystem, limit)]

    def subsystems(self) -> list[str]:
        with self._lock:
            return sorted(self._rings)

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()


class JsonlSink:
    """Append events to a JSONL file with the same 10 MB open-time
    rotation as the historical utils/log.py FileLogger (which is now a
    wrapper over this sink)."""

    MAX_BYTES = 10 * 1024 * 1024

    def __init__(self, path: str, max_bytes: int = MAX_BYTES):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        try:
            if os.path.getsize(path) > max_bytes:
                os.replace(path, path + ".old")
        except OSError:
            pass
        self._fh: Optional[io.TextIOBase] = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()

    @property
    def closed(self) -> bool:
        return self._fh is None or self._fh.closed

    def record(self, event: Event) -> None:
        line = json.dumps(event.to_dict(), default=str)
        with self._lock:
            if self._fh is None or self._fh.closed:
                return
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None and not self._fh.closed:
                self._fh.close()


class EventBus:
    """Fan-out point for structured events. ``emit`` is the API call
    sites use; sinks (FlightRecorder, JsonlSink, test lists) attach and
    detach at runtime. With no sinks attached, ``emit`` is one attribute
    read and one falsy branch — nothing is allocated."""

    def __init__(self, clock: Callable[[], float] = time.time):
        self._clock = clock
        self._sinks: tuple = ()
        self._lock = threading.Lock()
        self.emitted = 0  # GIL-atomic int counters, scraped via callback
        self.dropped = 0

    # -- sink management ----------------------------------------------------
    def add_sink(self, sink):
        """Attach ``sink`` (anything with ``record(event)``); returns it
        for `bus.add_sink(FlightRecorder())` one-liners."""
        with self._lock:
            if sink not in self._sinks:
                self._sinks = self._sinks + (sink,)
        return sink

    def remove_sink(self, sink) -> None:
        with self._lock:
            self._sinks = tuple(s for s in self._sinks if s is not sink)

    @property
    def active(self) -> bool:
        return bool(self._sinks)

    # -- emission -----------------------------------------------------------
    def emit(self, subsystem: str, name: str, level: str = "info",
             trace_id: Optional[str] = None, span_id: Optional[str] = None,
             **attrs) -> Optional[Event]:
        sinks = self._sinks
        if not sinks:  # the one branch when nothing listens
            return None
        if trace_id is None:
            ctx = get_tracer().current_context()
            if ctx is not None:
                trace_id, span_id = ctx.trace_id, ctx.span_id
        ev = Event(self._clock(), level, subsystem, name, attrs,
                   trace_id, span_id)
        self.publish(ev, _sinks=sinks)
        return ev

    def publish(self, event: Event, _sinks: Optional[tuple] = None) -> None:
        """Fan a prebuilt event out to the attached sinks (the path for
        events originated elsewhere, e.g. FileLogger lines)."""
        sinks = self._sinks if _sinks is None else _sinks
        if not sinks:
            return
        self.emitted += 1
        for s in sinks:
            try:
                s.record(event)
            except Exception:
                self.dropped += 1


# -- process-wide default bus ------------------------------------------------
_default_bus = EventBus()


def get_bus() -> EventBus:
    return _default_bus


def emit(subsystem: str, name: str, level: str = "info",
         trace_id: Optional[str] = None, span_id: Optional[str] = None,
         **attrs) -> Optional[Event]:
    """Emit on the process-default bus. Call sites import this once and
    call it unconditionally; the no-sink case is one branch inside."""
    bus = _default_bus
    if not bus._sinks:
        return None
    return bus.emit(subsystem, name, level=level,
                    trace_id=trace_id, span_id=span_id, **attrs)


def add_sink(sink):
    return _default_bus.add_sink(sink)


def remove_sink(sink) -> None:
    _default_bus.remove_sink(sink)


def events_enabled(explicit: Optional[bool] = None) -> bool:
    """Event pipeline on/off resolution, mirroring ``metrics_enabled``:
    explicit arg wins, then ``DEVSPACE_ENGINE_EVENTS`` (``off``/``0``/
    ... disables), default ON. Gates whether serve.py / bench.py attach
    sinks — emit sites themselves stay unconditional and free."""
    if explicit is not None:
        return bool(explicit)
    env = os.environ.get("DEVSPACE_ENGINE_EVENTS", "").strip().lower()
    return env not in ("off", "0", "false", "no")


def lint_catalog() -> list[str]:
    """Catalog validity errors ([] when clean) — shared by
    scripts/metrics_lint.py and the unit tests. Checks: snake_case
    names, known subsystem, non-empty help, unique (subsystem, name)."""
    import re

    name_re = re.compile(r"^[a-z][a-z0-9_]*$")
    errors: list[str] = []
    seen: set = set()
    for entry in EVENT_CATALOG:
        if len(entry) != 3:
            errors.append(f"catalog entry {entry!r}: want (subsystem, name, help)")
            continue
        subsystem, name, help_ = entry
        if subsystem not in EVENT_SUBSYSTEMS:
            errors.append(f"{subsystem}.{name}: unknown subsystem {subsystem!r}")
        if not name_re.match(name or ""):
            errors.append(f"{subsystem}.{name}: event name not snake_case")
        if "-" in (name or "") or "-" in (subsystem or ""):
            errors.append(f"{subsystem}.{name}: kebab-case is not allowed")
        if not help_ or not str(help_).strip():
            errors.append(f"{subsystem}.{name}: empty help text")
        key = (subsystem, name)
        if key in seen:
            errors.append(f"{subsystem}.{name}: duplicate catalog entry")
        seen.add(key)
    return errors


def _register_metrics() -> None:
    reg = get_registry()
    emitted_name, _, emitted_help, _agg = EVENTS_METRIC_FAMILIES[0]
    dropped_name, _, dropped_help, _agg = EVENTS_METRIC_FAMILIES[1]
    reg.register_callback(
        emitted_name, "counter", emitted_help, lambda: _default_bus.emitted
    )
    reg.register_callback(
        dropped_name, "counter", dropped_help, lambda: _default_bus.dropped
    )


_register_metrics()
