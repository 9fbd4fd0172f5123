"""Span tracing for the dev loop — build/deploy phases.

The port's copy of ``devspace_tpu/utils/trace.py``. The reference has NO
tracing (SURVEY §5.1: "no pprof endpoints, no spans"); here every
pipeline phase runs inside a span, spans nest, and the trace lands in
``.devspace/logs/trace.jsonl`` (one JSON object per span) plus an
optional Chrome ``chrome://tracing`` export. ``span()`` takes its
identity and parentage from the process tracer (``obs/tracing.py``), so
every record also carries ``trace_id`` / ``span_id`` /
``parent_span_id``. Overhead is a clock read and one dict per span.

Ring evictions are counted by :func:`dropped`, which ``status trace``
reports; unlike the reference, the count is not registered as a metric
family of the process registry (the port's metric catalogs hold the
serving side only, ``lint.rules_obs.load_metric_catalogs``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Iterator, Optional

_lock = threading.Lock()
_trace_path: Optional[str] = None
_spans: list[dict] = []  # in-memory ring (also used by `status trace`)
_MAX_SPANS = 2000
_spans_dropped = 0  # ring evictions (surfaced by `status trace` + /metrics)
_tls = threading.local()

def enable(devspace_dir: str) -> None:
    """Start writing spans under ``<devspace_dir>/logs/trace.jsonl``."""
    global _trace_path
    logs = os.path.join(devspace_dir, "logs")
    os.makedirs(logs, exist_ok=True)
    _trace_path = os.path.join(logs, "trace.jsonl")


def disable() -> None:
    global _trace_path
    _trace_path = None


def _stack() -> list[str]:
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


_LEGACY_KEYS = (
    "name", "parent", "thread", "start",
    "trace_id", "span_id", "parent_span_id", "duration_s",
)


@contextmanager
def span(name: str, **attrs: Any) -> Iterator[dict]:
    """Time a phase. Nested spans record their parent; the yielded dict can
    be updated with extra attributes mid-span.

    Identity (trace_id/span_id/parent_span_id) comes from the process
    tracer (obs/tracing.py): nesting follows the tracer's thread-local
    context, including contexts re-attached across thread pools or
    parsed from a ``traceparent`` header — the legacy name-based
    ``parent`` field is kept alongside for old consumers."""
    from ..obs import tracing as _tracing  # lazy: avoid import cycles

    tracer = _tracing.get_tracer()
    parent = _stack()[-1] if _stack() else None
    _stack().append(name)
    sp = tracer.start_span(name, attrs=dict(attrs))
    record: dict[str, Any] = {
        "name": name,
        "parent": parent,
        "thread": threading.current_thread().name,
        "start": sp.start,
        **attrs,
        "trace_id": sp.trace_id,
        "span_id": sp.span_id,
        "parent_span_id": sp.parent_id,
    }
    t0 = time.perf_counter()
    try:
        yield record
        record["ok"] = True
    except BaseException as e:
        record["ok"] = False
        record["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        _stack().pop()
        record["duration_s"] = round(time.perf_counter() - t0, 6)
        # mirror caller-added attributes onto the real span, then close it
        sp.attrs.update(
            {k: v for k, v in record.items() if k not in _LEGACY_KEYS}
        )
        tracer.end_span(
            sp, ok=record.get("ok", False), error=record.get("error")
        )
        _emit(record)


def _emit(record: dict) -> None:
    global _spans_dropped
    with _lock:
        _spans.append(record)
        evicted = len(_spans) - _MAX_SPANS
        if evicted > 0:
            # rotate keeping the NEWEST spans; count what fell off so
            # `status trace` can say the view is partial
            _spans_dropped += evicted
            del _spans[:evicted]
        path = _trace_path
    if path:
        try:
            with open(path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(record) + "\n")
        except OSError:
            pass


def recent(limit: int = 50) -> list[dict]:
    with _lock:
        return list(_spans[-limit:])


def dropped() -> int:
    """Spans evicted from the in-memory ring so far (this process)."""
    with _lock:
        return _spans_dropped


def load(devspace_dir: str) -> list[dict]:
    """Read spans back from the trace file (newest last)."""
    path = os.path.join(devspace_dir, "logs", "trace.jsonl")
    out = []
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return out


def chrome_events(spans: list[dict]) -> list[dict]:
    """Span dicts -> chrome://tracing ``traceEvents`` (complete events).
    Shared by the dev-loop trace export and the serving request-trace
    export (obs/request_trace.py)."""
    events = []
    for s in spans:
        events.append(
            {
                "name": s.get("name", "?"),
                "cat": "devspace",
                "ph": "X",  # complete event
                "ts": s.get("start", 0) * 1e6,
                "dur": s.get("duration_s", 0) * 1e6,
                "pid": 1,
                "tid": s.get("thread", "main"),
                "args": {
                    k: v
                    for k, v in s.items()
                    if k not in ("name", "start", "duration_s", "thread")
                },
            }
        )
    return events


def write_chrome(spans: list[dict], dest: str) -> int:
    """Write spans as a chrome://tracing / Perfetto-compatible trace file.
    Returns the number of events written."""
    events = chrome_events(spans)
    with open(dest, "w", encoding="utf-8") as fh:
        json.dump({"traceEvents": events}, fh)
    return len(events)


def export_chrome(devspace_dir: str, dest: str) -> int:
    """Write a chrome://tracing / Perfetto-compatible trace. Returns the
    number of events written."""
    return write_chrome(load(devspace_dir), dest)
