"""Per-request serving lifecycle traces + the latency histograms.

`ServingTelemetry` is the engine's observer: the
scheduler calls its ``on_*`` hooks at each lifecycle transition
(enqueue -> admit -> prefill chunks -> first token -> decode ->
finish/preempt/fail) and it derives the latency distributions a serving
operator actually pages on:

- ``queue_wait_seconds``  enqueue -> first admission
- ``prefill_seconds``     first admission -> prefill complete
- ``ttft_seconds``        enqueue -> first generated token
- ``tpot_seconds``        mean inter-token time after the first token,
                          observed once per completed request
- ``request_e2e_seconds`` enqueue -> completion

plus ``requests_finished_total{outcome}``. A bounded ring of recent
:class:`RequestTrace` objects backs ``/debug/requests`` on the serving
example and exports as JSONL or through the Chrome-trace writer shared
with ``utils/trace.py``.

Hot-path discipline: ``on_emit`` runs once per generated token and does
a clock read plus three attribute writes — no locks, no allocation
(events are only appended for state TRANSITIONS, never per token).
Histogram observes happen at transition points only. The clock is
injectable so tests assert hand-computed TTFT/TPOT values exactly.

Thread model: hooks are called by the scheduler thread (and ``on_submit``
by client threads); readers (``/debug/requests``, scrapes) see
GIL-atomic field reads. Traces attach to the Request object itself
(``req._obs_trace``) so preemption/re-admission naturally continues the
same trace.

The port's copy of ``devspace_tpu/obs/request_trace.py``, with the same behaviour; it
imports nothing of the JAX package. ``export_chrome`` is left out: the
timeline's Chrome trace (``obs/tracing.py``) is the port's trace export.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Optional

from .metrics import Registry
from .tracing import SpanContext, derive_span_id, new_trace_id

# (name, kind, help) — the lintable catalog (scripts/metrics_lint.py);
# ServingTelemetry registers EXACTLY these so spec and registration
# cannot drift.
SERVING_METRIC_FAMILIES = (
    (
        "ttft_seconds",
        "histogram",
        "Time from request enqueue to its first generated token",
        "sum",
    ),
    (
        "tpot_seconds",
        "histogram",
        "Mean time per output token after the first, per completed request",
        "sum",
    ),
    (
        "queue_wait_seconds",
        "histogram",
        "Time from request enqueue to its first slot admission",
        "sum",
    ),
    (
        "prefill_seconds",
        "histogram",
        "Time from first admission to prefill completion (chunked prefill)",
        "sum",
    ),
    (
        "request_e2e_seconds",
        "histogram",
        "Time from request enqueue to completion",
        "sum",
    ),
    (
        "requests_finished_total",
        "counter",
        "Terminal request outcomes by kind (completed/failed)",
        "sum",
    ),
)

_MAX_EVENTS = 64  # per-trace event cap (preempt/re-admit churn bound)


class RequestTrace:
    """One request's lifecycle record: a bounded event list (name,
    t_monotonic) plus the timestamps the derived latencies need."""

    __slots__ = (
        "id", "prompt_len", "max_new_tokens", "events", "t_wall_enqueue",
        "t_enqueue", "t_admit", "t_prefill_done", "t_first", "t_last",
        "n_tokens", "preemptions", "outcome",
        "trace_id", "span_id", "parent_span_id",
    )

    def __init__(self, rid: int, prompt_len: int, max_new_tokens: int, now: float):
        self.id = rid
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.events: list[tuple[str, float]] = []
        self.t_wall_enqueue = time.time()
        self.t_enqueue = now
        self.t_admit: Optional[float] = None
        self.t_prefill_done: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.n_tokens = 0
        self.preemptions = 0
        self.outcome: Optional[str] = None
        # distributed-trace identity: set by ServingTelemetry
        # from the request's inbound traceparent (or freshly minted)
        self.trace_id: Optional[str] = None
        self.span_id: Optional[str] = None
        self.parent_span_id: Optional[str] = None

    def event(self, name: str, t: float) -> None:
        if len(self.events) < _MAX_EVENTS:
            self.events.append((name, t))

    # -- derived latencies -------------------------------------------------
    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admit is None:
            return None
        return self.t_admit - self.t_enqueue

    @property
    def prefill_s(self) -> Optional[float]:
        if self.t_prefill_done is None or self.t_admit is None:
            return None
        return self.t_prefill_done - self.t_admit

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return self.t_first - self.t_enqueue

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean inter-token time after the first token; needs >= 2."""
        if self.t_first is None or self.t_last is None or self.n_tokens < 2:
            return None
        return (self.t_last - self.t_first) / (self.n_tokens - 1)

    def e2e_s(self, t_end: float) -> float:
        return t_end - self.t_enqueue

    def to_dict(self) -> dict:
        end = self.events[-1][1] if self.events else self.t_enqueue

        def r(v):
            return round(v, 6) if v is not None else None

        return {
            "id": self.id,
            "trace_id": self.trace_id,
            "prompt_len": self.prompt_len,
            "max_new_tokens": self.max_new_tokens,
            "tokens_generated": self.n_tokens,
            "preemptions": self.preemptions,
            "outcome": self.outcome,  # None while in flight
            "queue_wait_s": r(self.queue_wait_s),
            "prefill_s": r(self.prefill_s),
            "ttft_s": r(self.ttft_s),
            "tpot_s": r(self.tpot_s),
            "e2e_s": r(self.e2e_s(end)) if self.outcome else None,
            "events": [
                (name, round(t - self.t_enqueue, 6)) for name, t in self.events
            ],
        }

    def to_spans(self) -> list[dict]:
        """utils/trace.py-shaped span dicts (one per lifecycle phase) so
        the existing Chrome-trace writer renders request timelines.
        Monotonic offsets are rebased onto the wall-clock enqueue time."""

        def wall(t_mono: float) -> float:
            return self.t_wall_enqueue + (t_mono - self.t_enqueue)

        spans = []

        root_sid = self.span_id or (
            derive_span_id(self.trace_id or "", f"request-{self.id}")
        )

        def phase(name, t0, t1, **attrs):
            if t0 is None or t1 is None:
                return
            spans.append(
                {
                    "name": name,
                    "parent": f"request-{self.id}",
                    "thread": "serving",
                    "start": wall(t0),
                    "duration_s": round(t1 - t0, 6),
                    "request_id": self.id,
                    "trace_id": self.trace_id,
                    # deterministic child ids: pure function of the root
                    # span id and the phase name (golden-testable)
                    "span_id": derive_span_id(root_sid, name),
                    "parent_span_id": root_sid,
                    "ok": self.outcome != "failed",
                    **attrs,
                }
            )

        end = self.events[-1][1] if self.events else self.t_enqueue
        phase("queue_wait", self.t_enqueue, self.t_admit)
        phase("prefill", self.t_admit, self.t_prefill_done)
        phase(
            "decode", self.t_first, self.t_last, tokens=self.n_tokens
        )
        spans.append(
            {
                "name": f"request-{self.id}",
                "parent": None,
                "thread": "serving",
                "start": self.t_wall_enqueue,
                "duration_s": round(end - self.t_enqueue, 6),
                "request_id": self.id,
                "trace_id": self.trace_id,
                "span_id": root_sid,
                "parent_span_id": self.parent_span_id,
                "outcome": self.outcome,
                "tokens": self.n_tokens,
                "ok": self.outcome != "failed",
            }
        )
        return spans


class ServingTelemetry:
    """The engine's lifecycle observer: owns a metrics Registry (or
    shares one passed in), the latency histograms and the bounded ring
    of recent request traces. One instance per engine."""

    def __init__(
        self,
        registry: Optional[Registry] = None,
        clock=time.monotonic,
        ring: int = 256,
    ):
        self.registry = registry if registry is not None else Registry()
        self.clock = clock
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._ring: deque[RequestTrace] = deque(maxlen=ring)
        by_name = {name: (kind, help_) for name, kind, help_, _agg in SERVING_METRIC_FAMILIES}

        def hist(name):
            return self.registry.histogram(name, by_name[name][1])

        self.ttft = hist("ttft_seconds")
        self.tpot = hist("tpot_seconds")
        self.queue_wait = hist("queue_wait_seconds")
        self.prefill = hist("prefill_seconds")
        self.e2e = hist("request_e2e_seconds")
        self.finished = self.registry.counter(
            "requests_finished_total",
            by_name["requests_finished_total"][1],
            labels=("outcome",),
        )

    # -- lifecycle hooks (scheduler thread; on_submit: client threads) -----
    def on_submit(self, req) -> None:
        now = self.clock()
        trace = RequestTrace(
            next(self._ids), len(req.prompt_ids), req.max_new_tokens, now
        )
        # join the caller's distributed trace when it sent a valid
        # traceparent (serve.py forwards the HTTP header onto the
        # Request); otherwise this request roots a fresh trace. The
        # request's own span id is derived, not random, so replays and
        # golden tests see stable ids.
        ctx = SpanContext.from_traceparent(getattr(req, "traceparent", None))
        trace.trace_id = ctx.trace_id if ctx else new_trace_id()
        trace.parent_span_id = ctx.span_id if ctx else None
        trace.span_id = derive_span_id(trace.trace_id, f"request-{trace.id}")
        trace.event("enqueue", now)
        req._obs_trace = trace
        with self._lock:
            self._ring.append(trace)

    def on_admit(self, req) -> None:
        t = getattr(req, "_obs_trace", None)
        if t is None:
            return
        now = self.clock()
        if t.t_admit is None:  # first admission only (resume re-admits)
            t.t_admit = now
            qw = t.queue_wait_s
            if qw is not None:
                self.queue_wait.observe(qw)
        t.event("admit", now)

    def on_prefill_chunk(self, req, pos: int) -> None:
        t = getattr(req, "_obs_trace", None)
        if t is None:
            return
        t.event(f"prefill_chunk:{pos}", self.clock())

    def on_prefill_done(self, req) -> None:
        t = getattr(req, "_obs_trace", None)
        if t is None:
            return
        now = self.clock()
        if t.t_prefill_done is None:
            t.t_prefill_done = now
            pf = t.prefill_s
            if pf is not None:
                self.prefill.observe(pf)
        t.event("prefill_done", now)

    def on_emit(self, req) -> None:
        # HOT PATH: once per generated token — clock read + field writes,
        # no locks, no event append
        t = getattr(req, "_obs_trace", None)
        if t is None:
            return
        now = self.clock()
        if t.t_first is None:
            t.t_first = now
            t.event("first_token", now)
            # exemplar links e.g. the p99 TTFT bucket to its trace
            self.ttft.observe(now - t.t_enqueue, exemplar=t.trace_id)
        t.t_last = now
        t.n_tokens += 1

    def on_preempt(self, req) -> None:
        t = getattr(req, "_obs_trace", None)
        if t is None:
            return
        t.preemptions += 1
        t.event("preempt", self.clock())

    def on_finish(self, req, outcome: str) -> None:
        """Terminal transition (``completed`` | ``failed``). Idempotent:
        the failure ladder and stop() can both reach a request — the
        first terminal event wins, mirroring the engine's own
        ``req.done.is_set()`` double-count guards."""
        t = getattr(req, "_obs_trace", None)
        if t is None or t.outcome is not None:
            return
        now = self.clock()
        t.outcome = outcome
        t.event(outcome, now)
        self.finished.labels(outcome=outcome).inc()
        if outcome == "completed":
            self.e2e.observe(t.e2e_s(now), exemplar=t.trace_id)
            tp = t.tpot_s
            if tp is not None:
                self.tpot.observe(tp)

    # -- views -------------------------------------------------------------
    def recent(self, limit: int = 50) -> list[dict]:
        """Newest-last dicts of the most recent traces (finished and
        in-flight)."""
        with self._lock:
            traces = list(self._ring)[-limit:]
        return [t.to_dict() for t in traces]

    def export_jsonl(self, path: str) -> int:
        """Write the ring as JSONL (one trace per line); returns count."""
        rows = self.recent(limit=self._ring.maxlen or 256)
        with open(path, "w", encoding="utf-8") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
        return len(rows)

    def recent_spans(
        self, limit: int = 512, trace_id: Optional[str] = None
    ) -> list[dict]:
        """Lifecycle-phase span dicts for the newest requests (newest
        last) — the per-process feed the fleet collector stitches into
        one cross-worker Chrome trace. Starts are wall-clock and the
        dicts carry the distributed ``trace_id``, so lanes from N
        replicas line up on one timeline."""
        with self._lock:
            traces = list(self._ring)
        spans = [s for t in traces for s in t.to_spans()]
        if trace_id is not None:
            spans = [s for s in spans if s.get("trace_id") == trace_id]
        for s in spans:
            s.setdefault("track", s.get("thread") or "serving")
        return spans[-max(0, limit):]
