"""Unified telemetry: metrics registry + per-request traces.

- :mod:`devspace_tpu_torch.obs.metrics` — dependency-free Counter / Gauge /
  Histogram registry with labeled families, callback (pull) metrics and
  Prometheus text-exposition rendering.
- :mod:`devspace_tpu_torch.obs.request_trace` — per-request serving lifecycle
  recorder producing TTFT / TPOT / queue-wait / prefill / e2e
  histograms and a bounded ring of recent request traces.
- :mod:`devspace_tpu_torch.obs.fleet` — exposition parse/merge: counters
  summed, gauges per aggregation hints, histograms merged
  bucket-exactly; cross-process Chrome-trace stitching.
- :mod:`devspace_tpu_torch.obs.collector` — the pull-based fleet collector
  behind ``devspace-tpu collector serve``.

Every serving subsystem registers its counters here as metric families;
the existing ``stats()`` dicts stay byte-compatible (they and the
registry are two views over the same counters).

The port's copy of ``devspace_tpu/obs/__init__.py``, with the same behaviour; it
imports nothing of the JAX package.
"""

from .events import (
    EVENT_CATALOG,
    EVENT_SUBSYSTEMS,
    EVENTS_METRIC_FAMILIES,
    Event,
    EventBus,
    FlightRecorder,
    JsonlSink,
    add_sink,
    emit,
    events_enabled,
    get_bus,
    make_event,
    remove_sink,
)
from .metrics import (
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    Registry,
    WindowedRate,
    get_registry,
    metrics_enabled,
)
from .request_trace import (
    SERVING_METRIC_FAMILIES,
    RequestTrace,
    ServingTelemetry,
)
from .slo import (
    SLO_METRIC_FAMILIES,
    SLOEvaluator,
    SLOSpec,
    SLOStatus,
    default_serving_slos,
)
from .tracing import (
    TIMELINE_TRACKS,
    TRACING_METRIC_FAMILIES,
    Span,
    SpanContext,
    TimelineRecorder,
    Tracer,
    current_traceparent,
    get_tracer,
)

# fleet federation last: collector pulls in every catalog above (and
# resilience.policy, which imports back into this package)
from .collector import (  # noqa: E402
    COLLECTOR_METRIC_FAMILIES,
    TelemetryCollector,
    make_http_server,
)
from .fleet import (  # noqa: E402
    FLEET_AGG_KINDS,
    ExpositionParseError,
    aggregation_hints,
    family_agg,
    merge_snapshots,
    parse_exposition,
    stitch_chrome_trace,
)

__all__ = [
    "COLLECTOR_METRIC_FAMILIES",
    "TelemetryCollector",
    "make_http_server",
    "FLEET_AGG_KINDS",
    "ExpositionParseError",
    "aggregation_hints",
    "family_agg",
    "merge_snapshots",
    "parse_exposition",
    "stitch_chrome_trace",
    "EVENT_CATALOG",
    "EVENT_SUBSYSTEMS",
    "EVENTS_METRIC_FAMILIES",
    "Event",
    "EventBus",
    "FlightRecorder",
    "JsonlSink",
    "add_sink",
    "emit",
    "events_enabled",
    "get_bus",
    "make_event",
    "remove_sink",
    "SLO_METRIC_FAMILIES",
    "SLOEvaluator",
    "SLOSpec",
    "SLOStatus",
    "default_serving_slos",
    "TIMELINE_TRACKS",
    "TRACING_METRIC_FAMILIES",
    "Span",
    "SpanContext",
    "TimelineRecorder",
    "Tracer",
    "current_traceparent",
    "get_tracer",
    "DEFAULT_LATENCY_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "WindowedRate",
    "get_registry",
    "metrics_enabled",
    "SERVING_METRIC_FAMILIES",
    "RequestTrace",
    "ServingTelemetry",
]
