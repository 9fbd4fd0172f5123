"""Pull-based fleet telemetry collector.

One :class:`TelemetryCollector` scrapes ``/metrics``, ``/healthz``,
``/debug/events`` and ``/debug/spans`` from every target — serving
replicas, slice workers, anything speaking the serving example's
endpoints — and federates them with obs/fleet.py into a single fleet
snapshot: counters summed, gauges merged per their declared aggregation
hint, latency histograms merged bucket-exactly so the stock burn-rate
engine (obs/slo.py) evaluates fleet-level TTFT/e2e SLOs over the
*merged* distribution.

Degradation contract, in order:

1. **A dead target never fails the collector.** Scrapes run under the
   resilience RetryPolicy; an exhausted target flips its
   ``collector_target_up`` gauge to 0 and its staleness gauge keeps
   climbing, while its *last good* snapshot ages out of the merge.
2. **A lying target never corrupts the merge.** Garbage or truncated
   exposition text raises in the strict parser, increments
   ``collector_parse_errors_total`` and — after ``quarantine_after``
   consecutive parse failures — quarantines the target: still probed
   every round (cheap, so it can rejoin on a clean parse) but excluded
   from the fleet snapshot until then.
3. **Partial beats nothing.** ``/debug/events``, ``/healthz`` and
   ``/debug/spans`` are best-effort per round; only ``/metrics``
   participates in up/down accounting.

The aggregated signals are also exported in the autoscaling/v2
``metrics`` convention the deploy charts' ``values.autoscaling.objects``
consume (:meth:`TelemetryCollector.hpa_signals`) so a future autoscaler
reads them unchanged.

The port's copy of ``devspace_tpu/obs/collector.py``, with the same behaviour; it
imports nothing of the JAX package. ``from_workers`` (target discovery through the
deploy layer's pod selectors) is left out: the port has no deploy layer.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Iterable, Optional, Sequence, Union

from .fleet import (
    ExpositionParseError,
    aggregation_hints,
    merge_snapshots,
    parse_exposition,
    render_snapshot,
    stitch_chrome_trace,
)
from .metrics import Registry
from .slo import SLOEvaluator, default_serving_slos

# (name, kind, help, agg) — the collector's own families, linted like
# every other catalog by scripts/metrics_lint.py. Per-target gauges are
# labeled by target name; "last" on them because a fleet OF collectors
# federating each other should keep each collector's own per-target row,
# not sum health bits.
COLLECTOR_METRIC_FAMILIES = (
    ("collector_scrapes_total", "counter",
     "Target scrape attempts (one per target per round)", "sum"),
    ("collector_scrape_errors_total", "counter",
     "Scrapes that failed after retry-policy exhaustion", "sum"),
    ("collector_parse_errors_total", "counter",
     "Scraped documents rejected by the exposition parser", "sum"),
    ("collector_fleet_targets", "gauge",
     "Configured scrape targets", "sum"),
    ("collector_fleet_targets_up", "gauge",
     "Targets whose latest /metrics scrape succeeded", "sum"),
    ("collector_target_up", "gauge",
     "Per-target scrape health (1 up, 0 down)", "last"),
    ("collector_target_quarantined", "gauge",
     "Per-target quarantine state (1 = excluded from the merge)", "last"),
    ("collector_target_staleness_seconds", "gauge",
     "Seconds since the target's last successful /metrics scrape", "max"),
    ("collector_scrape_seconds", "histogram",
     "Latency of one full-fleet scrape round", "sum"),
)


def _default_fetch(url: str, timeout: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


class TargetState:
    """Everything the collector remembers about one scrape target."""

    def __init__(self, name: str, url: str):
        self.name = name
        self.url = url.rstrip("/")
        self.up = False
        self.quarantined = False
        self.consecutive_parse_errors = 0
        self.last_attempt: Optional[float] = None
        self.last_ok: Optional[float] = None  # collector clock
        self.last_error: Optional[str] = None
        self.snapshot: Optional[dict] = None
        self.health: Optional[dict] = None
        self.events: list[dict] = []
        self.spans: list[dict] = []

    def status(self, now: float) -> dict:
        return {
            "target": self.name,
            "url": self.url,
            "up": self.up,
            "quarantined": self.quarantined,
            "staleness_s": (
                round(now - self.last_ok, 3) if self.last_ok is not None
                else None
            ),
            "last_error": self.last_error,
        }


def _target_name(url: str) -> str:
    parsed = urllib.parse.urlparse(url)
    return parsed.netloc or url


class TelemetryCollector:
    """Scrape N targets, federate them into one fleet snapshot.

    ``targets`` is a sequence of URLs or ``(name, url)`` pairs. All
    I/O is injectable: ``fetch(url, timeout) -> bytes`` for tests and
    benches, ``clock`` for deterministic staleness math.
    """

    def __init__(
        self,
        targets: Sequence[Union[str, tuple]],
        *,
        interval_s: float = 5.0,
        timeout_s: float = 2.0,
        retry_policy: Optional[RetryPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
        fetch: Optional[Callable[[str, float], bytes]] = None,
        quarantine_after: int = 3,
        events_limit: int = 200,
        spans_limit: int = 512,
        slo_specs: Optional[Sequence] = None,
        hints: Optional[dict] = None,
    ):
        self.targets: list[TargetState] = []
        for t in targets:
            if isinstance(t, str):
                self.targets.append(TargetState(_target_name(t), t))
            else:
                name, url = t
                self.targets.append(TargetState(name, url))
        if len({t.name for t in self.targets}) != len(self.targets):
            raise ValueError("duplicate target names")
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.quarantine_after = max(1, int(quarantine_after))
        self.events_limit = int(events_limit)
        self.spans_limit = int(spans_limit)
        self._clock = clock
        self._fetch = fetch or _default_fetch
        # lazy import: resilience.policy imports back into obs, so a
        # top-level import here would be circular
        from ..resilience.policy import RetryPolicy

        # 2 quick attempts by default: a slow target must degrade to
        # staleness, not stall the whole round behind 5 backoffs
        self._retry = retry_policy or RetryPolicy(
            max_attempts=2, base_delay=0.05, max_delay=0.25,
            jitter=0.5, seed=0, retry_on=(OSError, urllib.error.URLError),
        )
        self._hints = dict(hints) if hints is not None else aggregation_hints()
        for fam in COLLECTOR_METRIC_FAMILIES:
            self._hints.setdefault(fam[0], fam[-1])
        self._lock = threading.Lock()
        self._notes: list[str] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

        self.registry = Registry()
        reg = self.registry
        fams = {f[0]: f for f in COLLECTOR_METRIC_FAMILIES}
        self._scrapes = reg.counter(
            "collector_scrapes_total", fams["collector_scrapes_total"][2])
        self._scrape_errors = reg.counter(
            "collector_scrape_errors_total",
            fams["collector_scrape_errors_total"][2])
        self._parse_errors = reg.counter(
            "collector_parse_errors_total",
            fams["collector_parse_errors_total"][2])
        self._scrape_hist = reg.histogram(
            "collector_scrape_seconds", fams["collector_scrape_seconds"][2])
        reg.register_callback(
            "collector_fleet_targets", "gauge",
            fams["collector_fleet_targets"][2], lambda: len(self.targets))
        reg.register_callback(
            "collector_fleet_targets_up", "gauge",
            fams["collector_fleet_targets_up"][2],
            lambda: sum(1 for t in self.targets if t.up))
        reg.register_callback(
            "collector_target_up", "gauge", fams["collector_target_up"][2],
            lambda: [({"target": t.name}, 1.0 if t.up else 0.0)
                     for t in self.targets],
            labels=("target",))
        reg.register_callback(
            "collector_target_quarantined", "gauge",
            fams["collector_target_quarantined"][2],
            lambda: [({"target": t.name}, 1.0 if t.quarantined else 0.0)
                     for t in self.targets],
            labels=("target",))
        reg.register_callback(
            "collector_target_staleness_seconds", "gauge",
            fams["collector_target_staleness_seconds"][2],
            self._staleness_samples, labels=("target",))

        # Fleet SLOs evaluate the MERGED distribution through the stock
        # burn-rate engine — same specs serve.py uses per process.
        specs = tuple(slo_specs) if slo_specs is not None \
            else default_serving_slos()
        self.slo = SLOEvaluator(specs, [self._merged_target_snapshot],
                                clock=clock)
        self.slo.register_metrics(reg)

    # -- discovery helpers ---------------------------------------------------
    @classmethod
    def from_replicas(cls, urls: Iterable[str], **kwargs):
        """Static serving-replica URL list (the ``--target`` CLI path)."""
        return cls(list(urls), **kwargs)

    def refresh(self, targets: Sequence[Union[str, tuple]]) -> None:
        """Replace the target set at runtime (the autoscaler
        adds/removes replicas and a restarted replica may come back on a
        new port) without rebuilding the collector. State is preserved
        per *name*: a surviving target keeps its quarantine, staleness
        and last-good-snapshot state (a URL change just repoints the
        same TargetState — the next scrape round re-probes it); new
        names start cold; dropped names are forgotten. The list is
        swapped atomically, so a concurrent ``scrape_once`` finishes
        its round over the old set and the gauge callbacks pick up the
        new one on their next read."""
        by_name = {t.name: t for t in self.targets}
        fresh: list[TargetState] = []
        for t in targets:
            if isinstance(t, str):
                name, url = _target_name(t), t
            else:
                name, url = t
            state = by_name.get(name)
            if state is not None:
                state.url = url.rstrip("/")
            else:
                state = TargetState(name, url)
            fresh.append(state)
        if len({t.name for t in fresh}) != len(fresh):
            raise ValueError("duplicate target names")
        self.targets = fresh

    # -- scraping ------------------------------------------------------------
    def _staleness_samples(self):
        now = self._clock()
        return [
            ({"target": t.name},
             max(0.0, now - t.last_ok) if t.last_ok is not None
             else float("inf"))
            for t in self.targets
        ]

    def _get(self, state: TargetState, path: str) -> bytes:
        return self._retry.execute(
            self._fetch, state.url + path, self.timeout_s,
            describe=f"scrape {state.name}{path}", reraise=True,
        )

    def _scrape_target(self, state: TargetState) -> None:
        now = self._clock()
        state.last_attempt = now
        self._scrapes.inc()
        try:
            text = self._get(state, "/metrics").decode("utf-8", "replace")
        except Exception as e:  # noqa: BLE001 — any fetch failure = down
            state.up = False
            state.last_error = f"fetch: {e}"
            self._scrape_errors.inc()
            return
        try:
            snap = parse_exposition(text)
        except ExpositionParseError as e:
            state.up = False
            state.last_error = f"parse: {e}"
            self._parse_errors.inc()
            state.consecutive_parse_errors += 1
            if state.consecutive_parse_errors >= self.quarantine_after:
                if not state.quarantined:
                    state.quarantined = True
                # a quarantined target keeps its stale snapshot OUT of
                # the merge until a clean parse readmits it
                state.snapshot = None
            return
        state.consecutive_parse_errors = 0
        if state.quarantined:
            state.quarantined = False
        state.up = True
        state.last_ok = self._clock()
        state.last_error = None
        state.snapshot = snap
        # best-effort sidecars: partial evidence beats a failed round
        try:
            body = self._get(
                state, f"/debug/events?limit={self.events_limit}")
            state.events = json.loads(body).get("events") or []
        except Exception:  # noqa: BLE001
            pass
        try:
            state.health = json.loads(self._get(state, "/healthz"))
        except Exception:  # noqa: BLE001
            pass
        try:
            body = self._get(
                state, f"/debug/spans?limit={self.spans_limit}")
            state.spans = json.loads(body).get("spans") or []
        except Exception:  # noqa: BLE001
            pass

    def scrape_once(self) -> None:
        """One full round over every target. Never raises."""
        t0 = self._clock()
        for state in self.targets:
            self._scrape_target(state)
        self._scrape_hist.observe(max(0.0, self._clock() - t0))
        self.slo.evaluate()

    # -- federation ----------------------------------------------------------
    def _merged_target_snapshot(self) -> dict:
        """Merge of the target snapshots only (no collector self-metrics)
        — the source the fleet SLO evaluator reads."""
        contributing = sorted(
            (t for t in self.targets
             if t.snapshot is not None and not t.quarantined),
            key=lambda t: t.last_ok or 0.0,
        )
        merged, notes = merge_snapshots(
            [t.snapshot for t in contributing], self._hints
        )
        with self._lock:
            self._notes = notes
        return merged

    def fleet_snapshot(self) -> dict:
        """The federated fleet snapshot: merged target families plus the
        collector's own (scrape health, staleness, fleet SLO state)."""
        merged, notes = merge_snapshots(
            [self._merged_target_snapshot(), self.registry.snapshot()],
            self._hints,
        )
        with self._lock:
            self._notes = sorted(set(self._notes) | set(notes))
        return merged

    def merge_notes(self) -> list[str]:
        with self._lock:
            return list(self._notes)

    def render_metrics(self) -> str:
        """Prometheus text 0.0.4 of the fleet snapshot (``/metrics`` of
        ``devspace-tpu collector serve``)."""
        return render_snapshot(self.fleet_snapshot())

    def merged_events(self, limit: int = 200,
                      subsystem: Optional[str] = None) -> list[dict]:
        """Events from every target, stamped with their origin and
        ordered by ``(time, seq)`` — the same stable tie-break the
        per-process FlightRecorder dump uses."""
        out = []
        for t in self.targets:
            for e in t.events:
                if subsystem and e.get("subsystem") != subsystem:
                    continue
                d = dict(e)
                d["target"] = t.name
                out.append(d)
        out.sort(key=lambda e: (e.get("time", 0.0), e.get("seq", 0)))
        return out[-limit:] if limit and limit > 0 else out

    def stitched_trace(self, trace_id: Optional[str] = None) -> dict:
        """One Chrome trace over every target's span ring — a process
        lane per target, joined on ``trace_id`` when given."""
        return stitch_chrome_trace(
            {t.name: t.spans for t in self.targets}, trace_id
        )

    def fleet_status(self) -> dict:
        """The ``/debug/fleet`` document: per-target matrix, fleet SLO
        table, merge notes and the HPA-convention signal export."""
        now = self._clock()
        snap = self.fleet_snapshot()

        def val(name, default=None):
            fam = snap.get(name)
            if not fam or not fam["samples"]:
                return default
            return sum(v for _l, v in fam["samples"]
                       if not isinstance(v, dict))

        matrix = []
        for t in self.targets:
            row = t.status(now)
            s = t.snapshot or {}

            def tval(name):
                fam = s.get(name)
                if not fam or not fam["samples"]:
                    return None
                return fam["samples"][0][1]

            row.update({
                "tok_s": tval("engine_tokens_per_sec_10s"),
                "active_slots": tval("engine_active_slots"),
                "max_slots": tval("engine_max_slots"),
                "queued": tval("engine_queued_requests"),
                "occupancy": tval("engine_dispatch_depth_occupancy"),
            })
            if t.health and isinstance(t.health.get("slo"), dict):
                row["slo"] = t.health["slo"].get("status")
            matrix.append(row)
        return {
            "targets": matrix,
            "fleet": {
                "targets": len(self.targets),
                "up": sum(1 for t in self.targets if t.up),
                "quarantined": sum(
                    1 for t in self.targets if t.quarantined),
                "tok_s": val("engine_tokens_per_sec_10s"),
                "active_slots": val("engine_active_slots"),
                "max_slots": val("engine_max_slots"),
                "queued": val("engine_queued_requests"),
            },
            "slo": self.slo.to_dict(),
            "notes": self.merge_notes(),
            "hpa": {"metrics": self.hpa_signals()},
        }

    def hpa_signals(self) -> list[dict]:
        """Aggregated signals as autoscaling/v2 ``metrics`` entries —
        the exact shape ``values.autoscaling.objects`` carries in the
        deploy charts (chart.py ``_derive_autoscaling``), so an
        autoscaler templated on that convention consumes fleet signals
        unchanged. ``averageValue`` is the current per-replica average
        (the quantity v2 Pods metrics target)."""
        up = max(1, sum(1 for t in self.targets if t.up))
        snap = self._merged_target_snapshot()

        def total(name):
            fam = snap.get(name)
            if not fam:
                return None
            vals = [v for _l, v in fam["samples"]
                    if not isinstance(v, dict)]
            return sum(vals) if vals else None

        out = []
        for name in (
            "engine_dispatch_depth_occupancy",
            "engine_queued_requests",
            "engine_tokens_per_sec_10s",
        ):
            fleet_value = total(name)
            if fleet_value is None:
                continue
            # "avg"-merged gauges already hold the per-replica average
            # after the hint merge; sum-merged ones are fleet totals.
            if self._hints.get(name) != "avg":
                fleet_value = fleet_value / up
            out.append({
                "type": "Pods",
                "pods": {
                    "metric": {"name": name},
                    "target": {
                        "type": "AverageValue",
                        "averageValue": round(fleet_value, 4),
                    },
                },
            })
        return out

    # -- background loop -----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.scrape_once()
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(
            target=loop, name="telemetry-collector", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


def make_http_server(collector: TelemetryCollector, host: str = "127.0.0.1",
                     port: int = 9090):
    """The federated endpoint (``devspace-tpu collector serve``):

    - ``/metrics`` — the merged fleet exposition (Prometheus 0.0.4)
    - ``/healthz`` — collector liveness + up/total target counts
    - ``/debug/fleet`` — per-target matrix, fleet SLO table, merge
      notes, HPA-convention signals
    - ``/debug/events`` — merged recent events from every target
      (same document shape as a replica's, so ``top`` reuses its
      renderer; rows gain a ``target`` key)
    - ``/debug/trace`` — stitched Chrome trace (``?trace_id=`` filters
      to one request across every process lane)

    Returns an unstarted ``ThreadingHTTPServer``; the caller owns
    ``serve_forever``/``shutdown`` (and the collector's scrape loop).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # noqa: N802 — quiet
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            from urllib.parse import parse_qs

            path, _, query = self.path.partition("?")
            qs = parse_qs(query)
            if path == "/metrics":
                body = collector.render_metrics().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/healthz":
                up = sum(1 for t in collector.targets if t.up)
                self._json(200, {
                    "ok": True,
                    "role": "collector",
                    "targets": len(collector.targets),
                    "up": up,
                    "slo": collector.slo.to_dict(),
                })
            elif path == "/debug/fleet":
                self._json(200, collector.fleet_status())
            elif path == "/debug/events":
                try:
                    limit = int(qs.get("limit", ["200"])[0])
                except ValueError:
                    self._json(400, {"error": "limit must be an integer"})
                    return
                subsystem = qs.get("subsystem", [None])[0]
                self._json(200, {
                    "events_enabled": True,
                    "subsystems": sorted(
                        {e.get("subsystem") for t in collector.targets
                         for e in t.events if e.get("subsystem")}
                    ),
                    "events": collector.merged_events(limit, subsystem),
                })
            elif path == "/debug/trace":
                trace_id = qs.get("trace_id", [None])[0]
                self._json(200, collector.stitched_trace(trace_id))
            else:
                self._json(404, {"error": "not found"})

    return ThreadingHTTPServer((host, port), Handler)
