"""Declarative SLOs with multi-window burn-rate evaluation.

An :class:`SLOSpec` names an objective over metric families that
already exist (``Registry.snapshot()`` is the only data source — no new
bookkeeping in hot paths): a latency percentile via histogram buckets
(TTFT p99), an error-rate / availability target via counter deltas, or
a throughput floor via gauge samples. The :class:`SLOEvaluator` keeps a
timestamped ring of snapshots and computes, per spec, the **bad-event
fraction over a short and a long window**; dividing by the error budget
(``1 - objective``) gives the *burn rate* — 1.0 means burning exactly
the budget, 10 means the budget is gone in a tenth of the window.

Statuses follow the multi-window discipline from the SRE workbook: a
spec is ``breach`` only when BOTH windows burn above the breach
threshold (the long window proves it is significant, the short window
proves it is still happening — and lets ``/readyz`` recover as soon as
the short window slides past the incident), ``warn`` when both exceed
the warn threshold, else ``ok``. Status transitions emit ``slo.warn`` /
``slo.breach`` / ``slo.recovered`` events on the default bus.

Everything takes an injectable ``clock`` so the burn math is pinned by
golden tests (tests/test_obs_slo.py) without sleeping.

The port's copy of ``devspace_tpu/obs/slo.py``, with the same behaviour; it
imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

from . import events as _events
from .metrics import Registry, _validate_name

SLO_METRIC_FAMILIES = (
    ("slo_status", "gauge",
     "SLO state per objective: 0 ok, 1 warn, 2 breach", "max"),
    ("slo_burn_ratio", "gauge",
     "Error-budget burn rate per SLO and window "
     "(1.0 = burning exactly the budget)", "max"),
)

_STATUS_ORDER = {"ok": 0, "warn": 1, "breach": 2}


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective. ``kind`` selects the bad-fraction
    source:

    - ``latency``: fraction of ``histogram`` observations above
      ``threshold_s`` within the window (bucket-resolution: the
      threshold snaps up to the nearest bucket edge).
    - ``error_rate``: ``sum(bad counters) / sum(total counters)`` delta
      within the window.
    - ``throughput_floor``: fraction of evaluation samples where
      ``gauge < floor`` while the ``activity`` gauges sum > 0 (an idle
      engine is not a breach).
    """

    name: str
    kind: str  # "latency" | "error_rate" | "throughput_floor"
    objective: float  # target good fraction, e.g. 0.99
    # latency
    histogram: Optional[str] = None
    threshold_s: Optional[float] = None
    # error_rate
    bad: Sequence[str] = ()
    total: Sequence[str] = ()
    # throughput_floor
    gauge: Optional[str] = None
    floor: Optional[float] = None
    activity: Sequence[str] = ()
    # windows + thresholds
    short_window_s: float = 300.0
    long_window_s: float = 3600.0
    warn_burn: float = 1.0
    breach_burn: float = 6.0
    min_events: int = 1  # below this many window events: no data -> ok

    def __post_init__(self):
        _validate_name(self.name)
        if self.kind not in ("latency", "error_rate", "throughput_floor"):
            raise ValueError(f"{self.name}: unknown SLO kind {self.kind!r}")
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"{self.name}: objective must be in (0, 1)")
        if self.kind == "latency" and (
            not self.histogram or self.threshold_s is None
        ):
            raise ValueError(f"{self.name}: latency needs histogram+threshold_s")
        if self.kind == "error_rate" and (not self.bad or not self.total):
            raise ValueError(f"{self.name}: error_rate needs bad+total counters")
        if self.kind == "throughput_floor" and (
            not self.gauge or self.floor is None
        ):
            raise ValueError(f"{self.name}: throughput_floor needs gauge+floor")
        if self.short_window_s <= 0 or self.long_window_s < self.short_window_s:
            raise ValueError(f"{self.name}: want 0 < short <= long window")

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.objective)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "kind": self.kind,
            "objective": self.objective,
            "short_window_s": self.short_window_s,
            "long_window_s": self.long_window_s,
            "warn_burn": self.warn_burn,
            "breach_burn": self.breach_burn,
        }
        if self.kind == "latency":
            d["histogram"] = self.histogram
            d["threshold_s"] = self.threshold_s
        elif self.kind == "error_rate":
            d["bad"] = list(self.bad)
            d["total"] = list(self.total)
        else:
            d["gauge"] = self.gauge
            d["floor"] = self.floor
        return d


@dataclass
class SLOStatus:
    """One spec's evaluation result."""

    name: str
    status: str  # ok | warn | breach
    burn_short: float
    burn_long: float
    bad_short: float = 0.0
    total_short: float = 0.0
    detail: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "status": self.status,
            "burn_short": round(self.burn_short, 4),
            "burn_long": round(self.burn_long, 4),
            "bad_short": self.bad_short,
            "total_short": self.total_short,
            **self.detail,
        }


def _sum_counter(snap: dict, names: Sequence[str]) -> float:
    total = 0.0
    for name in names:
        fam = snap.get(name)
        if not fam:
            continue
        for _labels, val in fam.get("samples", ()):
            if isinstance(val, (int, float)):
                total += float(val)
    return total


def _hist_good_total(snap: dict, name: str, threshold: float):
    """(observations <= threshold, total observations) summed across the
    family's label sets, at bucket resolution (threshold snaps up to the
    nearest ``le`` edge)."""
    fam = snap.get(name)
    good = total = 0.0
    if not fam:
        return good, total
    for _labels, val in fam.get("samples", ()):
        if not isinstance(val, dict):
            continue
        buckets = val.get("buckets") or ()
        cum_at_threshold = 0.0
        for le, cum in buckets:
            if le >= threshold or math.isinf(le):
                cum_at_threshold = cum
                break
        good += cum_at_threshold
        total += float(val.get("count", 0))
    return good, total


def _sum_gauge(snap: dict, names: Sequence[str]) -> float:
    return _sum_counter(snap, names)  # same shape: scalar samples


class SLOEvaluator:
    """Evaluates a set of :class:`SLOSpec` over registry snapshots.

    ``sources`` is one callable — or a list of callables — returning
    :meth:`Registry.snapshot` dicts (the serving example passes both the
    engine's private registry and the process default registry; merged
    left-to-right). Call :meth:`evaluate` periodically (serve.py runs it
    on a background thread every ``DEVSPACE_SLO_INTERVAL_S``); between
    calls, :meth:`statuses` / :meth:`ready` / :meth:`to_dict` serve the
    last result without recomputing.
    """

    def __init__(
        self,
        specs: Sequence[SLOSpec],
        sources,
        clock: Callable[[], float] = time.monotonic,
        bus: Optional[_events.EventBus] = None,
    ):
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names in {names}")
        self.specs = tuple(specs)
        if callable(sources):
            sources = [sources]
        self._sources = list(sources)
        self._clock = clock
        self._bus = bus  # None -> default bus at emit time
        self._lock = threading.Lock()
        self._history: deque = deque()  # (ts, {spec.name: extracted})
        self._last: list[SLOStatus] = []
        self._last_ts: Optional[float] = None
        self._horizon = max(
            (s.long_window_s for s in self.specs), default=3600.0
        )

    # -- snapshot extraction ------------------------------------------------
    def _collect(self) -> dict:
        merged: dict = {}
        for src in self._sources:
            try:
                merged.update(src() or {})
            except Exception:
                continue  # a dead source degrades to "no data", not a crash
        return merged

    def _extract(self, snap: dict) -> dict:
        out = {}
        for spec in self.specs:
            if spec.kind == "latency":
                good, total = _hist_good_total(
                    snap, spec.histogram, spec.threshold_s
                )
                out[spec.name] = (total - good, total)  # cumulative (bad, total)
            elif spec.kind == "error_rate":
                out[spec.name] = (
                    _sum_counter(snap, spec.bad),
                    _sum_counter(snap, spec.total),
                )
            else:  # throughput_floor: instantaneous (value, active?)
                value = _sum_gauge(snap, [spec.gauge])
                active = (
                    True
                    if not spec.activity
                    else _sum_gauge(snap, spec.activity) > 0
                )
                out[spec.name] = (value, active)
        return out

    # -- window math --------------------------------------------------------
    def _baseline(self, cutoff: float):
        """Latest history entry at or before ``cutoff`` (else the oldest
        one) — the subtrahend for cumulative deltas over a window."""
        base = None
        for ts, vals in self._history:
            if ts <= cutoff:
                base = (ts, vals)
            else:
                break
        if base is None and self._history:
            base = self._history[0]
        return base

    def _window_bad_frac(self, spec: SLOSpec, now: float, window: float,
                         current: dict):
        """(bad_fraction, bad, total) over the trailing ``window``."""
        if spec.kind == "throughput_floor":
            samples = [
                vals[spec.name]
                for ts, vals in self._history
                if ts > now - window and spec.name in vals
            ]
            active = [(v, a) for v, a in samples if a]
            if not active:
                return 0.0, 0.0, 0.0
            bad = sum(1.0 for v, _a in active if v < spec.floor)
            return bad / len(active), bad, float(len(active))
        cur_bad, cur_total = current[spec.name]
        base = self._baseline(now - window)
        base_bad = base_total = 0.0
        if base is not None and spec.name in base[1]:
            base_bad, base_total = base[1][spec.name]
        d_bad = max(0.0, cur_bad - base_bad)
        d_total = max(0.0, cur_total - base_total)
        if d_total < spec.min_events:
            return 0.0, d_bad, d_total
        return min(1.0, d_bad / d_total), d_bad, d_total

    # -- evaluation ---------------------------------------------------------
    def evaluate(self) -> list[SLOStatus]:
        now = self._clock()
        current = self._extract(self._collect())
        with self._lock:
            self._history.append((now, current))
            horizon = now - self._horizon - 1.0
            # keep one entry older than the horizon as the long baseline
            while len(self._history) > 1 and self._history[1][0] <= horizon:
                self._history.popleft()
            prev = {s.name: s.status for s in self._last}
            statuses = []
            for spec in self.specs:
                frac_s, bad_s, total_s = self._window_bad_frac(
                    spec, now, spec.short_window_s, current
                )
                frac_l, _bad_l, _total_l = self._window_bad_frac(
                    spec, now, spec.long_window_s, current
                )
                burn_s = frac_s / spec.budget
                burn_l = frac_l / spec.budget
                gating = min(burn_s, burn_l)
                if gating >= spec.breach_burn:
                    status = "breach"
                elif gating >= spec.warn_burn:
                    status = "warn"
                else:
                    status = "ok"
                statuses.append(SLOStatus(
                    name=spec.name,
                    status=status,
                    burn_short=burn_s,
                    burn_long=burn_l,
                    bad_short=bad_s,
                    total_short=total_s,
                    detail={"objective": spec.objective, "kind": spec.kind},
                ))
            self._last = statuses
            self._last_ts = now
        for st in statuses:
            before = prev.get(st.name, "ok")
            if st.status == before:
                continue
            bus = self._bus or _events.get_bus()
            name = "recovered" if st.status == "ok" else st.status
            level = {"ok": "info", "warn": "warn", "breach": "error"}[st.status]
            bus.emit(
                "slo", name, level=level, slo=st.name,
                burn_short=round(st.burn_short, 4),
                burn_long=round(st.burn_long, 4), was=before,
            )
        return statuses

    # -- read side ----------------------------------------------------------
    def statuses(self) -> list[SLOStatus]:
        with self._lock:
            return list(self._last)

    def ready(self) -> bool:
        """False iff any spec is in ``breach`` as of the last
        evaluation — the ``/readyz`` signal (True before the first
        evaluation: never block startup on missing data)."""
        with self._lock:
            return all(s.status != "breach" for s in self._last)

    def worst(self) -> str:
        with self._lock:
            if not self._last:
                return "ok"
            return max(
                (s.status for s in self._last), key=_STATUS_ORDER.__getitem__
            )

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "ready": all(s.status != "breach" for s in self._last),
                "status": (
                    max((s.status for s in self._last),
                        key=_STATUS_ORDER.__getitem__)
                    if self._last else "ok"
                ),
                "evaluated_at": self._last_ts,
                "slos": [s.to_dict() for s in self._last],
            }

    def register_metrics(self, registry: Registry) -> None:
        """Expose per-SLO status + burn gauges on ``registry`` via
        pull callbacks (no bookkeeping beyond the last evaluation)."""
        status_name, _, status_help, _agg = SLO_METRIC_FAMILIES[0]
        burn_name, _, burn_help, _agg = SLO_METRIC_FAMILIES[1]

        def _status_samples():
            return [
                ({"slo": s.name}, float(_STATUS_ORDER[s.status]))
                for s in self.statuses()
            ]

        def _burn_samples():
            out = []
            for s in self.statuses():
                out.append(({"slo": s.name, "window": "short"}, s.burn_short))
                out.append(({"slo": s.name, "window": "long"}, s.burn_long))
            return out

        registry.register_callback(
            status_name, "gauge", status_help, _status_samples, labels=("slo",)
        )
        registry.register_callback(
            burn_name, "gauge", burn_help, _burn_samples,
            labels=("slo", "window"),
        )


def default_serving_slos(
    ttft_threshold_s: float = 1.0,
    tok_s_floor: float = 0.5,
    short_window_s: float = 300.0,
    long_window_s: float = 3600.0,
) -> tuple[SLOSpec, ...]:
    """The four stock serving objectives over families that already
    exist: TTFT p99 (request_trace's ``ttft_seconds``), error rate and
    availability (engine request counters), and a tok/s floor that only
    counts samples taken under load (idle != breach). serve.py builds
    these from env knobs (``DEVSPACE_SLO_*``)."""
    return (
        SLOSpec(
            name="ttft_p99", kind="latency", objective=0.99,
            histogram="ttft_seconds", threshold_s=ttft_threshold_s,
            short_window_s=short_window_s, long_window_s=long_window_s,
        ),
        SLOSpec(
            name="error_rate", kind="error_rate", objective=0.99,
            bad=("engine_requests_failed_total",),
            total=("engine_requests_failed_total",
                   "engine_requests_completed_total"),
            short_window_s=short_window_s, long_window_s=long_window_s,
        ),
        SLOSpec(
            name="availability", kind="error_rate", objective=0.999,
            bad=("engine_requests_failed_total",),
            total=("engine_requests_failed_total",
                   "engine_requests_completed_total"),
            short_window_s=long_window_s,
            long_window_s=long_window_s * 4,
            warn_burn=1.0, breach_burn=14.4,
        ),
        SLOSpec(
            name="tok_s_floor", kind="throughput_floor", objective=0.9,
            gauge="engine_tokens_per_sec_10s", floor=tok_s_floor,
            activity=("engine_active_slots", "engine_queued_requests"),
            short_window_s=short_window_s, long_window_s=long_window_s,
        ),
    )
