"""Closed-loop autoscaler: collector HPA signals -> fleet replica count.

The telemetry collector already exports fleet pressure as
autoscaling/v2 ``metrics`` entries (``TelemetryCollector.hpa_signals``
— the exact shape the deploy charts' ``autoscaling.objects`` carries,
see chart.py ``_derive_autoscaling``). This module closes the loop
locally: the same signals an in-cluster HPA would act on drive
``ReplicaFleet.scale_to`` instead, so autoscaling behavior is testable
on a laptop with the same semantics it ships with.

The decision core follows the HPA algorithm:

    desired_m = ceil(current * value_m / target_m)   per metric m
    desired   = max over metrics                     (most-pressured wins)

with the standard guards —

- **tolerance band**: |value/target - 1| <= tolerance means "close
  enough", the metric votes for the current count (no flapping on
  noise);
- **scale-up stabilization** (default 0 — react immediately): the
  applied count is the *minimum* recommendation over the up window;
- **scale-down stabilization**: the applied count is the *maximum*
  recommendation over the down window, so one quiet sample never
  triggers a drain — load must stay low for the whole window;
- min/max replica clamps.

:class:`Autoscaler` is pure decision logic with an injected clock
(golden decision-table tests drive it sample by sample);
:class:`AutoscaleLoop` is the thread that wires it to a live fleet +
collector, refreshing the collector's target set from
``fleet.targets()`` each tick so restarted replicas (new ports) keep
being scraped. Scale events are emitted by the fleet itself
(``fleet.scale_up`` / ``fleet.scale_down``).

The port's copy of ``devspace_tpu/serving/autoscale.py``, with the same behaviour; it
imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional


def signal_values(signals: list) -> dict:
    """Flatten autoscaling/v2 Pods entries to {metric name: averageValue}."""
    out = {}
    for entry in signals or ():
        if entry.get("type") != "Pods":
            continue
        pods = entry.get("pods") or {}
        name = (pods.get("metric") or {}).get("name")
        target = pods.get("target") or {}
        if name and target.get("type") == "AverageValue":
            try:
                out[name] = float(target["averageValue"])
            except (KeyError, TypeError, ValueError):
                continue
    return out


@dataclass
class AutoscalerConfig:
    """Knobs, named after the chart/HPA convention they mirror."""

    min_replicas: int = 1
    max_replicas: int = 4
    # metric name -> target per-replica average value (the AverageValue
    # an HPA would carry). Occupancy 0.75 ≈ "scale before saturation".
    targets: dict = field(default_factory=lambda: {
        "engine_dispatch_depth_occupancy": 0.75,
    })
    tolerance: float = 0.1
    scale_up_stabilization_s: float = 0.0
    scale_down_stabilization_s: float = 30.0

    def validate(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if not self.targets:
            raise ValueError("at least one metric target is required")
        for name, target in self.targets.items():
            if target <= 0:
                raise ValueError(f"target for {name!r} must be > 0")


@dataclass
class AutoscaleDecision:
    at: float
    current: int
    desired: int          # what to apply now (post-stabilization, clamped)
    recommendation: int   # this sample's raw clamped recommendation
    reason: str
    per_metric: dict = field(default_factory=dict)  # name -> (value, target, desired)


class Autoscaler:
    """Pure HPA-style decision core. Feed it one (signals, current)
    sample per tick; it returns what the fleet size should be *now*,
    with stabilization windows applied over its own sample history."""

    def __init__(self, config: AutoscalerConfig,
                 clock: Callable[[], float] = time.monotonic):
        config.validate()
        self.config = config
        self._clock = clock
        # (ts, clamped recommendation) history for stabilization windows
        self._recs: deque = deque()

    def evaluate(self, signals: list, current: int) -> AutoscaleDecision:
        cfg = self.config
        now = self._clock()
        current = max(1, int(current))
        values = signal_values(signals)
        per_metric = {}
        votes = []
        for name, target in cfg.targets.items():
            value = values.get(name)
            if value is None:
                continue  # metric absent this round (cold fleet, quarantine)
            ratio = value / target
            # epsilon keeps the band edge stable under float division
            # noise (0.55/0.5 must count as exactly 10% off)
            if abs(ratio - 1.0) <= cfg.tolerance + 1e-9:
                desired_m = current
            else:
                desired_m = max(1, math.ceil(current * ratio))
            per_metric[name] = (value, target, desired_m)
            votes.append(desired_m)

        if not votes:
            # no signal at all: hold steady (never scale blind)
            rec = current
            reason = "no signals"
        else:
            rec = max(votes)
            driving = max(
                per_metric, key=lambda n: per_metric[n][2])
            value, target, _ = per_metric[driving]
            reason = f"{driving}={value:g} target={target:g}"
        rec = min(cfg.max_replicas, max(cfg.min_replicas, rec))

        self._recs.append((now, rec))
        horizon = max(
            cfg.scale_up_stabilization_s, cfg.scale_down_stabilization_s)
        # prune, but keep the newest record at/before the horizon edge:
        # a recommendation stands until the next sample, so that record
        # is what was "in effect" at the window start
        cutoff = now - horizon
        while len(self._recs) >= 2 and self._recs[1][0] <= cutoff:
            self._recs.popleft()

        desired = rec
        if desired > current and cfg.scale_up_stabilization_s > 0:
            desired = min(self._window(
                now, cfg.scale_up_stabilization_s, current))
        if desired < current:
            desired = max(self._window(
                now, cfg.scale_down_stabilization_s, current))
        desired = min(cfg.max_replicas, max(cfg.min_replicas, desired))
        if desired != rec:
            reason += (" (stabilized)" if desired == current
                       else f" (stabilized from {rec})")
        return AutoscaleDecision(
            at=now, current=current, desired=desired,
            recommendation=rec, reason=reason, per_metric=per_metric,
        )

    def _window(self, now: float, width: float, current: int) -> list:
        """Recommendations in effect over [now - width, now]: samples
        inside the window, plus the standing recommendation at the
        window start (the newest sample at/before it). A window that
        predates history counts ``current`` as standing — so a
        fresh-started autoscaler never scales down on its first quiet
        sample; load must stay low for a *full observed* window."""
        start = now - width
        vals = [r for t, r in self._recs if t > start]
        older = [r for t, r in self._recs if t <= start]
        vals.append(older[-1] if older else current)
        return vals


class AutoscaleLoop:
    """The closed loop: every ``interval_s`` refresh the collector's
    target set from the fleet, read the merged HPA signals, and apply
    the decision through ``fleet.scale_to`` (which drains before any
    scale-down kill). The collector keeps its own scrape cadence; this
    loop only consumes its latest merge."""

    def __init__(self, fleet, collector, config: AutoscalerConfig,
                 interval_s: float = 1.0,
                 on_decision: Optional[Callable[[AutoscaleDecision], None]] = None):
        self.fleet = fleet
        self.collector = collector
        self.autoscaler = Autoscaler(config)
        self.interval_s = interval_s
        self.on_decision = on_decision
        self.decisions: list = []  # bounded trail for status/debug
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def tick(self) -> AutoscaleDecision:
        """One evaluation round (exposed for tests and the CLI)."""
        self.collector.refresh(sorted(self.fleet.targets().items()))
        decision = self.autoscaler.evaluate(
            self.collector.hpa_signals(), self.fleet.desired)
        self.decisions.append(decision)
        del self.decisions[:-100]
        if decision.desired != self.fleet.desired:
            self.fleet.scale_to(decision.desired, reason=decision.reason)
        if self.on_decision is not None:
            try:
                self.on_decision(decision)
            except Exception:  # noqa: BLE001 — observer must not kill loop
                pass
        return decision

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — loop survives bad rounds
                pass

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="autoscale-loop")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
