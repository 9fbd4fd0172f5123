"""Dependency-free metrics registry with Prometheus text exposition.

The measurement substrate for the serving stack: Counter /
Gauge / Histogram primitives, labeled families, pull-style callback
metrics, and a renderer for the Prometheus text exposition format 0.0.4
(`/metrics` on the serving example, `devspace-tpu status serving`).

Design constraints, in order:

1. **Dependency-free.** No prometheus_client; the whole wire format is
   ~60 lines and the repo must not grow a runtime dependency for it.
2. **Two views, one truth.** Existing subsystems keep their plain-int
   counters (engine.stats(), sync session.stats, dispatcher counters) as
   the single mutation site; the registry exposes them through
   *callback* metrics that read the same memory at scrape time. No
   double bookkeeping in hot paths, no drift, no double-count risk.
3. **Thread-safe where mutated.** Direct Counter/Gauge/Histogram
   mutation takes a per-metric lock (histogram observes come from the
   scheduler thread while HTTP scrapes render concurrently). Callback
   metrics are lock-free by construction — they read GIL-atomic ints.
4. **Naming conventions are machine-checked** (scripts/metrics_lint.py):
   snake_case, counters end ``_total``, histograms carry a unit suffix
   (``_seconds``/``_bytes``). The registry itself validates the name
   charset at registration so a typo fails at import, not at scrape.

The port's copy of ``devspace_tpu/obs/metrics.py``, with the same behaviour; it
imports nothing of the JAX package.
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
from typing import Callable, Iterable, Optional, Sequence

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

# Fixed log-spaced latency buckets (seconds): sub-ms ... 60s. Shared by
# every latency histogram so dashboards can overlay TTFT/TPOT/queue-wait
# without per-metric bucket gymnastics.
DEFAULT_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _validate_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(f"invalid metric name {name!r} (want snake_case)")
    return name


def _fmt(v) -> str:
    """Prometheus sample value: integers without a trailing .0, +Inf for
    infinity, repr() floats otherwise (exact round-trip)."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(s: str) -> str:
    return (
        str(s).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing count. ``inc(n)`` with n >= 0 only."""

    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """A value that can go up and down."""

    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` buckets at render, like
    Prometheus client libraries). Buckets are per-family and immutable."""

    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        b = sorted(float(x) for x in buckets)
        if not b or any(
            b2 <= b1 for b1, b2 in zip(b, b[1:])
        ):
            raise ValueError(f"need strictly increasing buckets, got {buckets}")
        self.buckets = tuple(b)
        self._lock = threading.Lock()
        # counts[i] = observations in (buckets[i-1], buckets[i]];
        # counts[-1] = observations above the last finite bucket
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        # bucket index -> (value, trace_id, wall_ts); last writer wins
        self._exemplars: dict[int, tuple[float, str, float]] = {}

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        """Record ``v``. ``exemplar`` (a trace_id) attaches an OpenMetrics
        exemplar to the bucket the observation lands in — last writer
        wins per bucket — linking e.g. a p99 TTFT bucket straight to the
        distributed trace that produced it (``render_openmetrics``).
        Without an exemplar the hot path is unchanged."""
        v = float(v)
        i = 0
        for i, edge in enumerate(self.buckets):  # noqa: B007
            if v <= edge:
                break
        else:
            i = len(self.buckets)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if exemplar:
                self._exemplars[i] = (v, str(exemplar), time.time())

    def snapshot(self) -> dict:
        """``{"buckets": [(le, cumulative_count)...], "sum": s, "count": n,
        "exemplars": [...]}`` with the implicit +Inf bucket last;
        ``exemplars`` aligns with ``buckets`` — ``(value, trace_id,
        wall_ts)`` or None per bucket."""
        with self._lock:
            counts = list(self._counts)
            s, n = self._sum, self._count
            ex = dict(self._exemplars)
        out, cum = [], 0
        for edge, c in zip(self.buckets, counts):
            cum += c
            out.append((edge, cum))
        out.append((math.inf, n))
        exemplars = [ex.get(i) for i in range(len(self.buckets) + 1)]
        return {"buckets": out, "sum": s, "count": n, "exemplars": exemplars}

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One registered metric name: its kind, help text, label schema and
    children (one child per distinct label-value tuple; the unlabeled
    family has a single child keyed ``()``)."""

    def __init__(self, name, kind, help_, labelnames, buckets=None):
        self.name = name
        self.kind = kind
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.buckets = buckets
        self.callback: Optional[Callable] = None
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def _make_child(self):
        if self.kind == "histogram":
            return Histogram(self.buckets or DEFAULT_LATENCY_BUCKETS)
        return _KINDS[self.kind]()

    def labels(self, **kv):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != schema "
                f"{sorted(self.labelnames)}"
            )
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def samples(self) -> list[tuple[dict, object]]:
        """``[(labels_dict, child_or_value)]``. Callback families call
        their fn at collect time; it returns a scalar (unlabeled) or an
        iterable of ``(labels_dict, value)``."""
        if self.callback is not None:
            got = self.callback()
            if isinstance(got, (int, float)):
                return [({}, float(got))]
            return [(dict(lb), float(v)) for lb, v in got]
        with self._lock:
            items = list(self._children.items())
        return [
            (dict(zip(self.labelnames, key)), child) for key, child in items
        ]


class Registry:
    """A namespace of metric families. Registration is idempotent for
    same-(name, kind) direct metrics (you get the existing family back);
    ``register_callback`` REPLACES an existing callback of the same name
    — the bridge for per-instance sources (latest instance wins)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get_or_create(self, name, kind, help_, labels, buckets=None):
        _validate_name(name)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}"
                    )
                return fam
            fam = _Family(name, kind, help_, labels, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name, help_, labels: Sequence[str] = ()):
        fam = self._get_or_create(name, "counter", help_, labels)
        return fam if fam.labelnames else fam.labels()

    def gauge(self, name, help_, labels: Sequence[str] = ()):
        fam = self._get_or_create(name, "gauge", help_, labels)
        return fam if fam.labelnames else fam.labels()

    def histogram(
        self,
        name,
        help_,
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
    ):
        fam = self._get_or_create(name, "histogram", help_, labels, buckets)
        return fam if fam.labelnames else fam.labels()

    def register_callback(
        self, name, kind, help_, fn: Callable, labels: Sequence[str] = ()
    ) -> None:
        """Pull-style metric: ``fn`` is called at collect time and returns
        a scalar, or — for labeled families — an iterable of
        ``(labels_dict, value)``. Re-registering a name replaces the
        callback (per-instance bridges re-bind on instance churn)."""
        if kind not in ("counter", "gauge"):
            raise ValueError(f"callback metrics must be counter/gauge, not {kind}")
        _validate_name(name)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None and fam.callback is None:
                raise ValueError(
                    f"metric {name!r} already registered as a direct metric"
                )
            fam = _Family(name, kind, help_, labels)
            fam.callback = fn
            self._families[name] = fam

    def unregister(self, name: str) -> None:
        with self._lock:
            self._families.pop(name, None)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._families)

    def families(self) -> list[_Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    # -- collection --------------------------------------------------------
    def snapshot(self) -> dict:
        """``{name: {"kind", "help", "samples": [(labels, value_or_hist)]}}``
        where histogram values are :meth:`Histogram.snapshot` dicts."""
        out = {}
        for fam in self.families():
            samples = []
            for labels, child in fam.samples():
                if isinstance(child, Histogram):
                    samples.append((labels, child.snapshot()))
                elif isinstance(child, (Counter, Gauge)):
                    samples.append((labels, child.value))
                else:
                    samples.append((labels, child))
            out[fam.name] = {
                "kind": fam.kind,
                "help": fam.help,
                "samples": samples,
            }
        return out

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        return render_snapshot(self.snapshot())

    def render_openmetrics(self) -> str:
        """OpenMetrics 1.0 text exposition — same families as
        :meth:`render` plus histogram bucket exemplars
        (``... # {trace_id="..."} value ts``), which is the one thing
        the 0.0.4 format cannot carry. Served on ``/metrics`` content
        negotiation by the serving example."""
        lines: list[str] = []
        for name, fam in sorted(self.snapshot().items()):
            kind = fam["kind"]
            # OpenMetrics: a counter family is named WITHOUT the _total
            # suffix; its sample keeps it.
            fam_name = (
                name[: -len("_total")]
                if kind == "counter" and name.endswith("_total")
                else name
            )
            lines.append(f"# TYPE {fam_name} {kind}")
            lines.append(f"# HELP {fam_name} {_escape_help(fam['help'])}")
            for labels, val in fam["samples"]:
                if kind == "histogram":
                    exemplars = val.get("exemplars") or [None] * len(
                        val["buckets"]
                    )
                    for (le, cum), ex in zip(val["buckets"], exemplars):
                        lb = dict(labels)
                        lb["le"] = _fmt(le)
                        line = f"{name}_bucket{_label_str(lb)} {cum}"
                        if ex is not None:
                            ev, tid, ts = ex
                            line += (
                                f' # {{trace_id="{_escape_label_value(tid)}"}}'
                                f" {_fmt(ev)} {_fmt(ts)}"
                            )
                        lines.append(line)
                    lines.append(
                        f"{name}_sum{_label_str(labels)} {_fmt(val['sum'])}"
                    )
                    lines.append(
                        f"{name}_count{_label_str(labels)} {val['count']}"
                    )
                else:
                    lines.append(f"{name}{_label_str(labels)} {_fmt(val)}")
        lines.append("# EOF")
        return "\n".join(lines) + "\n"


def render_snapshot(snap: dict) -> str:
    """Prometheus text exposition 0.0.4 from a :meth:`Registry.snapshot`
    -shaped dict. Module-level so the fleet collector can render a
    *merged* snapshot that never lived in a Registry (obs/fleet.py)."""
    lines: list[str] = []
    for name, fam in sorted(snap.items()):
        lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for labels, val in fam["samples"]:
            if fam["kind"] == "histogram":
                for le, cum in val["buckets"]:
                    lb = dict(labels)
                    lb["le"] = _fmt(le)
                    lines.append(f"{name}_bucket{_label_str(lb)} {cum}")
                lines.append(
                    f"{name}_sum{_label_str(labels)} {_fmt(val['sum'])}"
                )
                lines.append(
                    f"{name}_count{_label_str(labels)} {val['count']}"
                )
            else:
                lines.append(f"{name}{_label_str(labels)} {_fmt(val)}")
    return "\n".join(lines) + ("\n" if lines else "")


class WindowedRate:
    """Events-per-second over a sliding ~``window_s`` window, from
    1-second buckets — the fix for ``tokens_per_sec`` being a lifetime
    average that goes stale after idle periods.

    ``add`` is the hot path (once per emitted token): one clock read, one
    modulo, one locked add. ``rate`` sums buckets stamped within the
    window and divides by the *covered* window length — ``min(window,
    elapsed since the first add)`` — so a cold start no longer
    under-reports by dividing a partial window's count by the full
    window; it still decays to 0 within ``window_s``
    of traffic stopping (the lifetime average never does)."""

    def __init__(self, window_s: float = 10.0, clock=time.monotonic):
        self.window = max(1, int(window_s))
        self._clock = clock
        self._n = self.window + 1  # +1: current partial second
        self._counts = [0.0] * self._n
        self._stamps = [-1] * self._n
        self._first: Optional[float] = None  # clock time of the first add
        self._lock = threading.Lock()

    def add(self, n: float = 1.0) -> None:
        now = self._clock()
        t = int(now)
        i = t % self._n
        with self._lock:
            if self._first is None:
                self._first = now
            if self._stamps[i] != t:
                self._stamps[i] = t
                self._counts[i] = 0.0
            self._counts[i] += n

    def rate(self) -> float:
        now = self._clock()
        t = int(now)
        lo = t - self.window
        with self._lock:
            if self._first is None:
                return 0.0
            total = sum(
                c
                for c, s in zip(self._counts, self._stamps)
                if lo < s <= t
            )
            covered = min(float(self.window), max(1.0, now - self._first))
        return total / covered


# -- process-wide default registry ------------------------------------------
# Engines get a PRIVATE registry each (tests build many engines per
# process; private registries keep their families from colliding). The
# default registry carries process-wide sources: sync sessions,
# resilience counters, the span-trace ring.
_default_registry = Registry()


def get_registry() -> Registry:
    return _default_registry


def metrics_enabled(explicit: Optional[bool] = None) -> bool:
    """Engine metrics on/off resolution, mirroring the
    ``DEVSPACE_ENGINE_OVERLAP`` pattern: explicit constructor arg wins,
    then the ``DEVSPACE_ENGINE_METRICS`` env knob (``off``/``0``/...
    disables), default ON — this is the bench A/B escape hatch for the
    <= 2% overhead guard (bench.py)."""
    if explicit is not None:
        return bool(explicit)
    env = os.environ.get("DEVSPACE_ENGINE_METRICS", "").strip().lower()
    return env not in ("off", "0", "false", "no")
