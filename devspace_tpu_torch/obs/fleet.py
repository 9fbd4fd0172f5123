"""Fleet federation math: parse, merge and re-render telemetry from
many processes.

The per-process observability stack (metrics, traces,
events and SLOs) ends at each process's ``/metrics``; the ROADMAP's
next steps — multi-replica routing, slice-wide SPMD sessions, closed-
loop autoscaling — all need *one* view over N of them. This module is
the pure-function half of that view (obs/collector.py owns the I/O):

- :func:`parse_exposition` — Prometheus text 0.0.4 back into a
  :meth:`Registry.snapshot`-shaped dict, reconstructing histograms from
  their ``_bucket``/``_sum``/``_count`` series. Strict: a truncated or
  garbage document raises :class:`ExpositionParseError` so the
  collector can count it and quarantine the target instead of
  federating nonsense.
- :func:`merge_snapshots` — the federation step. Counters sum.
  Histograms merge *exactly*, bucket-by-bucket (every latency histogram
  in the repo shares ``DEFAULT_LATENCY_BUCKETS``, so fleet-level
  TTFT/e2e SLOs evaluate over the merged distribution with the stock
  burn-rate engine — no quantile approximation). Gauges merge per the
  aggregation hint their family declares (the last element of every
  ``*_METRIC_FAMILIES`` tuple): ``sum`` for capacity/occupancy totals,
  ``max`` for worst-state signals like ``slo_status``, ``avg`` for
  already-averaged ratios, ``last`` for take-the-newest.
- :func:`stitch_chrome_trace` — cross-process trace stitching: span
  rings collected from each worker join on ``trace_id`` into one
  Chrome-trace JSON with a process lane per worker (spans carry wall-
  clock starts, so lanes line up to clock skew).

Dependency-free like the rest of obs/: the whole Prometheus wire format
round-trip stays ~200 lines instead of a client_golang port.

The port's copy of ``devspace_tpu/obs/fleet.py``, with the same behaviour; it
imports nothing of the JAX package. The aggregation hints come from the port's own
catalogs, sync's included; the JAX package's span-ring families, which
the port does not have, merge under the default hint.
"""

from __future__ import annotations

import re
from typing import Iterable, Optional

from .metrics import render_snapshot  # noqa: F401  (re-exported: fleet render)

# The closed set of aggregation hints a metric family may declare.
FLEET_AGG_KINDS = ("sum", "max", "avg", "last")

# Fallback for families scraped off a target whose catalog this process
# does not know (version skew, third-party exporters). Summing is the
# Prometheus-federation default for fleet totals; merge notes name every
# family that fell back so the skew is visible, not silent.
DEFAULT_AGG = "sum"


def family_agg(fam) -> str:
    """Aggregation hint of one ``*_METRIC_FAMILIES`` entry — by
    convention the last element of the tuple."""
    hint = fam[-1]
    if hint not in FLEET_AGG_KINDS:
        raise ValueError(
            f"family {fam[0]!r} declares aggregation hint {hint!r}; "
            f"want one of {FLEET_AGG_KINDS}"
        )
    return hint


def aggregation_hints() -> dict[str, str]:
    """``{family_name: hint}`` over every catalog in the repo.

    Lazily imports each subsystem's catalog and tolerates import
    failures (the engine catalog pulls jax; a CPU-only collector box
    may not have it) — a missing catalog just means those families
    merge under :data:`DEFAULT_AGG` with a note.
    """
    hints: dict[str, str] = {}
    loaders = (
        ("devspace_tpu_torch.inference.engine", "ENGINE_METRIC_FAMILIES"),
        ("devspace_tpu_torch.obs.request_trace", "SERVING_METRIC_FAMILIES"),
        ("devspace_tpu_torch.sync.session", "SYNC_METRIC_FAMILIES"),
        ("devspace_tpu_torch.resilience.policy", "RESILIENCE_METRIC_FAMILIES"),
        ("devspace_tpu_torch.obs.tracing", "TRACING_METRIC_FAMILIES"),
        ("devspace_tpu_torch.obs.events", "EVENTS_METRIC_FAMILIES"),
        ("devspace_tpu_torch.obs.slo", "SLO_METRIC_FAMILIES"),
        ("devspace_tpu_torch.obs.collector", "COLLECTOR_METRIC_FAMILIES"),
    )
    import importlib

    for mod_name, attr in loaders:
        try:
            catalog = getattr(importlib.import_module(mod_name), attr)
        except Exception:  # noqa: BLE001 — optional catalog (e.g. no jax)
            continue
        for fam in catalog:
            hints[fam[0]] = family_agg(fam)
    return hints


class ExpositionParseError(ValueError):
    """The scraped document is not well-formed Prometheus text 0.0.4."""


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"  # metric name
    r"(\{(.*)\})?"  # optional label block
    r"\s+(\S+)"  # value
    r"(\s+\S+)?\s*$"  # optional timestamp (ignored)
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def _parse_labels(block: str) -> dict:
    labels: dict[str, str] = {}
    pos = 0
    block = block.strip()
    while pos < len(block):
        m = _LABEL_RE.match(block, pos)
        if m is None:
            raise ExpositionParseError(f"bad label block: {block!r}")
        labels[m.group(1)] = _unescape(m.group(2))
        pos = m.end()
        if pos < len(block):
            if block[pos] != ",":
                raise ExpositionParseError(f"bad label block: {block!r}")
            pos += 1
    return labels


def _parse_value(s: str) -> float:
    if s == "+Inf":
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    try:
        return float(s)
    except ValueError as e:
        raise ExpositionParseError(f"bad sample value {s!r}") from e


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def parse_exposition(text: str) -> dict:
    """Prometheus text 0.0.4 -> ``Registry.snapshot()``-shaped dict.

    Histograms are reconstructed from their ``_bucket``/``_sum``/
    ``_count`` series per label-set; a histogram missing any of the
    three, with a non-monotone cumulative sequence, or without a
    ``+Inf`` bucket raises — partial documents (a target dying mid-
    response) must quarantine the target, not corrupt the merge.
    """
    kinds: dict[str, str] = {}
    helps: dict[str, str] = {}
    # family -> labels_key -> scalar value  (non-histogram)
    scalars: dict[str, dict[tuple, tuple[dict, float]]] = {}
    # family -> labels_key -> {"buckets": {le: cum}, "sum": x, "count": n}
    hists: dict[str, dict[tuple, dict]] = {}

    def hist_family(sample_name: str) -> Optional[tuple[str, str]]:
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix):
                base = sample_name[: -len(suffix)]
                if kinds.get(base) == "histogram":
                    return base, suffix
        return None

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                kind = parts[3].split()[0] if len(parts) > 3 else ""
                if kind not in ("counter", "gauge", "histogram", "untyped",
                                "summary"):
                    raise ExpositionParseError(f"bad TYPE line: {line!r}")
                kinds[parts[2]] = kind
            elif len(parts) >= 3 and parts[1] == "HELP":
                helps[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue  # other comments are legal and ignored
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ExpositionParseError(f"bad sample line: {line!r}")
        name, _, label_block, value_s = m.group(1), m.group(2), m.group(3), m.group(4)
        labels = _parse_labels(label_block) if label_block else {}
        value = _parse_value(value_s)
        hf = hist_family(name)
        if hf is not None:
            base, suffix = hf
            le = None
            if suffix == "_bucket":
                if "le" not in labels:
                    raise ExpositionParseError(
                        f"histogram bucket without le label: {line!r}"
                    )
                le = _parse_value(labels.pop("le"))
            key = _labels_key(labels)
            h = hists.setdefault(base, {}).setdefault(
                key, {"labels": labels, "buckets": {}, "sum": None,
                      "count": None}
            )
            if suffix == "_bucket":
                h["buckets"][le] = value
            elif suffix == "_sum":
                h["sum"] = value
            else:
                h["count"] = value
            continue
        key = _labels_key(labels)
        scalars.setdefault(name, {})[key] = (labels, value)

    out: dict[str, dict] = {}
    for name, by_key in scalars.items():
        kind = kinds.get(name)
        if kind in (None, "untyped"):
            kind = "counter" if name.endswith("_total") else "gauge"
        out[name] = {
            "kind": kind,
            "help": helps.get(name, ""),
            "samples": [by_key[k] for k in sorted(by_key)],
        }
    for name, by_key in hists.items():
        samples = []
        for key in sorted(by_key):
            h = by_key[key]
            if not h["buckets"] or h["sum"] is None or h["count"] is None:
                raise ExpositionParseError(
                    f"histogram {name}{dict(key)!r} is missing bucket/sum/"
                    "count series (truncated document?)"
                )
            edges = sorted(h["buckets"])
            if edges[-1] != float("inf"):
                raise ExpositionParseError(
                    f"histogram {name} has no +Inf bucket"
                )
            cums = [h["buckets"][le] for le in edges]
            if any(b < a for a, b in zip(cums, cums[1:])):
                raise ExpositionParseError(
                    f"histogram {name} buckets are not cumulative"
                )
            if cums[-1] != h["count"]:
                raise ExpositionParseError(
                    f"histogram {name}: +Inf bucket {cums[-1]} != "
                    f"count {h['count']}"
                )
            samples.append(
                (h["labels"],
                 {"buckets": list(zip(edges, cums)),
                  "sum": h["sum"], "count": h["count"]})
            )
        out[name] = {
            "kind": "histogram",
            "help": helps.get(name, ""),
            "samples": samples,
        }
    return out


def _merge_hist(acc: dict, val: dict) -> bool:
    """Bucket-wise exact merge of one histogram sample into ``acc``;
    False (and acc untouched) when the bucket edges differ."""
    if [le for le, _ in acc["buckets"]] != [le for le, _ in val["buckets"]]:
        return False
    acc["buckets"] = [
        (le, a + b)
        for (le, a), (_, b) in zip(acc["buckets"], val["buckets"])
    ]
    acc["sum"] += val["sum"]
    acc["count"] += val["count"]
    return True


def merge_snapshots(
    snapshots: Iterable[dict],
    hints: Optional[dict[str, str]] = None,
) -> tuple[dict, list[str]]:
    """Federate N ``Registry.snapshot()``-shaped dicts into one.

    ``snapshots`` iterate oldest-scrape-first: the ``last`` hint keeps
    the final value seen. Returns ``(merged, notes)`` where notes name
    every family that merged degraded (kind conflict, bucket-edge
    mismatch, unknown family defaulting to :data:`DEFAULT_AGG`) — the
    collector exposes them on ``/debug/fleet`` so skew is diagnosable.
    """
    hints = hints if hints is not None else aggregation_hints()
    merged: dict[str, dict] = {}
    # family -> labels_key -> list of values (for avg) / merged value
    notes: list[str] = []
    noted: set[str] = set()

    def note(msg: str) -> None:
        if msg not in noted:
            noted.add(msg)
            notes.append(msg)

    acc: dict[str, dict[tuple, list]] = {}
    for snap in snapshots:
        for name, fam in snap.items():
            kind = fam["kind"]
            cur = merged.get(name)
            if cur is None:
                merged[name] = {"kind": kind, "help": fam["help"],
                                "samples": []}
                acc[name] = {}
            elif cur["kind"] != kind:
                note(
                    f"{name}: kind conflict ({cur['kind']} vs {kind}); "
                    "dropping the divergent target's series"
                )
                continue
            agg = hints.get(name)
            if agg is None and kind == "gauge":
                note(f"{name}: no declared aggregation hint; using "
                     f"{DEFAULT_AGG}")
                agg = DEFAULT_AGG
            for labels, val in fam["samples"]:
                key = _labels_key(labels)
                slot = acc[name].get(key)
                if slot is None:
                    if kind == "histogram":
                        val = {"buckets": list(val["buckets"]),
                               "sum": val["sum"], "count": val["count"]}
                        acc[name][key] = [labels, val]
                    else:
                        acc[name][key] = [labels, [float(val)]]
                    continue
                if kind == "histogram":
                    if not _merge_hist(slot[1], val):
                        note(
                            f"{name}: bucket-edge mismatch; dropping the "
                            "divergent target's series"
                        )
                else:
                    slot[1].append(float(val))

    for name, by_key in acc.items():
        kind = merged[name]["kind"]
        agg = hints.get(name, DEFAULT_AGG)
        samples = []
        for key in sorted(by_key):
            labels, val = by_key[key]
            if kind == "histogram":
                samples.append((labels, val))
            elif kind == "counter" or agg == "sum":
                samples.append((labels, sum(val)))
            elif agg == "max":
                samples.append((labels, max(val)))
            elif agg == "avg":
                samples.append((labels, sum(val) / len(val)))
            else:  # "last" — snapshots iterate oldest-first
                samples.append((labels, val[-1]))
        merged[name]["samples"] = samples
    return merged, notes


# -- cross-process trace stitching ------------------------------------------
def stitch_chrome_trace(
    spans_by_process: dict[str, list[dict]],
    trace_id: Optional[str] = None,
) -> dict:
    """Join span rings from N processes into one Chrome-trace JSON.

    ``spans_by_process`` maps a process label (target name/URL) to its
    span dicts (:meth:`Span.to_dict` shape — wall-clock ``start``
    seconds + ``duration_s``). Each process gets its own ``pid`` lane
    with a ``process_name`` metadata row; tracks within a process
    become named ``tid`` rows. ``trace_id`` filters to one request's
    spans across every lane — the "where did my request go" view.
    Load the result in chrome://tracing or Perfetto.
    """
    events: list[dict] = []
    for pid, process in enumerate(sorted(spans_by_process), start=1):
        spans = spans_by_process[process] or []
        if trace_id is not None:
            spans = [s for s in spans if s.get("trace_id") == trace_id]
        events.append({
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": process},
        })
        tids: dict[str, int] = {}
        for span in spans:
            track = str(span.get("track") or "spans")
            tid = tids.get(track)
            if tid is None:
                tid = tids[track] = len(tids) + 1
                events.append({
                    "ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": track},
                })
                events.append({
                    "ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_sort_index",
                    "args": {"sort_index": tid},
                })
            args = {
                "trace_id": span.get("trace_id"),
                "span_id": span.get("span_id"),
                "ok": span.get("ok", True),
            }
            if span.get("parent_span_id"):
                args["parent_span_id"] = span["parent_span_id"]
            if span.get("error"):
                args["error"] = span["error"]
            args.update(span.get("attrs") or {})
            events.append({
                "ph": "X", "pid": pid, "tid": tid,
                "name": span.get("name", "span"),
                "ts": float(span.get("start", 0.0)) * 1e6,
                "dur": max(0.0, float(span.get("duration_s", 0.0))) * 1e6,
                "cat": str(span.get("track") or "spans"),
                "args": args,
            })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "stitched": True,
            "processes": sorted(spans_by_process),
            **({"trace_id": trace_id} if trace_id else {}),
        },
    }
