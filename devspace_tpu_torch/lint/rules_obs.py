"""OBS7xx: observability-catalog rules (metrics, events, timeline lanes).

The port's copy of ``devspace_tpu/lint/rules_obs.py``, over the port's
own ``obs/`` (its registry, fleet aggregation kinds, event catalog and
timeline lanes) and its catalogs.

Inputs ride on :class:`~devspace_tpu_torch.lint.engine.LintContext`:

- ``metric_catalogs``: ``{label: (family_tuple, ...)}`` — each family is
  ``(name, kind, help, *rest, agg_hint)`` as the subsystems export them.
- ``event_catalog`` / ``timeline_tracks``: opaque handles; when left
  ``None`` the rules import the live catalogs (OBS707/OBS708 delegate to
  the owning modules' own lint helpers — the catalog formats are theirs).

``load_metric_catalogs()`` builds the full production input set; rules
that receive an explicitly-empty dict do nothing, so pure-manifest lint
contexts don't import the engine.
"""

from __future__ import annotations

import re
from typing import Iterator, Optional

from .engine import ERROR, Finding, LintContext, rule

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_UNIT_SUFFIXES = ("_seconds", "_bytes")
# Gauges that are plain quantities (slots, blocks, depths, ratios, target
# counts, health bits) — names where a unit suffix would be noise.
_UNITLESS_GAUGE_SUFFIXES = (
    "_slots",
    "_blocks",
    "_requests",
    "_depth",
    "_occupancy",
    "_status",
    "_ratio",
    "_targets",
    "_targets_up",
    "_up",
    "_quarantined",
    "_replicas",
    "_tokens",
)
_RATE_RE = re.compile(r"_per_sec(_\d+s)?$")
_KINDS = ("counter", "gauge", "histogram")


def load_metric_catalogs() -> dict:
    """{catalog label: (family_tuple, ...)} for every catalog of the port —
    the production input for the OBS7xx rules. The port has no ``sync``
    catalog (the file-sync sessions are the JAX package's dev loop, not
    ported) and no ``trace`` catalog (``utils/trace.py``'s span metrics
    are the CLI's); its timeline lanes are ``obs.tracing``'s."""
    from devspace_tpu_torch.inference.engine import ENGINE_METRIC_FAMILIES
    from devspace_tpu_torch.obs.collector import COLLECTOR_METRIC_FAMILIES
    from devspace_tpu_torch.obs.events import EVENTS_METRIC_FAMILIES
    from devspace_tpu_torch.obs.request_trace import SERVING_METRIC_FAMILIES
    from devspace_tpu_torch.obs.slo import SLO_METRIC_FAMILIES
    from devspace_tpu_torch.obs.tracing import TRACING_METRIC_FAMILIES
    from devspace_tpu_torch.resilience.policy import RESILIENCE_METRIC_FAMILIES
    from devspace_tpu_torch.serving.fleet import FLEET_METRIC_FAMILIES
    from devspace_tpu_torch.serving.router import SERVING_ROUTER_METRIC_FAMILIES

    return {
        "engine": ENGINE_METRIC_FAMILIES,
        "serving": SERVING_METRIC_FAMILIES,
        "resilience": RESILIENCE_METRIC_FAMILIES,
        "tracing": TRACING_METRIC_FAMILIES,
        "events": EVENTS_METRIC_FAMILIES,
        "slo": SLO_METRIC_FAMILIES,
        "collector": COLLECTOR_METRIC_FAMILIES,
        "fleet": FLEET_METRIC_FAMILIES,
        "router": SERVING_ROUTER_METRIC_FAMILIES,
    }


def _catalogs(ctx: LintContext) -> Optional[dict]:
    """None means "not an obs lint run" (rules skip); a dict — even
    empty — means lint exactly this."""
    return ctx.metric_catalogs


def _families(ctx: LintContext) -> Iterator[tuple]:
    catalogs = _catalogs(ctx)
    if not catalogs:
        return
    for label, families in catalogs.items():
        for fam in families:
            yield label, fam


def _finding(rule_id: str, label: str, name: str, message: str) -> Finding:
    return Finding(
        rule_id=rule_id,
        severity=ERROR,
        category="obs",
        message=message,
        location=f"{label}:{name}",
    )


@rule(
    "OBS700",
    severity=ERROR,
    category="obs",
    description="Metric names must be snake_case and of a known kind "
    "(counter/gauge/histogram)",
)
def check_metric_names(ctx: LintContext):
    for label, fam in _families(ctx):
        name, kind = fam[0], fam[1]
        if not _NAME_RE.match(name):
            yield _finding("OBS700", label, name, "not snake_case")
        if kind not in _KINDS:
            yield _finding("OBS700", label, name, f"unknown kind {kind!r}")


@rule(
    "OBS701",
    severity=ERROR,
    category="obs",
    description="Counters end in _total; _total is reserved for counters",
)
def check_counter_suffix(ctx: LintContext):
    for label, fam in _families(ctx):
        name, kind = fam[0], fam[1]
        if kind == "counter" and not name.endswith("_total"):
            yield _finding(
                "OBS701", label, name, "counters must end in _total"
            )
        if kind != "counter" and name.endswith("_total"):
            yield _finding(
                "OBS701", label, name, "_total is reserved for counters"
            )


@rule(
    "OBS702",
    severity=ERROR,
    category="obs",
    description="Histograms and time/size gauges carry a unit suffix "
    "(_seconds/_bytes or a whitelisted quantity suffix)",
)
def check_unit_suffix(ctx: LintContext):
    for label, fam in _families(ctx):
        name, kind = fam[0], fam[1]
        if kind == "histogram" and not name.endswith(_UNIT_SUFFIXES):
            yield _finding(
                "OBS702",
                label,
                name,
                "histograms need a unit suffix "
                f"({'/'.join(_UNIT_SUFFIXES)})",
            )
        if kind == "gauge" and not (
            name.endswith(_UNIT_SUFFIXES)
            or name.endswith(_UNITLESS_GAUGE_SUFFIXES)
            or _RATE_RE.search(name)
        ):
            yield _finding(
                "OBS702",
                label,
                name,
                "gauge needs a unit suffix or a whitelisted quantity "
                "suffix (see devspace_tpu_torch/lint/rules_obs.py)",
            )


@rule(
    "OBS703",
    severity=ERROR,
    category="obs",
    description="Metric help strings are nonempty and don't just repeat "
    "the name",
)
def check_help_strings(ctx: LintContext):
    for label, fam in _families(ctx):
        name, help_ = fam[0], fam[2]
        if not help_ or not help_.strip():
            yield _finding("OBS703", label, name, "empty help string")
        elif help_.strip() == name:
            yield _finding(
                "OBS703", label, name, "help string just repeats the name"
            )


@rule(
    "OBS704",
    severity=ERROR,
    category="obs",
    description="Every family declares a fleet aggregation hint as its "
    "last element; counters/histograms must declare sum",
)
def check_agg_hint(ctx: LintContext):
    if not _catalogs(ctx):
        return
    from devspace_tpu_torch.obs.fleet import FLEET_AGG_KINDS

    for label, fam in _families(ctx):
        name, kind, hint = fam[0], fam[1], fam[-1]
        if hint not in FLEET_AGG_KINDS:
            yield _finding(
                "OBS704",
                label,
                name,
                f"missing/invalid aggregation hint {hint!r} as the last "
                f"tuple element (want one of {FLEET_AGG_KINDS})",
            )
        elif kind in ("counter", "histogram") and hint != "sum":
            yield _finding(
                "OBS704",
                label,
                name,
                f"{kind}s merge exactly across the fleet — the hint must "
                f'be "sum", not {hint!r}',
            )


@rule(
    "OBS705",
    severity=ERROR,
    category="obs",
    description="Metric names are unique across all catalogs (the "
    "/metrics endpoint concatenates registries)",
)
def check_duplicates(ctx: LintContext):
    seen: dict[str, str] = {}
    for label, fam in _families(ctx):
        name = fam[0]
        where = f"{label}:{name}"
        if name in seen:
            yield _finding(
                "OBS705",
                label,
                name,
                f"duplicate of {seen[name]} (the /metrics endpoint "
                "concatenates registries — names must be unique)",
            )
        else:
            seen[name] = where


@rule(
    "OBS706",
    severity=ERROR,
    category="obs",
    description="Every family registers into a fresh Registry and the "
    "combined set renders",
)
def check_registrable(ctx: LintContext):
    if not _catalogs(ctx):
        return
    from devspace_tpu_torch.obs.metrics import Registry

    reg = Registry()
    for label, fam in _families(ctx):
        name, kind, help_ = fam[0], fam[1], fam[2]
        try:
            if kind == "counter":
                reg.counter(name, help_)
            elif kind == "gauge":
                reg.gauge(name, help_)
            elif kind == "histogram":
                reg.histogram(name, help_)
        except Exception as e:  # noqa: BLE001 — report, don't crash
            yield _finding(
                "OBS706", label, name, f"registry rejected it: {e}"
            )
    try:
        reg.render()
    except Exception as e:  # noqa: BLE001
        yield Finding(
            rule_id="OBS706",
            severity=ERROR,
            category="obs",
            message=f"render() over all catalogs failed: {e}",
        )


@rule(
    "OBS707",
    severity=ERROR,
    category="obs",
    description="Chrome-export timeline track names are nonempty and "
    "unique (obs/tracing.py)",
)
def check_timeline_tracks(ctx: LintContext):
    if ctx.metric_catalogs is None and ctx.timeline_tracks is None:
        return
    if ctx.timeline_tracks is not None:
        problems = []
        seen: set = set()
        for n in ctx.timeline_tracks:
            if not isinstance(n, str) or not n.strip():
                problems.append(f"empty/non-string track name {n!r}")
            elif n in seen:
                problems.append(f"duplicate track name {n!r}")
            else:
                seen.add(n)
    else:
        from devspace_tpu_torch.obs import tracing

        problems = tracing.lint_tracks()
    for p in problems:
        yield Finding(
            rule_id="OBS707",
            severity=ERROR,
            category="obs",
            message=p,
            location="tracing",
        )


@rule(
    "OBS708",
    severity=ERROR,
    category="obs",
    description="Structured-event catalog: snake_case names, known "
    "subsystems, unique pairs, nonempty help (obs/events.py)",
)
def check_event_catalog(ctx: LintContext):
    if ctx.metric_catalogs is None and ctx.event_catalog is None:
        return
    if ctx.event_catalog is not None:
        # Standalone entries: mirror events.lint_catalog's contract over
        # a caller-supplied (subsystem, name, help) list.
        problems = []
        seen: set = set()
        for entry in ctx.event_catalog:
            if len(entry) != 3:
                problems.append(
                    f"catalog entry {entry!r}: want (subsystem, name, help)"
                )
                continue
            subsystem, name, help_ = entry
            if not _NAME_RE.match(name or ""):
                problems.append(f"{subsystem}.{name}: not snake_case")
            if not (help_ or "").strip():
                problems.append(f"{subsystem}.{name}: empty help")
            if (subsystem, name) in seen:
                problems.append(f"{subsystem}.{name}: duplicate")
            seen.add((subsystem, name))
    else:
        from devspace_tpu_torch.obs import events

        problems = events.lint_catalog()
    for p in problems:
        yield Finding(
            rule_id="OBS708",
            severity=ERROR,
            category="obs",
            message=p,
            location="events",
        )


def lint_obs_catalogs(catalogs: Optional[dict] = None) -> list[Finding]:
    """Run the OBS7xx family over ``catalogs`` (default: the live
    production set, plus the live event/timeline catalogs)."""
    from .engine import run_rules

    ctx = LintContext(
        metric_catalogs=(
            catalogs if catalogs is not None else load_metric_catalogs()
        )
    )
    return run_rules(ctx, categories={"obs"})


__all__ = ["lint_obs_catalogs", "load_metric_catalogs"]
