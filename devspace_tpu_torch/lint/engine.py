"""Rule-engine core for the port's preflight analyzer.

The port's own copy of ``devspace_tpu/lint/engine.py``: every check is a
registered :class:`Rule` (stable id, severity, category) producing
structured :class:`Finding` objects that the reporters render as text,
machine-stable JSON, or SARIF 2.1.0.

Rule packs register themselves at import time (``rules_manifest``,
``rules_gpu``, ``rules_sharding``, ``rules_docker``, ``pysource``,
``rules_hotpath``, ``rules_concurrency``, ``rules_obs``); ``run_rules``
walks the registry in id order so output is deterministic by
construction.

Where the reference carries the config's ``tpu`` block in the context
and runs its TPU slice rules, the port carries the ``gpu`` block
(``LintContext.gpu``) and runs the GPU job rules of ``rules_gpu``
(TPU201-205, category ``gpu``). The chart entry points render through
the port's own renderer (``deploy.chart``): ``lint_chart_findings``, and
``render_failure`` for a chart that does not render (DS100).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES = (ERROR, WARNING, INFO)


@dataclass
class Finding:
    """One diagnostic: what rule fired, how bad, where."""

    rule_id: str
    severity: str
    category: str
    message: str
    location: str = ""  # logical location, e.g. "StatefulSet/app"
    artifact: str = ""  # file / chart dir / deployment the finding is in
    line: int = 0  # 1-based source line for file-backed findings (0 = n/a)

    def legacy(self) -> str:
        """``KIND/name: message``, the form the SARIF message carries and
        the compat shims in ``deploy.lint`` return."""
        return f"{self.location}: {self.message}" if self.location else self.message

    def sort_key(self) -> tuple:
        return (self.artifact, self.location, self.rule_id, self.message, self.line)

    def to_dict(self) -> dict:
        d = {
            "rule": self.rule_id,
            "severity": self.severity,
            "category": self.category,
            "message": self.message,
            "location": self.location,
            "artifact": self.artifact,
        }
        if self.line:
            d["line"] = self.line
        return d


@dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    category: str
    description: str
    check: Callable[["LintContext"], Optional[Iterable]]


REGISTRY: dict[str, Rule] = {}


def rule(rule_id: str, *, severity: str, category: str, description: str):
    """Register a check. The decorated function takes a
    :class:`LintContext` and yields findings as ``(location, message)``
    tuples, bare message strings, or prebuilt :class:`Finding` objects; a
    rule whose inputs are absent from the context simply yields nothing."""
    if severity not in SEVERITIES:
        raise ValueError(f"{rule_id}: unknown severity {severity!r}")

    def deco(fn):
        if rule_id in REGISTRY:
            raise ValueError(f"duplicate lint rule id {rule_id}")
        REGISTRY[rule_id] = Rule(rule_id, severity, category, description, fn)
        return fn

    return deco


@dataclass
class LintContext:
    """Everything a rule may inspect. Packs read only their own fields:
    manifest/gpu rules use ``docs``+``gpu``, image rules ``dockerfiles``,
    sharding rules ``mesh_axes``/``shardings``/``donation``."""

    docs: list = field(default_factory=list)
    gpu: object = None  # config.latest.GPUConfig
    # [(path, text, gpu_flavor)] — gpu_flavor turns on the CUDA/torch checks
    dockerfiles: list = field(default_factory=list)
    mesh_axes: Optional[dict] = None  # axis name -> size (resolved, no -1)
    # name -> (shape-like | tensor, PartitionSpec)
    shardings: Optional[dict] = None
    # {"fn", "args", "kwargs", "donate_argnums"}
    donation: Optional[dict] = None
    # [(relpath, source_text)] — Python modules for the AST rule packs
    # (rules_hotpath / rules_concurrency); parsed once, cached on the
    # context by lint.pysource.parsed_sources
    python_sources: list = field(default_factory=list)
    # {catalog label: (family_tuple, ...)} — *_METRIC_FAMILIES catalogs
    # for the OBS7xx pack (rules_obs)
    metric_catalogs: Optional[dict] = None
    # [(subsystem, name, help)] — obs.events.EVENT_CATALOG entries
    event_catalog: Optional[list] = None
    # timeline lane names (obs.tracing catalog + dynamic decode lanes)
    timeline_tracks: Optional[list] = None
    artifact: str = ""  # default artifact tag for produced findings


def run_rules(
    ctx: LintContext,
    categories: Optional[set] = None,
    only: Optional[set] = None,
) -> list[Finding]:
    """Run every registered rule (optionally filtered by category/id)
    against the context. Deterministic: rules run in id order, each rule
    visits ``ctx.docs`` in document order."""
    findings: list[Finding] = []
    for rule_id in sorted(REGISTRY):
        r = REGISTRY[rule_id]
        if categories is not None and r.category not in categories:
            continue
        if only is not None and rule_id not in only:
            continue
        for item in r.check(ctx) or ():
            if isinstance(item, Finding):
                if not item.artifact:
                    item.artifact = ctx.artifact
                findings.append(item)
                continue
            if isinstance(item, tuple):
                location, message = item
            else:
                location, message = "", str(item)
            findings.append(
                Finding(
                    rule_id=r.id,
                    severity=r.severity,
                    category=r.category,
                    message=message,
                    location=location,
                    artifact=ctx.artifact,
                )
            )
    return findings


def parse_rule_filter(spec: Optional[str]) -> tuple:
    """Parse a ``--select``/``--ignore`` value: comma-separated rule ids
    or id prefixes (``JIT``, ``CON6``, ``OBS703``). Whitespace is
    tolerated; empty/None means "no filter"."""
    if not spec:
        return ()
    return tuple(
        p.strip().upper() for p in str(spec).split(",") if p.strip()
    )


def rule_selected(
    rule_id: str, select: tuple = (), ignore: tuple = ()
) -> bool:
    """Prefix-match filtering: a rule is selected when it matches some
    ``select`` prefix (or select is empty) and no ``ignore`` prefix.
    ``ignore`` wins over ``select``."""
    rid = rule_id.upper()
    if any(rid.startswith(p) for p in ignore):
        return False
    return not select or any(rid.startswith(p) for p in select)


def filter_findings(
    findings: Iterable[Finding],
    select: tuple = (),
    ignore: tuple = (),
) -> list[Finding]:
    return [f for f in findings if rule_selected(f.rule_id, select, ignore)]


def count_by_severity(findings: Iterable[Finding]) -> dict[str, int]:
    counts = {s: 0 for s in SEVERITIES}
    for f in findings:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    return counts


# Categories covered by the pre-engine deploy.lint API — the compat shims
# run exactly these, as the reference's run its manifest and tpu sets.
LEGACY_MANIFEST_CATEGORIES = frozenset({"manifest"})
LEGACY_GPU_CATEGORIES = frozenset({"gpu"})
# Everything the chart-level entry points run: the structural rules, the
# GPU job rules and the advisory hygiene rules.
CHART_CATEGORIES = frozenset({"manifest", "gpu", "hygiene"})


def render_failure(chart_path: str, error: Exception) -> Finding:
    """A chart that does not render IS the lint finding (rule DS100)."""
    return Finding(
        rule_id="DS100",
        severity=ERROR,
        category="manifest",
        message=f"render failed: {error}",
        artifact=chart_path,
    )


@rule(
    "DS100",
    severity=ERROR,
    category="manifest",
    description="Chart must render with the provided/default values",
)
def _render_ok(ctx: LintContext):
    # Render failures are synthesized by the callers that actually render
    # (lint_chart_findings / project collection) via render_failure();
    # the registration exists so DS100 appears in the rule catalog.
    return ()


def lint_docs(
    docs: list,
    gpu=None,
    artifact: str = "",
    categories: Optional[set] = CHART_CATEGORIES,
) -> list[Finding]:
    """Run the manifest-object rule packs over rendered documents; the
    GPU job rules run when ``gpu`` (a ``GPUConfig``) is given."""
    ctx = LintContext(docs=docs, gpu=gpu, artifact=artifact)
    return run_rules(ctx, categories=categories)


def lint_chart_findings(
    chart_path: str,
    release_name: str = "lint",
    namespace: str = "default",
    values: Optional[dict] = None,
    value_files: Optional[list] = None,
    gpu=None,
    extra_context: Optional[dict] = None,
) -> list[Finding]:
    """Render a chart (defaults + provided values — the same path a
    deployment renders through) and run the full manifest/gpu/hygiene
    packs. The render context's ``gpu.*`` is built from ``gpu`` unless
    ``extra_context`` has one. A render failure is returned as the single
    DS100 finding."""
    from ..deploy.chart import ChartError, gpu_context, render_chart
    from ..deploy.gotemplate import TemplateError

    try:
        docs = render_chart(
            chart_path,
            release_name=release_name,
            namespace=namespace,
            values=values,
            value_files=value_files,
            extra_context={"gpu": gpu_context(gpu), **(extra_context or {})},
        )
    except (ChartError, TemplateError, OSError) as e:
        return [render_failure(chart_path, e)]
    return lint_docs(docs, gpu=gpu, artifact=chart_path)
