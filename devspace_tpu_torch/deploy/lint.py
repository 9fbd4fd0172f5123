"""Chart/config lint — legacy list-of-strings API.

The port's copy of ``devspace_tpu/deploy/lint.py``: compat shims over the
port's rule engine (``devspace_tpu_torch.lint``) that run the historical
rule sets and return the historical ``KIND/name: message`` strings.

Reference parity: helm's client-side checks before install
(``pkg/devspace/helm/install.go:54`` loads + requirement-checks the
chart; ``helm lint`` upstream renders with default values and
schema-checks the objects).

- ``validate_manifests`` — structural object checks (rules DS101-DS106);
- ``lint_gpu_consistency`` — the job invariants of a config's ``gpu:``
  block over its rendered chart-gpu (rules TPU201-TPU205, category
  ``gpu``), where the reference's ``lint_tpu_consistency`` checks a
  ``tpu:`` block;
- ``lint_chart`` — render (defaults + provided values, the SAME path
  deploy uses, with the ``gpu.*`` context chart-gpu sizes itself from)
  then run both layers.

New code should prefer ``devspace_tpu_torch.lint`` directly: it adds
hygiene/sharding/image rules and keeps severity and rule-id information
the string form throws away.
"""

from __future__ import annotations

from typing import Optional

from ..config import latest
from ..lint import (
    LEGACY_GPU_CATEGORIES,
    LEGACY_MANIFEST_CATEGORIES,
    LintContext,
    run_rules,
)


def validate_manifests(docs: list[dict]) -> list[str]:
    """Structural checks every rendered object must pass. Returns issue
    strings ('' prefix-tagged with KIND/name so reports read well)."""
    ctx = LintContext(docs=docs)
    return [
        f.legacy()
        for f in run_rules(ctx, categories=LEGACY_MANIFEST_CATEGORIES)
        if f.rule_id != "DS100"
    ]


def lint_gpu_consistency(
    docs: list[dict], gpu: Optional[latest.GPUConfig]
) -> list[str]:
    """Render-time job invariants (the live-pod versions of the same
    checks: analyze/analyze.py)."""
    ctx = LintContext(docs=docs, gpu=gpu)
    return [f.legacy() for f in run_rules(ctx, categories=LEGACY_GPU_CATEGORIES)]


def lint_chart(
    chart_path: str,
    release_name: str = "lint",
    namespace: str = "default",
    values: Optional[dict] = None,
    value_files: Optional[list[str]] = None,
    gpu: Optional[latest.GPUConfig] = None,
    extra_context: Optional[dict] = None,
) -> list[str]:
    """Render a chart (defaults + provided values) and run all checks.
    A render failure is itself the lint finding."""
    from .chart import ChartError, gpu_context, render_chart
    from .gotemplate import TemplateError

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
        return [f"render failed: {e}"]
    issues = validate_manifests(docs)
    issues.extend(lint_gpu_consistency(docs, gpu))
    return issues
