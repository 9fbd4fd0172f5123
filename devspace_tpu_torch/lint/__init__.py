"""The port's preflight analyzer: a rule-engine lint subsystem.

The port's own copy and torch counterpart of ``devspace_tpu/lint/``:
rendered-manifest structure (DS1xx), static sharding checks over the
port's ``PartitionSpec`` trees (SHD3xx), Dockerfile checks for the card
(IMG4xx), the torch hot-path rules (JIT5xx, PY500), the concurrency
rules (CON6xx) and the observability catalogs (OBS7xx), as registered
rules with stable ids producing structured findings, reportable as text,
JSON, or SARIF 2.1.0. ``lint.runtime`` holds the dynamic halves:
``CompileWatch`` over graph captures, ``OrderedLock`` and
``LockOrderMonitor``.

Not ported: ``lint/project.py`` (``collect_project_findings``,
``has_errors``) renders a project's deployments through the CLI's
config and chart renderer, and ``lint/rules_tpu.py`` checks TPU slice
invariants over the CLI's ``tpu:`` config; the port has neither.
"""

from .engine import (
    CHART_CATEGORIES,
    ERROR,
    INFO,
    REGISTRY,
    SEVERITIES,
    WARNING,
    Finding,
    LintContext,
    Rule,
    count_by_severity,
    lint_docs,
    rule,
    run_rules,
)

# importing the packs registers their rules
from . import rules_manifest  # noqa: E402,F401
from . import rules_sharding  # noqa: E402,F401
from . import rules_docker  # noqa: E402,F401
from . import pysource  # noqa: E402,F401  (PY500)
from . import rules_hotpath  # noqa: E402,F401  (JIT5xx)
from . import rules_concurrency  # noqa: E402,F401  (CON6xx)
from . import rules_obs  # noqa: E402,F401  (OBS7xx)

from .engine import filter_findings, parse_rule_filter, rule_selected
from .pysource import collect_python_sources, lint_python_sources
from .rules_concurrency import extract_lock_graph
from .rules_obs import lint_obs_catalogs, load_metric_catalogs
from .rules_docker import lint_dockerfile
from .rules_sharding import (
    donation_preflight,
    mesh_axes_for_tpu,
    sharding_preflight,
    tree_shardings,
)
from . import reporters

__all__ = [
    "CHART_CATEGORIES",
    "ERROR",
    "INFO",
    "REGISTRY",
    "SEVERITIES",
    "WARNING",
    "Finding",
    "LintContext",
    "Rule",
    "collect_python_sources",
    "count_by_severity",
    "donation_preflight",
    "extract_lock_graph",
    "filter_findings",
    "lint_docs",
    "lint_dockerfile",
    "lint_obs_catalogs",
    "lint_python_sources",
    "load_metric_catalogs",
    "mesh_axes_for_tpu",
    "parse_rule_filter",
    "reporters",
    "rule",
    "rule_selected",
    "run_rules",
    "sharding_preflight",
    "tree_shardings",
]
