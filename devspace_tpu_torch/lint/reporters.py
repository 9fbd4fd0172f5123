"""Render findings as text, machine-stable JSON, or SARIF 2.1.0.

The port's copy of ``devspace_tpu/lint/reporters.py``; the SARIF driver
names the port's tool. All three sort by :meth:`Finding.sort_key` so
output is byte-stable for a given finding set. SARIF targets the 2.1.0
schema consumed by GitHub code scanning: one run, one driver, rule
metadata from the registry, one result per finding.
"""

from __future__ import annotations

import json
from typing import Iterable

from .engine import (
    ERROR,
    INFO,
    REGISTRY,
    WARNING,
    Finding,
    count_by_severity,
)

SARIF_SCHEMA_URI = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)
SARIF_VERSION = "2.1.0"
TOOL_NAME = "devspace-tpu-torch-lint"
# SARIF result.level has no "warning"/"info" split like ours: warning maps
# to warning, info to note.
_SARIF_LEVEL = {ERROR: "error", WARNING: "warning", INFO: "note"}


def _sorted(findings: Iterable[Finding]) -> list[Finding]:
    return sorted(findings, key=Finding.sort_key)


def to_text(findings: Iterable[Finding]) -> str:
    """Human-facing report: one line per finding plus a severity summary."""
    findings = _sorted(findings)
    lines = []
    for f in findings:
        artifact = f"{f.artifact}:{f.line}" if f.artifact and f.line else f.artifact
        where = " ".join(p for p in (artifact, f.location) if p)
        prefix = f"{f.severity.upper():7s} {f.rule_id}"
        lines.append(f"{prefix}  {where + ': ' if where else ''}{f.message}")
    counts = count_by_severity(findings)
    lines.append(
        f"{counts[ERROR]} error(s), {counts[WARNING]} warning(s), "
        f"{counts[INFO]} info"
    )
    return "\n".join(lines)


def to_json(findings: Iterable[Finding]) -> str:
    """Machine-stable JSON: findings sorted, keys sorted, fixed 2-space
    indent — identical finding sets serialize identically."""
    findings = _sorted(findings)
    payload = {
        "findings": [f.to_dict() for f in findings],
        "summary": count_by_severity(findings),
    }
    return json.dumps(payload, indent=2, sort_keys=True)


def to_sarif(findings: Iterable[Finding]) -> dict:
    """SARIF 2.1.0 log as a dict (see :func:`to_sarif_json` for the
    serialized form)."""
    from .. import __version__

    findings = _sorted(findings)
    rule_ids = sorted({f.rule_id for f in findings})
    rule_index = {rid: i for i, rid in enumerate(rule_ids)}
    rules = []
    for rid in rule_ids:
        reg = REGISTRY.get(rid)
        rules.append(
            {
                "id": rid,
                "shortDescription": {
                    "text": reg.description if reg else rid,
                },
                "defaultConfiguration": {
                    "level": _SARIF_LEVEL.get(
                        reg.severity if reg else ERROR, "error"
                    ),
                },
            }
        )
    results = []
    for f in findings:
        result = {
            "ruleId": f.rule_id,
            "ruleIndex": rule_index[f.rule_id],
            "level": _SARIF_LEVEL[f.severity],
            "message": {"text": f.legacy()},
        }
        location: dict = {}
        if f.artifact:
            physical: dict = {"artifactLocation": {"uri": f.artifact}}
            if f.line:
                physical["region"] = {"startLine": f.line}
            location["physicalLocation"] = physical
        if f.location:
            location["logicalLocations"] = [{"name": f.location}]
        if location:
            result["locations"] = [location]
        results.append(result)
    return {
        "$schema": SARIF_SCHEMA_URI,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": TOOL_NAME,
                        "informationUri": (
                            "https://github.com/devspace-tpu/devspace-tpu"
                        ),
                        "version": __version__,
                        "rules": rules,
                    }
                },
                "results": results,
            }
        ],
    }


def to_sarif_json(findings: Iterable[Finding]) -> str:
    return json.dumps(to_sarif(findings), indent=2, sort_keys=True)


FORMATS = ("text", "json", "sarif")


def render(findings: Iterable[Finding], fmt: str) -> str:
    """Dispatch for a ``--format`` flag."""
    if fmt == "text":
        return to_text(findings)
    if fmt == "json":
        return to_json(findings)
    if fmt == "sarif":
        return to_sarif_json(findings)
    raise ValueError(f"unknown lint format {fmt!r} (choose from {FORMATS})")


__all__ = [
    "FORMATS",
    "SARIF_SCHEMA_URI",
    "SARIF_VERSION",
    "TOOL_NAME",
    "render",
    "to_json",
    "to_sarif",
    "to_sarif_json",
    "to_text",
]
