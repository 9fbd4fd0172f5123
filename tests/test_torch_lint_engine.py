"""The port's rule engine and reporters (devspace_tpu_torch/lint/engine.py,
reporters.py, rules_manifest.py) against the JAX package's: the same
findings render to the same text and JSON, and to SARIF that differs
only in the tool's name; the rule filters agree; the rules both packages
carry are registered alike; and the manifest rules (DS101-106, DS150)
give the same findings on the same objects."""

import copy
import json
import os

import pytest

import devspace_tpu.lint as jlint
import devspace_tpu_torch.lint as tlint
from devspace_tpu.lint import reporters as jrep
from devspace_tpu_torch.lint import reporters as trep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CON_FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")

PORT_IDS = (
    ["DS100", "DS101", "DS102", "DS103", "DS104", "DS105", "DS106", "DS150"]
    + [f"TPU20{i}" for i in range(1, 6)]
    + [f"SHD30{i}" for i in range(5)] + [f"IMG40{i}" for i in range(1, 5)]
    + ["PY500"] + [f"JIT50{i}" for i in range(5)] + [f"CON60{i}" for i in range(5)]
    + [f"OBS70{i}" for i in range(9)]
)

GOOD = {
    "apiVersion": "apps/v1", "kind": "Deployment", "metadata": {"name": "web"},
    "spec": {"selector": {"matchLabels": {"app": "web"}},
             "template": {"metadata": {"labels": {"app": "web"}},
                          "spec": {"containers": [{"name": "main", "image": "web:1.0"}]}}},
}


def bad_docs() -> list:
    """One seeded fault per manifest rule, and a clean object."""
    no_image = copy.deepcopy(GOOD)
    no_image["metadata"]["name"] = "no-image"
    no_image["spec"]["template"]["spec"]["containers"][0].pop("image")
    selector = copy.deepcopy(GOOD)
    selector["metadata"]["name"] = "selector"
    selector["spec"]["template"]["metadata"]["labels"]["app"] = "other"
    mounts = copy.deepcopy(GOOD)
    mounts["metadata"]["name"] = "mounts"
    mounts["spec"]["template"]["spec"]["containers"][0]["volumeMounts"] = [
        {"name": "data", "mountPath": "/data"}]
    floating = copy.deepcopy(GOOD)
    floating["metadata"]["name"] = "floating"
    floating["spec"]["template"]["spec"]["containers"][0]["image"] = "web:latest"
    return [
        GOOD, no_image, selector, mounts, floating,
        {"apiVersion": "v1", "kind": "Service", "metadata": {"name": "Bad_Name"}},
        {"kind": "ConfigMap", "metadata": {"name": "no-api"}},
        {"apiVersion": "v1", "kind": "PersistentVolumeClaim", "metadata": {"name": "pvc"},
         "spec": {"resources": {"requests": {"storage": "5 gigs"}},
                  "accessModes": ["ReadWriteSometimes"]}},
        {"apiVersion": "autoscaling/v2", "kind": "HorizontalPodAutoscaler",
         "metadata": {"name": "hpa"},
         "spec": {"scaleTargetRef": {"kind": "Deployment", "name": "missing"},
                  "minReplicas": 3, "maxReplicas": 2}},
        {"apiVersion": "apps/v1", "kind": "StatefulSet", "metadata": {"name": "sts"},
         "spec": {"serviceName": "nowhere", "template": {"spec": {"containers": [
             {"name": "main", "image": "x:1"}]}}}},
        "not a mapping",
    ]


def keys(findings) -> list:
    return sorted((f.rule_id, f.severity, f.category, f.location, f.message, f.line)
                  for f in findings)


def test_port_registers_its_rule_packs():
    assert sorted(tlint.REGISTRY) == sorted(PORT_IDS)
    # rules both packages carry read alike, save where the port's reason
    # speaks of its own devices and meshes (SHD300, 302, 304, the image
    # and JIT packs)
    for rid in PORT_IDS:
        if rid.startswith(("DS", "CON", "OBS", "PY", "SHD301", "SHD303")):
            j, t = jlint.REGISTRY[rid], tlint.REGISTRY[rid]
            assert (j.severity, j.category, j.description) == (t.severity, t.category,
                                                               t.description), rid
    with pytest.raises(ValueError, match="duplicate"):
        tlint.rule("DS101", severity="error", category="manifest", description="")(lambda c: ())
    with pytest.raises(ValueError, match="unknown severity"):
        tlint.rule("X999", severity="fatal", category="x", description="")


def test_manifest_rules_equal_the_reference():
    docs = bad_docs()
    got = tlint.lint_docs(docs, artifact="chart")
    want = jlint.lint_docs(docs, artifact="chart", categories={"manifest", "hygiene"})
    assert keys(got) == keys(want)
    assert {f.rule_id for f in got} == {"DS101", "DS102", "DS103", "DS104", "DS105", "DS106",
                                       "DS150"}
    assert tlint.lint_docs([GOOD]) == []


def reference_and_port_findings() -> tuple[list, list]:
    """The same findings from both packages: the concurrency fixtures and
    the seeded manifests."""
    sources = []
    for name in sorted(os.listdir(CON_FIXTURES)):
        if name.endswith(".py"):
            with open(os.path.join(CON_FIXTURES, name)) as fh:
                text = fh.read()
            if "expect: CON" in text:
                sources.append((f"tests/fixtures/analysis/{name}", text))
    j = jlint.lint_python_sources(sources, categories={"concurrency"}) + jlint.lint_docs(
        bad_docs(), artifact="chart", categories={"manifest", "hygiene"})
    t = tlint.lint_python_sources(sources, categories={"concurrency"}) + tlint.lint_docs(
        bad_docs(), artifact="chart")
    return j, t


def test_reporters_render_alike():
    j, t = reference_and_port_findings()
    assert len(t) > 10 and keys(j) == keys(t)
    assert trep.to_text(t) == jrep.to_text(j)
    assert trep.to_json(t) == jrep.to_json(j)
    js, ts = jrep.to_sarif(j), trep.to_sarif(t)
    assert ts["runs"][0]["tool"]["driver"]["name"] == "devspace-tpu-torch-lint"
    assert js["runs"][0]["tool"]["driver"]["name"] == "devspace-tpu-lint"
    ts["runs"][0]["tool"]["driver"]["name"] = "devspace-tpu-lint"
    assert ts == js
    assert json.loads(trep.to_sarif_json(t))["version"] == "2.1.0"
    assert trep.render(t, "text") == trep.to_text(t)
    with pytest.raises(ValueError, match="unknown lint format"):
        trep.render(t, "xml")


@pytest.mark.parametrize("spec, rule_id, selected", [
    ("JIT", "JIT502", True), ("jit, con6", "CON601", True), ("OBS703", "OBS704", False),
    ("", "DS101", True), (None, "SHD304", True), ("  ,DS1 ,", "DS150", True),
])
def test_rule_filters_agree(spec, rule_id, selected):
    assert tlint.parse_rule_filter(spec) == jlint.parse_rule_filter(spec)
    sel = tlint.parse_rule_filter(spec)
    assert tlint.rule_selected(rule_id, sel) == jlint.rule_selected(rule_id, sel) == selected
    # ignore wins over select
    assert not tlint.rule_selected(rule_id, sel, ignore=(rule_id[:2],))
    f = tlint.Finding(rule_id, "error", "x", "m")
    assert tlint.filter_findings([f], sel) == ([f] if selected else [])
