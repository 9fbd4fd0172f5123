"""The port's project preflight (devspace_tpu_torch/lint/project.py) and
its GPU job rules (lint/rules_gpu.py, TPU201-205 over ``chart-gpu``):
a scaffolded torch project renders clean at 1, 2 and 4 workers with 1
and 8 cards a worker; each rule fires on its broken fixture and none on
a clean one (TPU205 on an HPA over a two-worker StatefulSet included);
a chart that does not render is DS100; the manifest findings on the
examples without a ``tpu`` block equal the JAX package's preflight's."""

import copy
import os
import types

import pytest
import yaml

import devspace_tpu_torch.lint as tlint
from devspace_tpu.config.loader import ConfigLoader as JLoader
from devspace_tpu.lint import project as jproject
from devspace_tpu_torch.config import latest
from devspace_tpu_torch.deploy.chart import gpu_context, render_chart
from devspace_tpu_torch.generator import generator as gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPU_CHART = os.path.join(gen.TEMPLATES_DIR, "chart-gpu")
CPU_CHART = os.path.join(gen.TEMPLATES_DIR, "chart-cpu")


def scaffold(root, gpu=None, values=None, files=None) -> str:
    """A torch project: train.py, the port's scaffold, a config with a
    ``gpu`` block and one chart deployment."""
    os.makedirs(root, exist_ok=True)
    for rel, text in {"train.py": "import torch\n\nprint(torch.ones(2).sum())\n",
                      **(files or {})}.items():
        with open(os.path.join(root, rel), "w") as fh:
            fh.write(text)
    gen.create_dockerfile(root, "torch")
    gen.create_chart(root, "torch")
    config = {"version": "tpu/v1", "images": {"default": {"image": "reg.local/job"}},
              "deployments": [{"name": "job", "chart": {"path": "./chart",
                                                        "values": values or {}}}]}
    if gpu is not None:
        config["gpu"] = gpu
    os.makedirs(os.path.join(root, ".devspace"), exist_ok=True)
    with open(os.path.join(root, ".devspace", "config.yaml"), "w") as fh:
        yaml.safe_dump(config, fh)
    return str(root)


@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("per_worker", [1, 8])
def test_scaffolded_project_is_clean(tmp_path, workers, per_worker):
    root = scaffold(tmp_path, {"workers": workers, "perWorker": per_worker})
    project = tlint.load_project(root)
    findings, n_objects = tlint.collect_project_findings(project)
    assert findings == [], [f.legacy() for f in findings]
    assert n_objects == 3 and not tlint.has_errors(findings)
    assert project.config.gpu == latest.GPUConfig(workers=workers, per_worker=per_worker)
    assert project.namespace == "default"


def rendered(workers: int, per_worker: int = 8, values=None) -> list:
    gpu = latest.GPUConfig(workers=workers, per_worker=per_worker)
    return render_chart(GPU_CHART, "job", "ml", values=values,
                        extra_context={"images": {}, "pullSecrets": [], "gpu": gpu_context(gpu)})


def fired(docs: list, workers=2, per_worker=8) -> set:
    gpu = latest.GPUConfig(workers=workers, per_worker=per_worker)
    return {f.rule_id for f in tlint.run_rules(tlint.LintContext(docs=docs, gpu=gpu),
                                               categories={"gpu"})}


def container(docs: list) -> dict:
    (sts,) = [d for d in docs if d["kind"] == "StatefulSet"]
    return sts["spec"]["template"]["spec"]["containers"][0]


def set_flag(docs, flag, value):
    c = container(docs)
    c["command"] = [a for a in c["command"] if not a.startswith(flag + "=")]
    if value is not None:
        c["command"].insert(1, f"{flag}={value}")
    return docs


def with_hpa(docs: list, target: str = "job") -> list:
    return docs + [{"apiVersion": "autoscaling/v2", "kind": "HorizontalPodAutoscaler",
                    "metadata": {"name": "job"},
                    "spec": {"scaleTargetRef": {"apiVersion": "apps/v1",
                                                "kind": "StatefulSet", "name": target},
                             "minReplicas": 1, "maxReplicas": 4}}]


def env_value(docs, name, entry):
    c = container(docs)
    c["env"] = [e for e in c["env"] if e["name"] != name] + ([entry] if entry else [])
    return docs


def as_deployment(docs):
    (sts,) = [d for d in docs if d["kind"] == "StatefulSet"]
    sts["kind"] = "Deployment"
    return docs


def set_gpu(docs, kind, n):
    container(docs)["resources"][kind]["nvidia.com/gpu"] = n
    return docs


def no_card(docs):
    container(docs)["resources"] = {}
    return docs


def set_replicas(docs, n):
    [d for d in docs if d["kind"] == "StatefulSet"][0]["spec"]["replicas"] = n
    return docs


BROKEN = {
    "TPU201": [
        ("nnodes", lambda d: set_flag(d, "--nnodes", 3), {}),
        ("nproc", lambda d: set_flag(d, "--nproc-per-node", 4), {}),
        ("no_nnodes", lambda d: set_flag(d, "--nnodes", None), {}),
        ("world_size_env", lambda d: env_value(d, "WORLD_SIZE",
                                               {"name": "WORLD_SIZE", "value": "8"}), {}),
        # the requests then differ from perWorker as well
        ("no_world", lambda d: d, {"per_worker": 0, "also": {"TPU204"}}),
    ],
    "TPU202": [("no_job", lambda d: render_chart(CPU_CHART, "job", "ml", extra_context={
        "images": {}, "pullSecrets": []}), {})],
    "TPU203": [
        ("replicas", lambda d: set_replicas(d, 3), {}),
        ("deployment", as_deployment, {}),
    ],
    "TPU204": [
        ("static_rank", lambda d: env_value(d, "NODE_RANK", {"name": "NODE_RANK",
                                                             "value": "0"}), {}),
        ("no_rank", lambda d: env_value(d, "NODE_RANK", None), {}),
        ("master_addr", lambda d: set_flag(d, "--master-addr", "job-1.job"), {}),
        ("no_master_addr", lambda d: set_flag(d, "--master-addr", None), {}),
        ("node_rank_flag", lambda d: set_flag(d, "--node-rank", 0), {}),
        ("limits", lambda d: set_gpu(d, "limits", 4), {}),
        ("requests", lambda d: set_gpu(d, "requests", 1), {}),
        ("rank_without_card", no_card, {}),
    ],
    "TPU205": [("hpa_on_two_workers", with_hpa, {})],
}
CASES = [(rid, name, make, opts) for rid, cases in BROKEN.items()
         for name, make, opts in cases]


@pytest.mark.parametrize("rule_id, name, make, opts", CASES,
                         ids=[f"{rid}-{name}" for rid, name, _, _ in CASES])
def test_each_rule_fires_on_its_broken_fixture(rule_id, name, make, opts):
    docs = make(copy.deepcopy(rendered(2)))
    got = fired(docs, per_worker=opts.get("per_worker", 8))
    assert got == {rule_id} | opts.get("also", set()), got


@pytest.mark.parametrize("workers, per_worker, docs", [
    (1, 1, lambda: rendered(1, 1)),
    (2, 8, lambda: rendered(2, 8)),
    (4, 1, lambda: rendered(4, 1, {"persistence": {"volumes": [{"name": "ckpt",
                                                                  "size": "1Ti"}]}})),
    # one worker may autoscale: each replica an independent server
    (1, 8, lambda: rendered(1, 8, {"autoscaling": {"horizontal": {"maxReplicas": 4,
                                                                  "averageCPU": 70}}})),
    (1, 1, lambda: with_hpa(rendered(1, 1))),
    # an HPA on another workload; a job on its FQDN master address
    (2, 8, lambda: with_hpa(rendered(2, 8), target="web")),
    (2, 8, lambda: set_flag(rendered(2, 8), "--master-addr", "job-0.job.ml.svc.cluster.local")),
], ids=["1x1", "2x8", "4x1-volumes", "1x8-hpa", "1x1-hpa-doc", "2x8-other-hpa", "2x8-fqdn"])
def test_no_rule_fires_on_a_clean_fixture(workers, per_worker, docs):
    assert fired(docs(), workers, per_worker) == set()
    # and nothing at all fires without a gpu block
    assert tlint.run_rules(tlint.LintContext(docs=docs()), categories={"gpu"}) == []


def test_lint_chart_findings_renders_through_the_port(tmp_path):
    assert tlint.lint_chart_findings(GPU_CHART, gpu=latest.GPUConfig(workers=4,
                                                                     per_worker=8)) == []
    # the chart's defaults where no block is given
    assert tlint.lint_chart_findings(GPU_CHART) == []
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "chart.yaml").write_text("name: bad\n")
    (bad / "templates").mkdir()
    (bad / "templates" / "x.yaml").write_text("kind: ConfigMap\nmetadata:\n  name: ${{ nope }}\n")
    (f,) = tlint.lint_chart_findings(str(bad))
    assert (f.rule_id, f.severity, f.artifact) == ("DS100", "error", str(bad))
    assert "unknown template path: nope" in f.message


def test_project_findings_report_render_image_and_python_faults(tmp_path):
    root = scaffold(tmp_path, {"workers": 2}, files={"bad.py": "def f(:\n"})
    with open(os.path.join(root, "Dockerfile"), "w") as fh:
        fh.write("FROM python:3.12-slim\nRUN pip install torch\nCMD [\"python\", \"a.py\"]\n")
    with open(os.path.join(root, "chart", "templates", "broken.yaml"), "w") as fh:
        fh.write("kind: ConfigMap\nmetadata:\n  name: ${{ values.nope }}\n")
    findings, n_objects = tlint.collect_project_findings(tlint.load_project(root))
    ids = sorted(f.rule_id for f in findings)
    assert ids == ["DS100", "IMG401", "PY500", "TPU202"], [f.legacy() for f in findings]
    assert n_objects == 0 and tlint.has_errors(findings)
    assert next(f for f in findings if f.rule_id == "DS100").artifact == "job"


@pytest.mark.parametrize("name", ["quickstart", "quickstart-kubectl", "stateful-app",
                                  "app-with-cache", "kaniko", "microservices"])
def test_manifest_findings_equal_the_reference_preflight(name):
    root = os.path.join(REPO, "examples", name)
    loader = JLoader(root)
    ctx = types.SimpleNamespace(loader=loader, config=loader.load(interactive=False),
                                backend=None, namespace="default", root=loader.root,
                                log=loader.log)
    want, want_n = jproject.collect_project_findings(ctx)
    got, got_n = tlint.collect_project_findings(tlint.load_project(root))

    def manifest(findings):
        return sorted((f.rule_id, f.severity, f.location, f.message, f.artifact)
                      for f in findings if f.category in ("manifest", "hygiene"))

    # app-with-cache's chart needs an image value its config does not give:
    # DS100 in both
    assert got_n == want_n
    assert manifest(got) == manifest(want)
