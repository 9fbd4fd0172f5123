"""The port's CLI (``python -m devspace_tpu_torch``) on its fake cluster:
the JAX CLI and the port's apply the same objects from one shared
project; then a torch project through ``init``, ``deploy``, ``status``,
``analyze``, ``print``, ``lint``, ``purge`` and ``reset``; the lint
preflight; and a context with no backend, which raises instead of using
the fake. ``main([...])`` runs in-process, as tests/test_cli.py drives
the JAX CLI."""

import copy
import json
import os
import shutil
import sys

import pytest
import yaml

from devspace_tpu.builder import images as jimages
from devspace_tpu.cli.main import main as jmain
from devspace_tpu.kube.fake import FakeCluster as JFakeCluster
from devspace_tpu.utils import log as jlogutil
from devspace_tpu_torch.builder import images
from devspace_tpu_torch.cli.context import CLIError, Context
from devspace_tpu_torch.cli.main import build_parser, main
from devspace_tpu_torch.config.loader import ConfigLoader
from devspace_tpu_torch.deploy.chart import RELEASE_CONFIGMAP_PREFIX, ChartDeployer
from devspace_tpu_torch.kube.client import POD_INDEX_LABEL
from devspace_tpu_torch.kube.fake import FakeCluster
from devspace_tpu_torch.utils import log as logutil
from devspace_tpu_torch.utils.fsutil import write_file

SHARED = """\
version: tpu/v1
images:
  default: {image: registry.local/web, dockerfile: Dockerfile, context: .}
deployments:
  - name: web
    chart: {path: ./chart, values: {port: 8080}}
  - name: extras
    manifests: {paths: ["kube/*.yaml"]}
"""
CHART = """\
apiVersion: apps/v1
kind: Deployment
metadata:
  name: ${{ release.name }}
spec:
  replicas: 2
  selector:
    matchLabels:
      app: ${{ release.name }}
  template:
    metadata:
      labels:
        app: ${{ release.name }}
    spec:
      containers:
        - name: main
          image: ${{ values.image }}
          ports:
            - containerPort: ${{ values.port }}
          resources:
            limits: {cpu: "1", memory: 1Gi}
---
apiVersion: v1
kind: Service
metadata:
  name: ${{ release.name }}
spec:
  selector:
    app: ${{ release.name }}
  ports:
    - port: ${{ values.port }}
"""
EXTRA = {"apiVersion": "v1", "kind": "ConfigMap", "metadata": {"name": "settings"},
         "data": {"image": "registry.local/web"}}


class _Stdout:
    """Whatever ``sys.stdout`` is when a line is written (capture swaps it
    between a fixture's set-up and the test)."""

    def write(self, text):
        sys.stdout.write(text)

    def flush(self):
        sys.stdout.flush()


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    """No kubeconfig, non-interactive answers, both packages' loggers on
    stdout, and the same 7-character tags from both packages' builds."""
    monkeypatch.setenv("DEVSPACE_NONINTERACTIVE", "1")
    monkeypatch.setenv("KUBECONFIG", str(tmp_path / "no-kubeconfig"))
    monkeypatch.delenv("DEVSPACE_FAKE_BACKEND", raising=False)
    monkeypatch.delenv("DEVSPACE_RELEASE_DIR", raising=False)
    monkeypatch.setattr(images, "random_string", lambda n=7: "t" * n)
    monkeypatch.setattr(jimages, "random_string", lambda n=7: "t" * n)
    logutil.set_logger(logutil.StdoutLogger(stream=_Stdout()))
    jlogutil.set_logger(jlogutil.StdoutLogger(stream=_Stdout()))
    return tmp_path


def _shared_project(root):
    write_file(os.path.join(root, ".devspace", "config.yaml"), SHARED)
    write_file(os.path.join(root, "Dockerfile"), "FROM python:3.12\nCMD [\"python\"]\n")
    write_file(os.path.join(root, "app.py"), "print('hi')\n")
    write_file(os.path.join(root, "chart", "chart.yaml"), "name: web\nversion: 0.1.0\n")
    write_file(os.path.join(root, "chart", "values.yaml"), "image: nginx\n")
    write_file(os.path.join(root, "chart", "templates", "all.yaml"), CHART)
    write_file(os.path.join(root, "kube", "extra.yaml"), yaml.safe_dump(EXTRA))


def _stored(fc):
    objects = copy.deepcopy(fc.objects)
    for (_, _, name), m in objects.items():
        if name.startswith(RELEASE_CONFIGMAP_PREFIX):
            m["data"].pop("deployedAt")
    return objects


def test_both_clis_apply_the_same_objects(cli_env, monkeypatch):
    applied = []
    for run, fake in ((jmain, JFakeCluster), (main, FakeCluster)):
        root, cluster = cli_env / f"proj-{len(applied)}", cli_env / f"cluster-{len(applied)}"
        _shared_project(str(root))
        monkeypatch.chdir(root)
        monkeypatch.setenv("DEVSPACE_FAKE_BACKEND", str(cluster))
        assert run(["deploy"]) == 0
        assert run(["status", "deployments"]) == 0
        fc = fake(str(cluster), persist=True)
        applied.append((_stored(fc), sorted(fc.pods)))
        assert run(["purge"]) == 0
        fc = fake(str(cluster), persist=True)
        applied.append((fc.objects, fc.pods))
    (jdeployed, jpurged), (deployed, purged) = applied[:2], applied[2:]
    assert deployed == jdeployed and purged == jpurged == ({}, {})
    objects, pods = deployed
    assert sorted(k for k, _, _ in objects) == ["ConfigMap", "ConfigMap", "Deployment", "Service"]
    assert objects[("Deployment", "default", "web")]["spec"]["template"]["spec"][
        "containers"][0]["image"] == "registry.local/web:ttttttt"
    assert pods == [("default", "web-0"), ("default", "web-1")]


@pytest.fixture
def torch_project(cli_env, monkeypatch):
    proj = cli_env / "proj"
    proj.mkdir()
    monkeypatch.chdir(proj)
    monkeypatch.setenv("DEVSPACE_FAKE_BACKEND", str(cli_env / "cluster"))
    write_file(str(proj / "train.py"), "import torch\nprint('step 0')\n")
    return proj


def test_init_deploy_status_purge_reset_on_a_torch_project(torch_project, cli_env, capsys):
    proj = torch_project
    assert main(["init"]) == 0
    assert "nvidia/cuda" in (proj / "Dockerfile").read_text()
    assert "nvidia.com/gpu" in (proj / "chart" / "templates" / "statefulset.yaml").read_text()
    cfg = ConfigLoader(str(proj)).load(interactive=False)
    assert (cfg.gpu.workers, cfg.gpu.per_worker) == (2, 8)
    assert main(["init"]) == 1  # refuses without --reconfigure
    assert main(["deploy"]) == 0
    fc = FakeCluster(str(cli_env / "cluster"), persist=True)
    workers = fc.slice_workers({"app": "proj"}, expected=2, timeout=5)
    assert [p.container_env()["NODE_RANK"] for p in workers] == ["0", "1"]
    assert [p.labels[POD_INDEX_LABEL] for p in workers] == ["0", "1"]
    sts = fc.get_object("apps/v1", "StatefulSet", "proj")
    (container,) = sts["spec"]["template"]["spec"]["containers"]
    assert container["image"] == "registry.local/proj:ttttttt"
    capsys.readouterr()
    assert main(["status", "deployments"]) == 0
    rows = capsys.readouterr().out.splitlines()
    assert any(r.split()[:1] == ["proj"] and "StatefulSet" in r and "Deployed" in r
               for r in rows), rows
    assert main(["analyze", "--no-wait"]) == 0
    assert "No problems found" in capsys.readouterr().out
    assert main(["status", "trace"]) == 0
    spans = capsys.readouterr().out
    assert all(name in spans for name in ("pipeline", "registries", "build", "deploy"))
    assert main(["status", "trace", "--export", str(cli_env / "trace.json")]) == 0
    assert (cli_env / "trace.json").exists()
    assert (proj / ".devspace" / "logs" / "default.log").stat().st_size > 0
    # a second deploy keeps the tag and skips the unchanged chart
    assert main(["deploy"]) == 0
    assert FakeCluster(str(cli_env / "cluster"), persist=True).get_object(
        "v1", "ConfigMap", RELEASE_CONFIGMAP_PREFIX + "proj")["data"]["revision"] == "1"
    assert main(["deploy", "--force-deploy"]) == 0
    assert main(["purge"]) == 0
    after = FakeCluster(str(cli_env / "cluster"), persist=True)
    assert after.objects == {} and after.pods == {}
    assert main(["reset", "--all"]) == 0
    assert not (proj / ".devspace").exists() and not (proj / "chart").exists()
    assert not (proj / "Dockerfile").exists() and (proj / "train.py").exists()


def _docs(text):
    return [d for d in yaml.safe_load_all(text) if d]


def test_print_manifests_is_what_render_manifests_gives(torch_project, cli_env, capsys):
    assert main(["init"]) == 0
    capsys.readouterr()
    assert main(["print", "--manifests"]) == 0
    printed = _docs(capsys.readouterr().out)
    cfg = ConfigLoader(str(torch_project)).load(interactive=False)
    (d,) = cfg.deployments
    d.chart.values = {**(d.chart.values or {}), "image": "registry.local/proj:dev"}
    want = ChartDeployer(None, d, "default", base_dir=str(torch_project)).render_manifests(
        image_tags={"default": "registry.local/proj:dev"}, gpu=cfg.gpu)
    assert printed == want and [x["kind"] for x in printed] == \
        ["PodDisruptionBudget", "Service", "StatefulSet"]
    # nothing was applied, and after a deploy it prints what was applied
    assert not (cli_env / "cluster").exists()
    assert main(["deploy"]) == 0
    capsys.readouterr()
    assert main(["print", "--manifests"]) == 0
    printed = _docs(capsys.readouterr().out)
    fc = FakeCluster(str(cli_env / "cluster"), persist=True)
    for doc in printed:
        stored = copy.deepcopy(fc.get_object(doc["apiVersion"], doc["kind"],
                                             doc["metadata"]["name"]))
        stored.pop("status", None)
        stored["metadata"].pop("generation", None)
        assert stored == doc
    assert main(["print"]) == 0
    assert yaml.safe_load(capsys.readouterr().out)["gpu"]["workers"] == 2


def _break_world_size(proj):
    path = proj / "chart" / "templates" / "statefulset.yaml"
    path.write_text(path.read_text().replace("--nnodes=${{ gpu.workers }}", "--nnodes=1"))


def test_deploy_aborts_on_a_lint_error_and_passes_with_skip_lint(torch_project, cli_env,
                                                                 capsys):
    assert main(["init"]) == 0
    assert main(["lint"]) == 0
    _break_world_size(torch_project)
    capsys.readouterr()
    assert main(["lint"]) == 1
    assert "TPU201" in capsys.readouterr().out
    assert main(["lint", "--format", "json", "--select", "TPU2"]) == 1
    report = capsys.readouterr().out  # the document alone on stdout
    assert [f["rule"] for f in json.loads(report)["findings"]] == ["TPU201"]
    assert main(["deploy"]) == 1
    cap = capsys.readouterr()  # a machine format moved the log to stderr
    out = cap.out + cap.err
    assert "[deploy] lint TPU201" in out and "--skip-lint" in out
    assert not (cli_env / "cluster").exists()  # nothing reached the cluster
    assert main(["deploy", "--skip-lint"]) == 0
    fc = FakeCluster(str(cli_env / "cluster"), persist=True)
    assert ("StatefulSet", "default", "proj") in fc.objects
    assert main(["lint", "--chart", str(torch_project / "chart")]) == 0  # default context


def test_no_backend_raises_and_never_uses_the_fake(torch_project, cli_env, monkeypatch,
                                                   capsys):
    assert main(["init"]) == 0
    monkeypatch.delenv("DEVSPACE_FAKE_BACKEND")
    args = build_parser().parse_args(["purge"])
    with pytest.raises(CLIError, match="no cluster backend"):
        Context(args).backend
    capsys.readouterr()
    assert main(["purge"]) == 1 and main(["deploy"]) == 1
    out = capsys.readouterr().out
    assert "no cluster backend" in out and "DEVSPACE_FAKE_BACKEND" in out
    assert main(["status", "deployments"]) == 1
    # a named context the kubeconfig does not have
    assert main(["--kube-context", "nope", "analyze", "--no-wait"]) == 1
    # print and lint render without a cluster
    assert main(["print", "--manifests"]) == 0 and main(["lint"]) == 0
    assert not (cli_env / "cluster").exists()


def test_no_project_and_the_parser(cli_env, monkeypatch, capsys):
    monkeypatch.chdir(cli_env)
    assert main(["deploy"]) == 1
    assert "no .devspace/ project found" in capsys.readouterr().out
    parser = build_parser()
    commands = set(parser._subparsers._group_actions[0].choices)
    assert commands == {"init", "deploy", "analyze", "purge", "reset", "status", "lint", "print"}
    with pytest.raises(SystemExit):
        parser.parse_args(["status", "sync"])  # waits for the sync engine
    with pytest.raises(SystemExit) as ei:
        main(["--version"])
    assert ei.value.code == 0


def test_module_entry_point(torch_project, cli_env):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo}
    out = subprocess.run([sys.executable, "-m", "devspace_tpu_torch", "init"],
                         cwd=torch_project, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert (torch_project / ".devspace" / "config.yaml").exists()
    shutil.rmtree(torch_project / ".devspace")
