"""The port's analyze/ against the JAX package's: the same failed pods,
restarts, logs and events in each package's fake give the same report
text; and ``analyze_gpu_slice``, the port's counterpart of the
reference's TPU slice checks, over the config's ``gpu`` block."""

from pathlib import Path

import pytest

from devspace_tpu.analyze import analyze as janalyze
from devspace_tpu.config.loader import ConfigLoader as JLoader
from devspace_tpu.kube.fake import FakeCluster as JFakeCluster
from devspace_tpu_torch.analyze.analyze import (
    analyze_events,
    analyze_gpu_slice,
    analyze_pods,
    create_report,
)
from devspace_tpu_torch.config import latest
from devspace_tpu_torch.config.loader import ConfigLoader
from devspace_tpu_torch.kube.client import NODE_RANK_ENV
from devspace_tpu_torch.kube.fake import FakeCluster
from devspace_tpu_torch.utils.fsutil import write_file


def _broken_namespace(fc):
    """Pods in bad states, restarts, logs and events, through the fake's
    fixture helpers (the same in both packages)."""
    fc.add_pod("good")
    fc.add_pod("stuck", phase="Pending")
    fc.add_pod("crashy", phase="Running")
    status = fc.pods[("default", "crashy")]["status"]
    status["containerStatuses"][0].update(ready=False, restartCount=4, state={
        "waiting": {"reason": "CrashLoopBackOff", "message": "back-off 5m0s restarting"}})
    fc.add_pod("oom", phase="Failed")
    fc.pods[("default", "oom")]["status"]["containerStatuses"][0]["state"] = {
        "terminated": {"reason": "OOMKilled", "exitCode": 137}}
    restarty = fc.add_pod("restarty")
    fc.pods[("default", restarty.name)]["status"]["containerStatuses"][0]["restartCount"] = 3
    fc.set_logs("oom", [f"line {i}" for i in range(8)])
    fc.add_event("0/3 nodes available", involved="Pod/stuck", count=4)
    fc.add_event("pulled image", type="Normal", involved="Pod/good")
    fc.add_event("Back-off restarting", reason="BackOff", involved="Pod/crashy")
    fc.add_event("OOMKilled", reason="Killing", involved="Pod/oom")
    fc.add_event("elsewhere", involved="Pod/x", namespace="other")


def test_report_text_equals_the_reference(tmp_path):
    jfc, fc = JFakeCluster(str(tmp_path / "a")), FakeCluster(str(tmp_path / "b"))
    _broken_namespace(jfc)
    _broken_namespace(fc)
    assert analyze_pods(fc, "default", wait=False) == \
        janalyze.analyze_pods(jfc, "default", wait=False)
    assert analyze_events(fc, "default") == janalyze.analyze_events(jfc, "default")
    report = create_report(fc, "default", wait=False)
    assert report == janalyze.create_report(jfc, "default", wait=False)
    for text in ("stuck", "Pending", "CrashLoopBackOff", "back-off 5m0s", "OOMKilled",
                 "exit=137", "line 7", "3 container restart", "0/3 nodes available"):
        assert text in report, text
    assert "line 2" not in report and "pulled image" not in report
    assert "elsewhere" not in report
    # with a config that has neither block, the job section stays empty
    root = str(tmp_path / "proj")
    write_file(f"{root}/.devspace/config.yaml",
               "version: tpu/v1\ndeployments:\n  - name: good\n    manifests: {paths: []}\n")
    assert create_report(fc, "default", config=ConfigLoader(root).load(interactive=False),
                         wait=False) == \
        janalyze.create_report(jfc, "default", config=JLoader(root).load(interactive=False),
                               wait=False) == report
    # a healthy namespace
    assert "No problems found" in create_report(FakeCluster(str(tmp_path / "c")), "default",
                                                wait=False)


def _config(workers=2, *extra):
    cfg = latest.new()
    cfg.gpu = latest.GPUConfig(workers=workers)
    cfg.deployments = [latest.DeploymentConfig(name=n) for n in ("app", *extra)]
    return cfg


SERVICE = {"apiVersion": "v1", "kind": "Service",
           "metadata": {"name": "app", "namespace": "default"}, "spec": {"clusterIP": "None"}}


def _job(tmp_path, workers=2, with_service=True):
    fc = FakeCluster(str(tmp_path))
    for i in range(workers):
        fc.add_pod(f"app-{i}", labels={"app": "app"}, worker_id=i,
                   env={NODE_RANK_ENV: str(i)})
    if with_service:
        fc.apply(dict(SERVICE))
    return fc


def test_gpu_job_worker_count_and_indexes(tmp_path):
    fc = FakeCluster(str(tmp_path / "a"))
    fc.add_pod("app-0", labels={"app": "app"}, worker_id=0)
    assert "GPU job app: 1/2 workers Running" in analyze_gpu_slice(fc, _config(), "default")
    # an index-less pod whose name has no ordinal either
    fc.add_pod("app-extra", labels={"app": "app"})
    text = "\n".join(analyze_gpu_slice(fc, _config(), "default"))
    assert "missing worker index(es) [1]" in text
    assert analyze_gpu_slice(_job(tmp_path / "b"), _config(), "default") == []
    fc3 = FakeCluster(str(tmp_path / "c"))
    fc3.add_pod("app-0", labels={"app": "app"}, worker_id=0)
    fc3.add_pod("app-1", labels={"app": "app"}, env={NODE_RANK_ENV: "0"})
    text = "\n".join(analyze_gpu_slice(fc3, _config(), "default"))
    assert "duplicate worker index(es) [0]" in text


def test_gpu_job_master_address_needs_the_headless_service(tmp_path):
    probs = analyze_gpu_slice(_job(tmp_path / "a", with_service=False), _config(), "default")
    assert probs == ["GPU job app: headless service 'app' missing — the torchrun master "
                     "address app-0.app cannot resolve"]
    assert analyze_gpu_slice(_job(tmp_path / "b"), _config(), "default") == []


def test_gpu_job_checks_skip_auxiliary_deployments(tmp_path):
    fc = _job(tmp_path)
    fc.add_pod("cache-0", labels={"app": "cache"})  # no NODE_RANK, no pod index
    # a StatefulSet's pods carry the pod index, but not the job's wiring
    fc.apply({"apiVersion": "apps/v1", "kind": "StatefulSet", "metadata": {"name": "db"},
              "spec": {"replicas": 3, "template": {"metadata": {"labels": {"app": "db"}},
                                                   "spec": {"containers": [{"name": "m"}]}}}})
    assert analyze_gpu_slice(fc, _config(2, "cache", "db"), "default") == []


@pytest.mark.parametrize("workers,want", [(2, 1), (1, 0)])
def test_gpu_job_reports_missing_wiring_once(tmp_path, workers, want):
    fc = FakeCluster(str(tmp_path))
    fc.add_pod("app-0", labels={"app": "app"})
    fc.add_pod("app-1", labels={"app": "app"})
    probs = analyze_gpu_slice(fc, _config(workers), "default")
    assert len(probs) == want
    assert all("no deployment's pods carry NODE_RANK" in p for p in probs)


def test_gpu_job_on_chart_gpu_pods_from_the_fake(tmp_path):
    """The pods the fake synthesizes from chart-gpu's StatefulSet carry the
    wiring the checks look for."""
    from devspace_tpu_torch.deploy.manifests import deploy_all

    fc = FakeCluster(str(tmp_path))
    cfg = _config(2)
    cfg.deployments[0].chart = latest.ChartConfig(path=str(
        Path(__file__).parent.parent / "devspace_tpu_torch" / "generator" / "templates" /
        "chart-gpu"))
    deploy_all(fc, cfg, "default")
    assert analyze_gpu_slice(fc, cfg, "default") == []
    cfg.gpu.workers = 3
    assert analyze_gpu_slice(fc, cfg, "default") == [
        "GPU job app: 2/3 workers Running",
        "GPU job app: missing worker index(es) [2] (got [0, 1])"]


def test_create_report_renders_the_gpu_job_section(tmp_path):
    fc = FakeCluster(str(tmp_path / "a"))
    fc.add_pod("app-0", labels={"app": "app"}, worker_id=0)
    fc.add_pod("broken", phase="Failed")
    fc.add_event("node pressure", involved="Pod/broken")
    report = create_report(fc, "default", config=_config(), wait=False)
    assert "Analysis of namespace 'default'" in report
    assert "--- Pods" in report and "broken" in report
    assert "--- Events" in report and "node pressure" in report
    assert "--- GPU job" in report and "1/2 workers" in report
    assert "TPU" not in report
    assert "No problems found" in create_report(_job(tmp_path / "b", workers=1), "default",
                                                config=_config(1), wait=False)
