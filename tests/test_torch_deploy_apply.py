"""The deployers' apply half in the port against the JAX package's: on one
shared project with a chart and a manifests deployment (no ``tpu`` or
``gpu`` block), each package's ``deploy_all`` on its own fake cluster
applies the same objects, records the same release ConfigMap and reports
the same ``status()`` rows and ``release_info`` (timestamps stripped);
both behave the same after ``delete`` and ``purge_all``. Then the
reference's apply tests on the port, with chart-gpu and a ``gpu`` block
where the reference deploys chart-tpu with a ``tpu`` block."""

import copy
import os

import pytest
import yaml

from devspace_tpu.config.generated import CacheConfig as JCacheConfig
from devspace_tpu.config.loader import ConfigLoader as JLoader
from devspace_tpu.deploy import manifests as jmanifests
from devspace_tpu.kube.fake import FakeCluster as JFakeCluster
from devspace_tpu_torch.config import latest
from devspace_tpu_torch.config.generated import CacheConfig
from devspace_tpu_torch.config.loader import ConfigLoader
from devspace_tpu_torch.deploy.chart import (
    RELEASE_CONFIGMAP_PREFIX,
    ChartDeployer,
    ChartError,
)
from devspace_tpu_torch.deploy.manifests import (
    ManifestDeployer,
    create_deployer,
    deploy_all,
    purge_all,
)
from devspace_tpu_torch.kube.client import POD_INDEX_LABEL
from devspace_tpu_torch.kube.fake import FakeCluster
from devspace_tpu_torch.utils import log as logutil
from devspace_tpu_torch.utils.fsutil import write_file

GPU_CHART = os.path.join(os.path.dirname(__file__), "..", "devspace_tpu_torch", "generator",
                         "templates", "chart-gpu")

PROJECT = """\
version: tpu/v1
images:
  default: {image: gcr.io/p/web}
deployments:
  - name: web
    chart:
      path: ./chart
      values: {replicas: 2, port: 8080}
  - name: extras
    namespace: side
    manifests:
      paths: ["kube/*.yaml"]
"""
CHART_TEMPLATE = """\
apiVersion: apps/v1
kind: Deployment
metadata:
  name: ${{ release.name }}
spec:
  replicas: ${{ values.replicas }}
  template:
    metadata:
      labels:
        app: ${{ release.name }}
    spec:
      containers:
        - name: main
          image: ${{ values.image }}
          env:
            - name: MODE
              value: serve
          ports:
            - containerPort: ${{ values.port }}
---
apiVersion: v1
kind: Service
metadata:
  name: ${{ release.name }}
spec:
  selector:
    app: ${{ release.name }}
---
apiVersion: v1
kind: ConfigMap
metadata:
  name: ${{ release.name }}-settings
data:
  secrets: "${{ pullSecrets }}"
  built: ${{ images.default }}
"""
EXTRAS = [
    {"apiVersion": "apps/v1", "kind": "StatefulSet", "metadata": {"name": "cache"},
     "spec": {"replicas": 1, "template": {"metadata": {"labels": {"app": "cache"}},
                                          "spec": {"containers": [
                                              {"name": "m", "image": "gcr.io/p/web"}]}}}},
    {"apiVersion": "v1", "kind": "Secret", "metadata": {"name": "token"},
     "stringData": {"t": "x"}},
]


def _shared_project(root):
    write_file(os.path.join(root, ".devspace", "config.yaml"), PROJECT)
    write_file(os.path.join(root, "chart", "chart.yaml"), "name: web\nversion: 0.1.0\n")
    write_file(os.path.join(root, "chart", "values.yaml"), "image: nginx\nreplicas: 1\n")
    write_file(os.path.join(root, "chart", "templates", "all.yaml"), CHART_TEMPLATE)
    write_file(os.path.join(root, "kube", "extras.yaml"), yaml.safe_dump_all(EXTRAS))


def _release(obj):
    """A release ConfigMap without its deploy time."""
    obj = copy.deepcopy(obj)
    assert obj["data"].pop("deployedAt").isdigit()
    return obj


def _info(info):
    assert info["deployed_at"] is None or info["deployed_at"] > 0
    return {k: v for k, v in info.items() if k != "deployed_at"}


def _observed(fc, deployers):
    """What a test compares: the stored objects (release records without
    their times), the status rows and the release info of each deployer."""
    objects = {k: (_release(m) if k[2].startswith(RELEASE_CONFIGMAP_PREFIX) else m)
               for k, m in fc.objects.items()}
    return (objects, [d.status() for d in deployers],
            [_info(d.release_info()) for d in deployers if hasattr(d, "release_info")])


def test_deployers_apply_what_the_reference_applies(tmp_path):
    root = str(tmp_path / "proj")
    _shared_project(root)
    jcfg = JLoader(root).load(interactive=False)
    cfg = ConfigLoader(root).load(interactive=False)
    jfc, fc = JFakeCluster(str(tmp_path / "a")), FakeCluster(str(tmp_path / "b"))
    jcache, cache = JCacheConfig(), CacheConfig()
    kw = dict(image_tags={"default": "gcr.io/p/web:abc1234"},
              pull_secrets=["devspace-auth-x"], base_dir=root)
    for force, want_n in ((False, 2), (False, 1), (True, 2)):  # the chart skips unchanged
        n_want = jmanifests.deploy_all(jfc, jcfg, "default", cache=jcache, force=force, **kw)
        n_got = deploy_all(fc, cfg, "default", cache=cache, force=force, **kw)
        assert n_got == n_want == want_n
    assert cache.chart_hashes == jcache.chart_hashes
    jdeployers = [jmanifests.create_deployer(jfc, d, "default", root)
                  for d in jcfg.deployments]
    deployers = [create_deployer(fc, d, "default", root) for d in cfg.deployments]
    got, want = _observed(fc, deployers), _observed(jfc, jdeployers)
    assert got == want
    objects, rows, infos = got
    assert infos == [{"revision": 2, "manifests": 3}]
    # the chart's own default image (deploy_all injects none), the built
    # one in its context, and the manifests rewritten
    assert objects[("Deployment", "default", "web")]["spec"]["template"]["spec"][
        "containers"][0]["image"] == "nginx"
    settings = objects[("ConfigMap", "default", "web-settings")]["data"]
    assert settings["built"] == "gcr.io/p/web:abc1234"
    assert "devspace-auth-x" in str(settings["secrets"])
    assert objects[("StatefulSet", "side", "cache")]["spec"]["template"]["spec"][
        "containers"][0]["image"] == "gcr.io/p/web:abc1234"
    assert [r["rollout"] for r in rows[0]] == ["Deployed"] * 3
    # the same pods, but for the port's pod index (on the web Deployment's
    # two replicas, where the reference stamps TPU_WORKER_ID, and on the
    # StatefulSet's pod)
    for (ns, name), m in fc.pods.items():
        j = jfc.pods[(ns, name)]
        assert m["metadata"]["labels"] == {**j["metadata"]["labels"], POD_INDEX_LABEL: name[-1]}
        assert [e for e in j["spec"]["containers"][0]["env"]
                if e["name"] != "TPU_WORKER_ID"] == m["spec"]["containers"][0]["env"]
    assert sorted(fc.pods) == sorted(jfc.pods)
    # delete one, then purge the rest
    deployers[1].delete()
    jdeployers[1].delete()
    assert _observed(fc, deployers) == _observed(jfc, jdeployers)
    purge_all(fc, cfg, "default", base_dir=root)
    jmanifests.purge_all(jfc, jcfg, "default", base_dir=root)
    assert _observed(fc, deployers) == _observed(jfc, jdeployers)
    assert fc.objects == {} and fc.pods == {}
    assert [r["rollout"] for r in deployers[0].status()] == []
    assert deployers[0].release_info() == {"revision": 0, "deployed_at": None, "manifests": 0}


def _gpu_deployment():
    return latest.DeploymentConfig(
        name="trainer", chart=latest.ChartConfig(path=GPU_CHART, values={"args": ["train.py"]}))


def test_chart_deploy_delete_status(tmp_path):
    fc = FakeCluster(str(tmp_path))
    gpu = latest.GPUConfig(workers=2, per_worker=8)
    dep = ChartDeployer(fc, _gpu_deployment(), "default")
    cache = CacheConfig()
    assert dep.deploy(gpu=gpu, cache=cache) is True
    workers = fc.slice_workers({"app": "trainer"}, expected=2, timeout=5)
    assert [p.worker_id for p in workers] == [0, 1]
    assert [p.container_env()["NODE_RANK"] for p in workers] == ["0", "1"]
    assert dep.deploy(gpu=gpu, cache=cache) is False  # unchanged: skipped
    dep.deployment.chart.values["args"] = ["serve.py"]
    assert dep.deploy(gpu=gpu, cache=cache) is True
    status = dep.status()
    assert all(s["found"] for s in status) and len(status) >= 2
    dep.delete()
    assert fc.list_pods(label_selector={"app": "trainer"}) == []
    assert dep.status() == []


def test_manifest_deploy_with_image_rewrite(tmp_path):
    fc = FakeCluster(str(tmp_path / "c"))
    write_file(str(tmp_path / "kube" / "app.yaml"), yaml.safe_dump(
        {"apiVersion": "apps/v1", "kind": "Deployment", "metadata": {"name": "web"},
         "spec": {"replicas": 1, "template": {"metadata": {"labels": {"app": "web"}},
                                              "spec": {"containers": [
                                                  {"name": "m", "image": "gcr.io/p/web"}]}}}}))
    d = latest.DeploymentConfig(name="web",
                                manifests=latest.ManifestsConfig(paths=["kube/*.yaml"]))
    dep = ManifestDeployer(fc, d, "default", base_dir=str(tmp_path))
    dep.deploy(image_tags={"web": "gcr.io/p/web:tag123"})
    obj = fc.get_object("apps/v1", "Deployment", "web", "default")
    assert obj["spec"]["template"]["spec"]["containers"][0]["image"] == "gcr.io/p/web:tag123"
    assert dep.status() == [{"kind": "Deployment", "name": "web", "namespace": "default",
                             "found": True}]
    dep.delete()
    assert fc.get_object("apps/v1", "Deployment", "web", "default") is None


def test_deploy_all_and_purge_hand_the_chart_the_gpu_block(tmp_path):
    fc = FakeCluster(str(tmp_path))
    cfg = latest.Config(version=latest.VERSION, gpu=latest.GPUConfig(workers=3),
                        deployments=[_gpu_deployment()])
    n = deploy_all(fc, cfg, "default", image_tags={"default": "gcr.io/p/trainer:xyz"})
    assert n == 1
    assert len(fc.slice_workers({"app": "trainer"}, expected=3, timeout=5)) == 3
    sts = fc.get_object("apps/v1", "StatefulSet", "trainer")
    assert sts["spec"]["replicas"] == 3 and "--nnodes=3" in \
        sts["spec"]["template"]["spec"]["containers"][0]["command"]
    purge_all(fc, cfg, "default")
    assert fc.list_pods(label_selector={"app": "trainer"}) == [] and fc.objects == {}


def _simple_chart(tmp_path, replicas=1):
    chart = tmp_path / "chart"
    write_file(str(chart / "chart.yaml"), "name: app\nversion: 0.1.0\n")
    write_file(str(chart / "templates" / "deploy.yaml"),
               "apiVersion: apps/v1\nkind: Deployment\nmetadata:\n  name: ${{ release.name }}\n"
               f"spec:\n  replicas: {replicas}\n  template:\n    metadata:\n"
               "      labels:\n        app: ${{ release.name }}\n    spec:\n"
               "      containers:\n        - name: main\n          image: x\n")
    return str(chart)


WORKLOAD = [{"kind": "Deployment", "apiVersion": "apps/v1", "metadata": {"name": "app"}}]


def test_chart_deploy_waits_and_analyzes_on_failure(tmp_path, capsys):
    """A wedged rollout prints the analyze report and raises; a zero wait
    neither blocks nor fails."""
    fc = FakeCluster(str(tmp_path / "cluster"))
    dep = latest.DeploymentConfig(name="app", chart=latest.ChartConfig(
        path=_simple_chart(tmp_path)))
    deployer = ChartDeployer(fc, dep, "default", logger=logutil.StdoutLogger())
    assert deployer.deploy(wait_timeout=5.0) is True
    fc.objects[("Deployment", "default", "app")]["status"]["readyReplicas"] = 0
    for (ns, name) in list(fc.pods):
        fc.set_pod_phase(name, "Pending", namespace=ns)
    with pytest.raises(ChartError, match="rollout not complete"):
        deployer._wait_ready(WORKLOAD, timeout=0.5)
    out = capsys.readouterr().out
    assert "Analysis of namespace" in out and "Pending" in out
    assert deployer.deploy(force=True, wait_timeout=0) is True


def test_wait_ready_requires_observed_generation_and_finished_scale_down(tmp_path):
    fc = FakeCluster(str(tmp_path / "cluster"))
    deployer = ChartDeployer(fc, latest.DeploymentConfig(name="app", chart=latest.ChartConfig(
        path=_simple_chart(tmp_path))), "default")
    assert deployer.deploy(wait_timeout=5.0) is True
    obj = fc.objects[("Deployment", "default", "app")]
    obj["metadata"]["generation"], obj["status"]["observedGeneration"] = 5, 4
    with pytest.raises(ChartError, match="not yet observed"):
        deployer._wait_ready(WORKLOAD, timeout=0.5)
    obj["status"]["observedGeneration"] = 5
    deployer._wait_ready(WORKLOAD, timeout=0.5)
    # scale to zero: 0/0 ready is success, and no pods are synthesized
    fc2 = FakeCluster(str(tmp_path / "zero"))
    zero = ChartDeployer(fc2, latest.DeploymentConfig(name="app", chart=latest.ChartConfig(
        path=_simple_chart(tmp_path / "z", replicas=0))), "default")
    assert zero.deploy(wait_timeout=3.0) is True
    assert fc2.list_pods(label_selector={"app": "app"}) == []
    fc2.objects[("Deployment", "default", "app")]["status"]["replicas"] = 3
    with pytest.raises(ChartError, match="still running"):
        zero._wait_ready(WORKLOAD, timeout=0.5)
    fc2.objects[("Deployment", "default", "app")]["status"]["replicas"] = 0
    zero._wait_ready(WORKLOAD, timeout=0.5)


def test_deploy_all_plumbs_wait_and_timeout(tmp_path, monkeypatch):
    fc = FakeCluster(str(tmp_path / "cluster"))
    seen = {}

    def fake_deploy(self, **kwargs):
        seen.update(kwargs)
        return True

    monkeypatch.setattr(ChartDeployer, "deploy", fake_deploy)
    cfg = latest.Config(version=latest.VERSION, gpu=latest.GPUConfig(workers=2), deployments=[
        latest.DeploymentConfig(name="app", chart=latest.ChartConfig(
            path=_simple_chart(tmp_path), wait=False, timeout=120))])
    deploy_all(fc, cfg, "default")
    assert (seen["wait"], seen["wait_timeout"], seen["gpu"]) == (False, 120.0, cfg.gpu)
    seen.clear()
    cfg.deployments[0].chart.wait = cfg.deployments[0].chart.timeout = None
    deploy_all(fc, cfg, "default")
    assert (seen["wait"], seen["wait_timeout"]) == (True, 40.0)


def test_release_revision_and_rollout_status(tmp_path):
    fc = FakeCluster(str(tmp_path))
    dep = ChartDeployer(fc, _gpu_deployment(), "default")
    cache = CacheConfig()
    assert dep.deploy(cache=cache, wait=False) is True
    info = dep.release_info()
    assert info["revision"] == 1 and info["manifests"] >= 2 and info["deployed_at"]
    dep.deployment.chart.values["args"] = ["x.py"]
    assert dep.deploy(cache=cache, wait=False) is True
    assert dep.release_info()["revision"] == 2
    st = {s["name"]: s for s in dep.status()}
    workload = next(s for s in st.values() if s["kind"] == "StatefulSet")
    assert workload["rollout"] == "Deployed"
    fc.objects[("StatefulSet", "default", "trainer")]["status"]["readyReplicas"] = 0
    assert {s["kind"]: s["rollout"] for s in dep.status()}["StatefulSet"] == \
        "Rolling (0/1 ready)"
    fc.delete_object({"apiVersion": "apps/v1", "kind": "StatefulSet",
                      "metadata": {"name": "trainer", "namespace": "default"}})
    assert {s["name"]: s for s in dep.status()}["trainer"]["rollout"] == "Missing"


def test_chart_deploy_resolves_paths_against_base_dir(tmp_path, monkeypatch):
    proj = tmp_path / "proj"
    write_file(str(proj / "chart" / "chart.yaml"), "name: app\nversion: 1.0.0\n")
    write_file(str(proj / "chart" / "templates" / "cm.yaml"),
               "apiVersion: v1\nkind: ConfigMap\nmetadata:\n  name: app-cm\n")
    fc = FakeCluster(str(tmp_path / "cluster"))
    d = latest.DeploymentConfig(name="app", chart=latest.ChartConfig(path="./chart"))
    sub = proj / "deep" / "inside"
    sub.mkdir(parents=True)
    monkeypatch.chdir(sub)
    assert create_deployer(fc, d, "default", str(proj)).deploy(wait=False) is True
    assert fc.get_object("v1", "ConfigMap", "app-cm", "default") is not None
