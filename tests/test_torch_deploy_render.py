"""The port's render path (devspace_tpu_torch/deploy/chart.py,
manifests.py) against the JAX package's: ``render_chart`` gives equal
manifests on every chart under ``examples/`` (the helm-dialect and the
packaged ``app-with-cache`` and ``stateful-app`` included) and on both
packages' ``chart-cpu``; ``chart-gpu`` renders alike through both
renderers with the same ``gpu`` context; the values derivations, the
deployers' paths, cache key and image rewrite agree; and the HPA check
refuses a multi-worker ``nvidia.com/gpu`` job."""

import glob
import os
import shutil

import pytest
import yaml

from devspace_tpu.config import latest as jlatest
from devspace_tpu.deploy import chart as jchart
from devspace_tpu.deploy import manifests as jmanifests
from devspace_tpu_torch.config import latest
from devspace_tpu_torch.deploy import chart, manifests
from devspace_tpu_torch.utils import hashutil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHARTS = sorted(glob.glob(os.path.join(REPO, "examples", "*", "chart"))
                + glob.glob(os.path.join(REPO, "examples", "*", "*", "chart")))
GPU_CHART = os.path.join(REPO, "devspace_tpu_torch", "generator", "templates", "chart-gpu")
TPU_CTX = {"accelerator": "v5litepod-16", "topology": "4x4", "workers": 4,
           "chipsPerWorker": 4, "runtimeVersion": "",
           "workerHostnames": "rel-0.rel,rel-1.rel,rel-2.rel,rel-3.rel",
           "coordinatorAddress": "rel-0.rel:8476"}


def example_values(chart_dir: str) -> list:
    """The chart values each example's config gives its chart (``[None]``
    where no config names it)."""
    out = []
    root = os.path.dirname(chart_dir)
    while root != REPO and not os.path.isdir(os.path.join(root, ".devspace")):
        root = os.path.dirname(root)
    path = os.path.join(root, ".devspace", "config.yaml")
    if os.path.isfile(path):
        with open(path) as fh:
            for d in yaml.safe_load(fh).get("deployments") or []:
                c = d.get("chart") or {}
                if c.get("path") and os.path.normpath(os.path.join(root, c["path"])) == chart_dir:
                    out.append(c.get("values"))
    return out or [None]


def render_both(path, values=None, context=None, **kw):
    ctx = {"images": {"default": "reg/app:1"}, "pullSecrets": ["s"], **(context or {})}

    def run(mod):
        try:
            return mod.render_chart(path, "rel", "ns", values=values, extra_context=ctx, **kw)
        except Exception as e:  # noqa: BLE001 — the error is compared too
            return (type(e).__name__, str(e))

    return run(chart), run(jchart)


def test_the_charts_are_the_ones_this_file_names():
    names = {os.path.relpath(p, REPO) for p in CHARTS}
    assert {"examples/app-with-cache/chart", "examples/stateful-app/chart",
            "examples/microservices/backend/chart", "examples/jax-mnist/chart"} <= names
    assert chart.is_helm_chart(os.path.join(REPO, "examples", "app-with-cache", "chart",
                                            "packages", "cache"))


@pytest.mark.parametrize("path", CHARTS + [
    os.path.join(REPO, "devspace_tpu_torch", "generator", "templates", "chart-cpu"),
    os.path.join(REPO, "devspace_tpu", "generator", "templates", "chart-cpu")],
    ids=lambda p: os.path.relpath(p, REPO))
def test_render_chart_equals_the_reference(path):
    for values in example_values(path):
        # an image where the chart has no default (app-with-cache's)
        got, want = render_both(path, {"image": "reg/app:1", **(values or {})},
                                {"tpu": TPU_CTX})
        assert isinstance(got, list) and got, got
        assert got == want


def test_packaged_and_helm_charts_render_their_subcharts():
    for name in ("stateful-app", "app-with-cache"):
        got, _ = render_both(os.path.join(REPO, "examples", name, "chart"),
                             {"image": "reg/app:1"})
        assert [d["kind"] for d in got].count("StatefulSet") == 1, name
    assert all(d["metadata"]["labels"]["devspace.tpu/release"] == "rel" for d in got)


def gpu_render(workers: int, per_worker: int, values=None):
    ctx = chart.gpu_context(latest.GPUConfig(workers=workers, per_worker=per_worker))
    return render_both(GPU_CHART, values, {"gpu": ctx})


@pytest.mark.parametrize("workers, per_worker", [(1, 1), (2, 8), (4, 1)])
def test_chart_gpu_renders_alike_with_the_same_gpu_context(workers, per_worker):
    got, want = gpu_render(workers, per_worker)
    assert got == want
    (sts,) = [d for d in got if d["kind"] == "StatefulSet"]
    (c,) = sts["spec"]["template"]["spec"]["containers"]
    assert sts["spec"]["replicas"] == workers
    assert c["command"][1:3] == [f"--nnodes={workers}", f"--nproc-per-node={per_worker}"]
    assert c["resources"]["limits"] == {"nvidia.com/gpu": per_worker}
    assert sts["spec"]["template"]["spec"]["nodeSelector"] == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}


def test_gpu_context_defaults_are_the_charts():
    assert chart.gpu_context(None) == {"workers": 1, "perWorker": 1,
                                       "product": "NVIDIA-H100-80GB-HBM3"}
    assert chart.gpu_context(latest.GPUConfig(product="NVIDIA-A100")) == {
        "workers": 1, "perWorker": 1, "product": "NVIDIA-A100"}
    with pytest.raises(chart.ChartError, match="unknown template path: gpu.workers"):
        chart.render_chart(GPU_CHART, "rel", "ns")


def test_hpa_on_a_multi_worker_gpu_job_is_refused():
    auto = {"autoscaling": {"horizontal": {"maxReplicas": 4, "averageCPU": 70}}}
    got, _ = gpu_render(1, 8, auto)
    assert [d["kind"] for d in got].count("HorizontalPodAutoscaler") == 1
    got, _ = gpu_render(2, 1, {**auto, "replicas": 1})
    assert got[0] == "ChartError" and "a 2-worker GPU job" in got[1], got
    # the roster is read from torchrun's flags alone, without a gpu context
    hpa = {"apiVersion": "autoscaling/v2", "kind": "HorizontalPodAutoscaler",
           "metadata": {"name": "h"},
           "spec": {"scaleTargetRef": {"kind": "StatefulSet", "name": "job"}}}
    job = {"kind": "StatefulSet", "metadata": {"name": "job"}, "spec": {"template": {"spec": {
        "containers": [{"name": "m", "command": ["python", "-m", "torch.distributed.run",
                                                  "--nnodes", "1:3", "a.py"],
                        "resources": {"limits": {"nvidia.com/gpu": 8}}}]}}}}
    with pytest.raises(chart.ChartError, match="3-worker GPU job"):
        chart._check_hpa_slice_conflict([job, hpa])
    job["spec"]["template"]["spec"]["containers"][0]["resources"] = {}
    chart._check_hpa_slice_conflict([job, hpa])  # no card asked for: not a GPU job


@pytest.mark.parametrize("values", [
    {"persistence": {"volumes": [{"name": "ckpt", "size": "50Gi", "storageClass": "fast"}]}},
    {"persistence": {"volumes": [{"name": "ckpt"}]}},
    {"persistence": {"volumes": "x"}},
    {"autoscaling": None},
    {"autoscaling": {"horizontal": {"maxReplicas": 3}}},
    {"autoscaling": {"horizontal": {"averageCPU": 70}}},
    {"autoscaling": {"horizontal": {"maxReplicas": "many", "averageCPU": 70}}},
    {"autoscaling": {"horizontal": {"maxReplicas": 1, "averageCPU": "hot"}}},
    {"autoscaling": {"horizontal": {"maxReplicas": 3, "averageMemory": "1Gi"}},
     "replicas": 2},
])
def test_values_derivations_equal_the_reference(values):
    got, want = render_both(os.path.join(REPO, "devspace_tpu_torch", "generator", "templates",
                                         "chart-cpu"), values)
    assert got == want


def test_value_files_and_inline_values_precedence(tmp_path):
    vf = tmp_path / "v.yaml"
    vf.write_text("port: 9000\nimage: reg/x:2\n")
    got, want = render_both(os.path.join(REPO, "examples", "quickstart", "chart"),
                            {"port": 9100}, value_files=[str(vf)])
    assert got == want and "9100" in str(got) and "reg/x:2" in str(got)


def test_chart_deployer_render_path_equals_the_reference(tmp_path):
    project = tmp_path / "p"
    shutil.copytree(GPU_CHART, project / "chart")
    (project / "values.yaml").write_text("port: 9000\n")
    dep = latest.DeploymentConfig(name="job", chart=latest.ChartConfig(
        path="chart", values={"args": ["train.py"]}, value_files=["values.yaml"]))
    jdep = jlatest.DeploymentConfig(name="job", chart=jlatest.ChartConfig(
        path="chart", values={"args": ["train.py"]}, value_files=["values.yaml"]))
    port = chart.ChartDeployer(None, dep, "ns", base_dir=str(project))
    ref = jchart.ChartDeployer(None, jdep, "ns", base_dir=str(project))
    assert (port.chart_path, port.value_files) == (ref.chart_path, ref.value_files)
    assert port.chart_hash() == ref.chart_hash()
    gpu = latest.GPUConfig(workers=2, per_worker=4)
    docs = port.render_manifests(image_tags={"default": "reg/app:7"}, gpu=gpu)
    # the reference's deployer injects tpu.*: render its chart with the same gpu context
    assert docs == jchart.render_chart(
        ref.chart_path, "job", "ns", values={"args": ["train.py"]}, value_files=ref.value_files,
        extra_context={"images": {"default": "reg/app:7"}, "pullSecrets": [],
                       "gpu": chart.gpu_context(gpu)})
    (sts,) = [d for d in docs if d["kind"] == "StatefulSet"]
    assert sts["spec"]["replicas"] == 2 and "--master-addr=job-0.job" in str(sts)
    with pytest.raises(chart.ChartError, match="needs a name"):
        chart.ChartDeployer(None, latest.DeploymentConfig(name="x"), "ns")


def test_manifest_deployer_render_path_equals_the_reference():
    root = os.path.join(REPO, "examples", "quickstart-kubectl")
    tags = {"default": "registry.local/quickstart:abc", "reg/other": "reg/other:1"}
    for paths in (["kube/*.yaml"], ["kube/deployment.yaml", "nothing/*.yaml"]):
        port = manifests.create_deployer(None, latest.DeploymentConfig(
            name="app", manifests=latest.ManifestsConfig(paths=paths)), "ns", root)
        ref = jmanifests.create_deployer(None, jlatest.DeploymentConfig(
            name="app", manifests=jlatest.ManifestsConfig(paths=paths)), "ns", root)
        assert isinstance(port, manifests.ManifestDeployer)
        assert port.render_manifests(image_tags=tags) == ref.render_manifests(image_tags=tags)
    assert isinstance(manifests.create_deployer(None, latest.DeploymentConfig(
        name="c", chart=latest.ChartConfig(path="c")), "ns"), chart.ChartDeployer)
    with pytest.raises(ValueError, match="neither chart nor manifests"):
        manifests.create_deployer(None, latest.DeploymentConfig(name="x"), "ns")
    doc = {"spec": {"containers": [{"image": "r/a"}, {"image": "r/b:2"}], "x": ["r/a"]}}
    ref_doc = yaml.safe_load(yaml.safe_dump(doc))
    manifests.rewrite_image_tags(doc, {"r/a": "r/a:9", "r/b:2": "r/b:3"})
    jmanifests.rewrite_image_tags(ref_doc, {"r/a": "r/a:9", "r/b:2": "r/b:3"})
    assert doc == ref_doc and doc["spec"]["containers"][1]["image"] == "r/b:3"


def test_directory_hash_equals_the_reference(tmp_path):
    from devspace_tpu.utils import hashutil as jhash

    shutil.copytree(GPU_CHART, tmp_path / "c")
    (tmp_path / "c" / "skip.tmp").write_text("x")
    for excludes in (None, ["*.tmp"], ["templates/", "!templates/hpa.yaml"]):
        for content in (False, True):
            assert hashutil.directory_hash(str(tmp_path / "c"), excludes, content) == \
                jhash.directory_hash(str(tmp_path / "c"), excludes, content)
    assert hashutil.directory_hash(str(tmp_path / "c" / "chart.yaml")) == \
        jhash.directory_hash(str(tmp_path / "c" / "chart.yaml"))
